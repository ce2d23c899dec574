"""The port's DAC decode (codes -> waveform) against ``vaura_tpu``'s
``Dac.decode``, same weights carried over by ``convert.from_jax_params``.

Tolerance 1e-4 absolute on a tanh-bounded waveform: float32 on both sides,
but the JAX package takes Snake's ``sin^2`` from a polynomial (error ~5e-7,
``vaura_tpu/models/dac/layers.py:26``) and the transposed convolutions in
polyphase form, where the port uses ``torch.sin`` and
``F.conv_transpose1d``; the differences pass through every block."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import CPU, J_DAC, np_tree, port_dac_config

from vaura_tpu.models.dac.model import Dac as JDac
from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.models.dac.model import (
    Dac as TDac,
    config_for_sample_rate,
)


@pytest.mark.parametrize("rates", [(4, 2), (8, 4)])
def test_decode_matches_jax(rates):
    jcfg = dataclasses.replace(J_DAC, decoder_rates=rates,
                               encoder_rates=tuple(reversed(rates)))
    jd = JDac(jcfg)
    codes0 = jnp.zeros((1, jcfg.n_codebooks, 2), jnp.int32)
    params = jax.jit(lambda r: jd.init(r, codes0, method=jd.decode))(
        jax.random.PRNGKey(0))["params"]
    tree = np_tree(params)
    rng = np.random.default_rng(0)
    # non-trivial Snake alphas and biases (both start at 1 / 0)
    for blk in [k for k in tree["decoder"] if k.startswith("block")]:
        tree["decoder"][blk]["snake"]["alpha"] = rng.uniform(
            0.5, 2.0, tree["decoder"][blk]["snake"]["alpha"].shape
        ).astype(np.float32)
        tree["decoder"][blk]["up"]["bias"] = rng.standard_normal(
            tree["decoder"][blk]["up"]["bias"].shape).astype(np.float32) * 0.1
    codes = rng.integers(0, jcfg.codebook_size, (2, jcfg.n_codebooks, 9))
    want = np.asarray(jax.jit(
        lambda p, c: jd.apply({"params": p}, c, method=jd.decode))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(codes, jnp.int32)))

    td = TDac(port_dac_config(jcfg), device=CPU)
    td.load_state_dict(from_jax_params({"dac": tree})["dac"])
    got = td.decode(torch.from_numpy(codes)).numpy()
    assert got.shape == (2, 1, 9 * jcfg.hop_length) == want.shape
    assert np.abs(want).max() > 1e-3  # a waveform, not silence
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_flagship_codec_geometry():
    cfg = config_for_sample_rate(44100)
    assert cfg.hop_length == 512 and cfg.n_codebooks == 9
    assert cfg.resolved_latent_dim == 1024
    with pytest.raises(ValueError):
        config_for_sample_rate(22050)
