"""The port's DAC encode (waveform -> latent -> RVQ codes) against
``vaura_tpu``'s ``Dac.encode``, same weights through
``convert.from_jax_params``, float32.

The encoder latent is held to 1e-4 absolute (the JAX package takes Snake's
``sin^2`` from a polynomial of error ~5e-7 where the port calls
``torch.sin``; the difference passes through every block). The RVQ picks the
``argmax`` of a cosine similarity per stage, and a flip at one stage changes
every later stage of that frame: codes are held exactly on the frames whose
top-two margin exceeds 1e-4 at every stage."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import CPU, J_DAC, np_tree, port_dac_config

from vaura_tpu.models.dac.model import Dac as JDac
from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.models.dac.model import Dac as TDac


@pytest.fixture(scope="module")
def codecs():
    jd = JDac(J_DAC)
    wav0 = jnp.zeros((1, 1, J_DAC.hop_length * 4))
    params = jax.jit(lambda r: jd.init(r, wav0))(jax.random.PRNGKey(0))["params"]
    tree = np_tree(params)
    rng = np.random.default_rng(0)
    for i in range(len(J_DAC.encoder_rates)):
        blk = tree["encoder"][f"block{i}"]
        blk["snake"]["alpha"] = rng.uniform(0.5, 2.0, blk["snake"]["alpha"].shape
                                            ).astype(np.float32)
        blk["down"]["conv"]["bias"] = 0.1 * rng.standard_normal(
            blk["down"]["conv"]["bias"].shape).astype(np.float32)
    tree["quantizer"]["in_proj_b"] = 0.1 * rng.standard_normal(
        tree["quantizer"]["in_proj_b"].shape).astype(np.float32)
    td = TDac(port_dac_config(), device=CPU)
    td.load_state_dict(from_jax_params({"dac": tree})["dac"])
    return jd, jax.tree_util.tree_map(jnp.asarray, tree), td


@pytest.mark.parametrize("samples", [12 * J_DAC.hop_length,
                                     12 * J_DAC.hop_length - 3])
def test_encode_matches_jax(codecs, samples):
    jd, jp, td = codecs
    wav = (0.5 * np.random.default_rng(samples).standard_normal(
        (3, 1, samples))).astype(np.float32)

    def j_latent(p, w):
        x = jnp.transpose(jd.bind({"params": p}).preprocess(w), (0, 2, 1))
        return jd.bind({"params": p}).encoder(x)

    want_z = np.asarray(jax.jit(j_latent)(jp, jnp.asarray(wav)))
    want = np.asarray(jax.jit(lambda p, w: jd.apply(
        {"params": p}, w, method=jd.encode))(jp, jnp.asarray(wav)))
    z = td.encode_latent(torch.from_numpy(wav))
    assert z.shape == (3, 12, J_DAC.resolved_latent_dim) == want_z.shape
    assert np.abs(want_z).max() > 1e-2
    np.testing.assert_allclose(z.numpy(), want_z, rtol=0, atol=1e-4)

    got = td.encode(torch.from_numpy(wav))
    codes, margins = td.quantizer.encode(z, return_margins=True)
    assert torch.equal(codes, got) and got.dtype == torch.long
    assert got.shape == (3, J_DAC.n_codebooks, 12) == want.shape
    sure = (margins > 1e-4).all(dim=1).numpy()  # [B, T] frames without a tie
    assert sure.mean() > 0.9
    same = (got.numpy() == want).all(axis=1)
    assert same[sure].all()


def test_decode_of_encode_round_trips_the_shape(codecs):
    _, _, td = codecs
    hop = J_DAC.hop_length
    wav = torch.randn(2, 1, 5 * hop - 2, generator=torch.Generator().manual_seed(0))
    assert td.preprocess(wav).shape == (2, 1, 5 * hop)
    assert torch.equal(td.preprocess(wav)[..., -2:], torch.zeros(2, 1, 2))
    codes = td.encode(wav)
    assert codes.shape == (2, J_DAC.n_codebooks, 5)
    assert int(codes.min()) >= 0 and int(codes.max()) < J_DAC.codebook_size
    out = td.decode(codes)
    assert out.shape == (2, 1, 5 * hop) and torch.isfinite(out).all()
    assert not out.requires_grad and not codes.requires_grad


def test_decode_only_state_dict_leaves_the_encoder():
    """A tree without ``encoder`` (the JAX package's ``init(method=decode)``)
    loads; a state dict that lacks anything else does not."""
    td = TDac(port_dac_config(), device=CPU)
    sd = td.state_dict()
    before = td.encoder.conv_in.weight.detach().clone()
    td.load_state_dict({k: v for k, v in sd.items()
                        if not k.startswith("encoder.")})
    assert torch.equal(td.encoder.conv_in.weight.detach(), before)
    with pytest.raises(RuntimeError):
        td.load_state_dict({k: v for k, v in sd.items()
                            if not k.startswith(("encoder.", "quantizer."))})
