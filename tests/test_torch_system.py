"""The port's whole generation path against ``vaura_tpu``'s
``VauraSystem.generate`` on the tiny float32 system of
``tests/test_system.py``: frames -> features -> codes -> waveform, greedy,
with and without classifier-free guidance.

Codes must match token for token (greedy decoding over float32 logits that
agree to ~1e-6; ``lm_head`` is filled with random values so the argmax is
not a tie). Audio within 1e-4 absolute, the DAC test's tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (
    CPU,
    init_jax_system,
    port_dac_config,
    port_encoder_config,
    port_sampler_config,
)

from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.models.vaura import VauraSystem as TSystem

MAX_NEW = 20


@pytest.fixture(scope="module")
def systems():
    jsys, tree = init_jax_system(seed=0)
    tsys = TSystem(port_sampler_config(), port_dac_config(),
                   port_encoder_config(), device=CPU)
    tsys.load_state_dicts(from_jax_params(tree))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    frames = np.random.default_rng(0).standard_normal(
        (2, 2, 3, 4, 16, 16)).astype(np.float32)
    # JAX's frames -> features once (what its generate(frames) runs first)
    vis_feats = jax.jit(jsys.visual_features)(jparams, jnp.asarray(frames))
    return jsys, jparams, tsys, frames, vis_feats


@pytest.mark.parametrize("cfg_scale", [1.0, 3.0])
def test_greedy_generation_matches_jax(systems, cfg_scale):
    jsys, jp, tsys, frames, vis_feats = systems
    want = jsys.generate(jp, None, jax.random.PRNGKey(0), vis_feats=vis_feats,
                         max_new_tokens=MAX_NEW, use_sampling=False,
                         cfg_scale=cfg_scale, decode_buckets=1,
                         decode_to_audio=False)
    want_audio = jax.jit(jsys.decode_audio)(jp, want["codes"])
    got = tsys.generate(torch.from_numpy(frames), max_new_tokens=MAX_NEW,
                        use_sampling=False, cfg_scale=cfg_scale, check=True)
    codes = got["codes"].numpy()
    assert codes.shape == (2, 3, MAX_NEW)
    np.testing.assert_array_equal(codes, np.asarray(want["codes"]))
    hop = port_dac_config().hop_length
    assert got["audio"].shape == (2, 1, MAX_NEW * hop)
    np.testing.assert_allclose(got["audio"].numpy(), np.asarray(want_audio),
                               rtol=0, atol=1e-4)
    assert set(got["stage_ms"]) == {"encoder", "decode_loop", "dac"}


def test_sampled_generation_is_valid_and_seeded(systems):
    """Sampled rollouts cannot match JAX's PRNG: check validity and that a
    seed reproduces its tokens."""
    _, _, tsys, frames, _ = systems
    kw = dict(max_new_tokens=MAX_NEW, cfg_scale=3.0, top_k=4, check=True,
              decode_to_audio=False)
    a = tsys.generate(torch.from_numpy(frames), seed=5, **kw)["codes"]
    b = tsys.generate(torch.from_numpy(frames), seed=5, **kw)["codes"]
    assert torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < port_sampler_config().d_codebook


def test_encoder_chunks_and_dac_chunks_change_nothing(systems):
    _, _, tsys, frames, _ = systems
    f = torch.from_numpy(np.concatenate([frames, frames[::-1]]))
    whole = tsys.visual_features(f)
    chunked = tsys.visual_features(f, chunk_size=3)  # largest divisor: 2
    torch.testing.assert_close(chunked, whole, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="inference"):
        tsys.visual_features(f, train=True, chunk_size=2)
    with pytest.raises(TypeError):  # the options are keyword-only
        tsys.visual_features(f, 2)
    codes = torch.randint(0, 16, (4, 3, 5), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(tsys.decode_audio(codes, chunk_size=2),
                               tsys.decode_audio(codes), rtol=0, atol=1e-5)


def test_mlp_bridge_matches_jax():
    from vaura_tpu.models.bridges import MLPBridge as JBridge
    from vaura_tpu_torch.models.bridges import MLPBridge as TBridge
    from torch_port_util import np_tree

    jb = JBridge(24, 32, 24)
    x = np.random.default_rng(3).standard_normal((2, 5, 24)).astype(np.float32)
    p = jb.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tb = TBridge(24, 32, 24, device=CPU)
    tb.load_state_dict(from_jax_params({"bridge": np_tree(p)})["bridge"])
    with torch.no_grad():
        got = tb(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jb.apply({"params": p}, x)),
                               rtol=1e-5, atol=1e-5)
