"""The port's sampler with the int8 KV cache, int8 weights and prompt
``prefill`` against ``vaura_tpu.models.sampler.Sampler`` on the tiny float32
config of ``tests/test_system.py``, the same weights on both sides
(``convert.from_jax_params``; int8 weights from JAX's
``quantize_sampler_params``).

Tolerances: logits and float caches within 2e-5 absolute/relative (float32
on both sides, sums in other orders). An int8 cache row quantizes K/V that
agree to ~1e-6, so a value on a rounding edge may land one step apart on
the two sides: int8 values within 1 (and nearly all equal), scales within
2e-5 relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (
    CPU,
    J_SAMPLER,
    np_tree,
    port_sampler_config,
    randomize_sampler_heads,
)

from vaura_tpu.models.sampler import Sampler as JSampler
from vaura_tpu.ops.quantization import quantize_sampler_params
from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.models.sampler import Sampler as TSampler

TOL = dict(rtol=2e-5, atol=2e-5)
B, S, SPLIT = 2, 12, 5
J_INT8 = dataclasses.replace(J_SAMPLER, quantize_cache=True)


@pytest.fixture(scope="module")
def tree():
    js = JSampler(J_SAMPLER)
    params = js.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0),
         "cfg_dropout": jax.random.PRNGKey(0)},
        jnp.zeros((1, 3, 16), jnp.int32), jnp.zeros((1, 8, 24)), False,
    )["params"]
    return randomize_sampler_heads(np_tree(params), 1)


def _pair(tree, jcfg):
    """``(jax sampler, jax params, port sampler)`` of ``jcfg`` over
    ``tree`` (quantized first when ``jcfg.quantize_weights``)."""
    if jcfg.quantize_weights:
        tree = quantize_sampler_params(tree)
    ts = TSampler(port_sampler_config(jcfg), device=CPU)
    ts.load_state_dict(from_jax_params({"sampler": tree})["sampler"])
    return JSampler(jcfg), jax.tree_util.tree_map(jnp.asarray, tree), ts


def _assert_int8_close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.int8 and want.dtype == np.int8
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def _assert_cache_close(tcache, jcache, n: int) -> None:
    for name in jcache:
        got, want = tcache[name][:, :, :n], np.asarray(jcache[name])[:, :, :n]
        if want.dtype == np.int8:
            _assert_int8_close(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=name)


@pytest.mark.parametrize("quantize_weights", [False, True])
def test_int8_cache_decode_steps_match_jax(tree, quantize_weights):
    """Decode steps over an int8 cache whose rows below ``SPLIT`` hold
    quantized K/V (JAX's cache in two chunks), committing each step's
    quantized K/V and scales."""
    jcfg = dataclasses.replace(J_INT8, quantize_weights=quantize_weights)
    js, jp, ts = _pair(tree, jcfg)
    cfg = jcfg
    rng = np.random.default_rng(0)
    shape = (cfg.num_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    c0 = {"k": rng.integers(-127, 128, shape).astype(np.int8),
          "v": rng.integers(-127, 128, shape).astype(np.int8),
          "k_scale": rng.uniform(0.005, 0.05, shape[:-1]).astype(np.float32),
          "v_scale": rng.uniform(0.005, 0.05, shape[:-1]).astype(np.float32)}
    jchunks = tuple({k: jnp.asarray(v[:, :, lo:hi]) for k, v in c0.items()}
                    for lo, hi in ((0, SPLIT), (SPLIT, S)))
    tcache = ts.init_cache(B, S)
    assert tcache["k"].dtype == torch.int8
    assert tcache["k_scale"].shape == shape[:-1]
    for k, v in c0.items():
        tcache[k].copy_(torch.from_numpy(v))
    for pos in range(SPLIT, SPLIT + 5):
        tok = rng.integers(0, cfg.vocab_with_special,
                           (B, cfg.num_codebooks, 1)).astype(np.int32)
        cond = rng.standard_normal((B, 1, cfg.cond_dim)).astype(np.float32)
        jl, jchunks = js.apply(
            {"params": jp}, jnp.asarray(tok), jnp.asarray(cond), jchunks,
            jnp.int32(pos), None, (0, SPLIT), method=js.decode_step)
        tl = ts.decode_step(torch.from_numpy(tok), torch.from_numpy(cond),
                            tcache, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jcache = {k: jnp.concatenate([c[k] for c in jchunks], axis=2)
              for k in c0}
    _assert_cache_close(tcache, jcache, SPLIT + 5)


def test_quantized_weights_load_as_int8_buffers(tree):
    _, _, ts = _pair(tree, dataclasses.replace(J_SAMPLER, quantize_weights=True))
    wqkv = ts.layers[0].attention.wqkv
    assert wqkv.kernel_q.dtype == torch.int8 and not hasattr(wqkv, "weight")
    assert ts.lm_head.kernel_q.shape == (3 * 16, 48)
    assert ts.cls_embeddings.fc1.weight.dtype == torch.float32


@pytest.mark.parametrize("quantize_cache", [False, True])
def test_prefill_matches_jax(tree, quantize_cache):
    """Logits and the fresh cache of a causal forward over a padded prompt
    (CFG-doubled batch, UNKNOWN slots clamped to token 0 as ``generate``
    does)."""
    jcfg = dataclasses.replace(J_SAMPLER, quantize_cache=quantize_cache)
    js, jp, ts = _pair(tree, jcfg)
    rng = np.random.default_rng(3)
    T = 30
    tok = rng.integers(0, jcfg.vocab_with_special,
                       (2 * B, jcfg.num_codebooks, T)).astype(np.int32)
    cond = rng.standard_normal((2 * B, T, jcfg.cond_dim)).astype(np.float32)
    jl, jc = js.apply({"params": jp}, jnp.asarray(tok), jnp.asarray(cond),
                      method=js.prefill)
    tl, tc = ts.prefill(torch.from_numpy(tok), torch.from_numpy(cond))
    assert tl.shape == (2 * B, jcfg.num_codebooks, T, jcfg.d_codebook)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert set(tc) == set(jc)
    _assert_cache_close(tc, jc, T)
    if not quantize_cache:
        return
    # the int8 cache of a prefill carries on through decode steps
    tok1 = rng.integers(0, 16, (2 * B, jcfg.num_codebooks, 1)).astype(np.int32)
    cond1 = rng.standard_normal((2 * B, 1, jcfg.cond_dim)).astype(np.float32)
    jl1, _ = js.apply({"params": jp}, jnp.asarray(tok1), jnp.asarray(cond1),
                      jc, jnp.int32(20), method=js.decode_step)
    tl1 = ts.decode_step(torch.from_numpy(tok1), torch.from_numpy(cond1), tc, 20)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), **TOL)


def test_decode_step_into_another_row_matches_jax_chunks(tree):
    """``row`` separates the cache row (write, attention bound) from the
    position (RoPE, conditioning): a step at position 9 into row 3 of a
    buffer whose rows 0..2 hold positions 6..8 is JAX's step at position 9
    over the chunks ``(positions 6..8, position 9)``."""
    js, jp, ts = _pair(tree, J_INT8)
    rng = np.random.default_rng(6)
    shape = (J_SAMPLER.num_layers, B, 3, J_SAMPLER.n_kv_heads,
             J_SAMPLER.head_dim)
    held = {"k": rng.integers(-127, 128, shape).astype(np.int8),
            "v": rng.integers(-127, 128, shape).astype(np.int8),
            "k_scale": rng.uniform(0.005, 0.05, shape[:-1]).astype(np.float32),
            "v_scale": rng.uniform(0.005, 0.05, shape[:-1]).astype(np.float32)}
    tok = rng.integers(0, 16, (B, 3, 1)).astype(np.int32)
    cond = rng.standard_normal((B, 1, J_SAMPLER.cond_dim)).astype(np.float32)
    jfresh = js.init_cache(B, 1)
    jl, jc = js.apply({"params": jp}, jnp.asarray(tok), jnp.asarray(cond),
                      ({k: jnp.asarray(v) for k, v in held.items()}, jfresh),
                      jnp.int32(9), None, (6, 9), method=js.decode_step)
    rolled = ts.init_cache(B, 5)
    for k, v in held.items():
        rolled[k][:, :, :3] = torch.from_numpy(v)
    tl = ts.decode_step(torch.from_numpy(tok), torch.from_numpy(cond), rolled,
                        9, row=3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close({k: t[:, :, 3:4] for k, t in rolled.items()},
                        jc[1], 1)
    assert not rolled["k_scale"][:, :, 4].any()  # nothing else written
