"""The port's last sampler modes against ``vaura_tpu``'s on the tiny float32
config of ``tests/test_system.py``, the same weights on both sides
(``convert.from_jax_params``): the int4 KV cache (``cache_bits=4``), the
int8 x int8 attention products (``int8_dots``) and both, and the plain token
tables (``dac_factored_embeddings=False``).

Tolerances: logits within 2e-5 absolute/relative (float32 on both sides,
sums in other orders; the integer products are exact on both). Quantized
K/V agree as ``tests/test_torch_sampler_int8.py`` holds them: a value on a
rounding edge may land one step apart (within 1, nearly all equal), scales
within 2e-5. ``quantize_kv4`` / ``unpack_int4`` are held bit for bit."""

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
from vaura_tpu.ops import quantization as jq
from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.models.sampler import Sampler as TSampler
from vaura_tpu_torch.ops import quantization as tq

TOL = dict(rtol=2e-5, atol=2e-5)
B, S = 2, 24
MODES = {"int4": dict(cache_bits=4), "dots": dict(int8_dots=True),
         "int4_dots": dict(cache_bits=4, int8_dots=True)}
J_GQA = dataclasses.replace(J_SAMPLER, n_kv_head=2)


def _jcfg(mode, base=J_SAMPLER):
    return dataclasses.replace(base, quantize_cache=True, **MODES[mode])


@pytest.fixture(scope="module")
def trees():
    """Seeded parameter trees of the MHA and the GQA (2 KV heads) config."""
    out = {}
    for name, cfg in (("mha", J_SAMPLER), ("gqa", J_GQA)):
        params = JSampler(cfg).init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0),
             "cfg_dropout": jax.random.PRNGKey(0)},
            jnp.zeros((1, 3, 16), jnp.int32), jnp.zeros((1, 8, 24)), False,
        )["params"]
        out[name] = randomize_sampler_heads(np_tree(params), 1)
    return out


def _pair(tree, jcfg):
    ts = TSampler(port_sampler_config(jcfg), device=CPU)
    ts.load_state_dict(from_jax_params({"sampler": tree})["sampler"])
    return JSampler(jcfg), jax.tree_util.tree_map(jnp.asarray, tree), ts


def _assert_int8_close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.int8 and want.dtype == np.int8
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def _assert_int4_close(got: torch.Tensor, want) -> None:
    """Packed int4 bytes compared value by value (unpacked)."""
    _assert_int8_close(tq.unpack_int4(got),
                       np.asarray(jq.unpack_int4(jnp.asarray(want))))


def _assert_cache_close(tcache, jcache, n: int, packed: bool) -> None:
    for name in jcache:
        got, want = tcache[name][:, :, :n], np.asarray(jcache[name])[:, :, :n]
        if want.dtype == np.int8:
            (_assert_int4_close if packed else _assert_int8_close)(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=name)


# --------------------------------------------------------------------------
@pytest.mark.parametrize("hd", [12, 96])
def test_quantize_kv4_and_unpack_match_jax_bit_for_bit(hd):
    """Random rows, rows of exact half-way ties (max 7: scale 1, every
    other value k + 0.5, rounded half to even), all-zero rows (the 1e-8
    floor) and every byte through ``unpack_int4``."""
    rng = np.random.default_rng(hd)
    rand = rng.standard_normal((3, 5, hd)).astype(np.float32)
    ties = rng.integers(-7, 7, (4, hd)).astype(np.float32) + 0.5
    ties[:, 0] = 7.0
    x = np.concatenate([rand.reshape(-1, hd), ties, np.zeros((2, hd),
                                                              np.float32)])
    jp, js = jq.quantize_kv4(jnp.asarray(x))
    tp, ts = tq.quantize_kv4(torch.from_numpy(x))
    assert tp.dtype == torch.int8 and tp.shape == (x.shape[0], hd // 2)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ts[-2:] == np.float32(1e-8)).all()
    every = np.arange(-128, 128, dtype=np.int8).reshape(-1, 16)
    np.testing.assert_array_equal(
        tq.unpack_int4(torch.from_numpy(every)).numpy(),
        np.asarray(jq.unpack_int4(jnp.asarray(every))))
    u = tq.unpack_int4(tp).numpy()
    assert u.min() >= -7 and u.max() <= 7
    np.testing.assert_array_equal(u[-6:-2], np.asarray(
        jnp.clip(jnp.round(jnp.asarray(ties)), -7, 7)).astype(np.int8))


def _random_cache(rng, cfg, packed):
    hd = cfg.head_dim // 2 if packed else cfg.head_dim
    shape = (cfg.num_layers, B, S, cfg.n_kv_heads, hd)
    lo = -128 if packed else -127  # every byte is a valid pair of nibbles
    return {"k": rng.integers(lo, 128, shape).astype(np.int8),
            "v": rng.integers(lo, 128, shape).astype(np.int8),
            "k_scale": rng.uniform(0.005, 0.05, shape[:-1]).astype(np.float32),
            "v_scale": rng.uniform(0.005, 0.05, shape[:-1]).astype(np.float32)}


def _decode_steps(js, jp, ts, cfg, c0, starts, positions, seed):
    """JAX's ``decode_step`` over the cache split into chunk buffers at
    ``starts`` and the port's over one cache whose ``chunk_starts`` are
    ``starts``; the logits of each step compared, the caches returned."""
    rng = np.random.default_rng(seed)
    edges = list(starts) + [S]
    jch = tuple({k: jnp.asarray(v[:, :, a:b]) for k, v in c0.items()}
                for a, b in zip(edges[:-1], edges[1:]))
    tc = ts.init_cache(B, S)
    for k, v in c0.items():
        tc[k].copy_(torch.from_numpy(v))
    tc["chunk_starts"] = torch.tensor(starts, dtype=torch.int32)
    for pos in positions:
        tok = rng.integers(0, cfg.vocab_with_special,
                           (B, cfg.num_codebooks, 1)).astype(np.int32)
        cond = rng.standard_normal((B, 1, cfg.cond_dim)).astype(np.float32)
        jl, jch = js.apply({"params": jp}, jnp.asarray(tok), jnp.asarray(cond),
                           jch, jnp.int32(pos), None, tuple(starts),
                           method=js.decode_step)
        tl = ts.decode_step(torch.from_numpy(tok), torch.from_numpy(cond),
                            tc, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"pos {pos}")
    return tc, {k: jnp.concatenate([c[k] for c in jch], axis=2) for k in c0}


@pytest.mark.parametrize("heads", ["mha", "gqa"])
@pytest.mark.parametrize("starts", [(0, 9), (0, 5, 14)],
                         ids=["two_chunks", "three_chunks"])
@pytest.mark.parametrize("mode", list(MODES))
def test_decode_steps_match_jax_chunks(trees, mode, starts, heads):
    """Decode steps over a quantized cache that JAX holds in two or three
    chunk buffers, committing each step's quantized K/V into the last."""
    base = J_GQA if heads == "gqa" else J_SAMPLER
    cfg = _jcfg(mode, base)
    js, jp, ts = _pair(trees[heads], cfg)
    packed = cfg.cache_bits == 4
    c0 = _random_cache(np.random.default_rng(len(starts)), cfg, packed)
    n = starts[-1] + 5
    tc, jc = _decode_steps(js, jp, ts, cfg, c0, starts,
                           range(starts[-1], n), seed=7)
    if packed:
        assert tc["k"].shape[-1] == cfg.head_dim // 2
    _assert_cache_close(tc, jc, n, packed)


def _attention_pair(cfg):
    """JAX's ``Attention`` layer and the port's with identity projections:
    q, k and v are the input itself (exact on both sides), so the two
    compute decode attention on bit-identical inputs."""
    from vaura_tpu.models.sampler import Attention as JAttention
    from vaura_tpu_torch.models.sampler import Attention as TAttention

    D, kv = cfg.d_model, cfg.n_kv_heads * cfg.head_dim
    eye = np.eye(D, dtype=np.float32)
    wqkv = np.concatenate([eye, eye[:, :kv], eye[:, :kv]], axis=1)
    jparams = {"wqkv": {"kernel": jnp.asarray(wqkv)},
               "wo": {"kernel": jnp.asarray(eye)}}
    tatt = TAttention(port_sampler_config(cfg), device=CPU)
    tatt.wqkv.weight.data = torch.from_numpy(wqkv.T.copy())
    tatt.wo.weight.data = torch.from_numpy(eye)
    return JAttention(cfg), jparams, tatt


def _attend(cfg, c0, x, pos, starts):
    """Layer 0 of ``c0`` attended at ``pos`` by both layers, the cache in
    chunk buffers at ``starts`` (JAX) or with those ``chunk_starts`` (the
    port); RoPE at row 0 (the identity rotation). Returns both outputs."""
    jatt, jparams, tatt = _attention_pair(cfg)
    names = ("k", "v", "k_scale", "v_scale")
    edges = list(starts) + [S]
    chunks = tuple(tuple(jnp.asarray(c0[n][0][:, a:b]) for n in names)
                   for a, b in zip(edges[:-1], edges[1:]))
    masks = tuple(None for _ in starts[1:]) + (
        starts[-1] + jnp.arange(S - starts[-1]) < pos,)
    freqs = np.asarray(tatt_freqs(cfg))
    want, _ = jatt.apply({"params": jparams}, jnp.asarray(x),
                         jnp.asarray(freqs), None, chunks, jnp.int32(pos),
                         False, masks)
    got, _ = tatt.decode(torch.from_numpy(x), torch.from_numpy(freqs),
                         tuple(torch.from_numpy(c0[n][0]) for n in names),
                         torch.tensor([pos], dtype=torch.int32),
                         torch.tensor(starts, dtype=torch.int32))
    return got.detach().numpy(), np.asarray(want)


def tatt_freqs(cfg):
    from vaura_tpu_torch.ops.rope import precompute_freqs_cis

    return precompute_freqs_cis(cfg.block_size, cfg.head_dim,
                                cfg.rope_base)[:1]


@pytest.mark.parametrize("heads", ["mha", "gqa"])
@pytest.mark.parametrize("starts", [(0,), (0, 9), (0, 5, 14)],
                         ids=["one_chunk", "two_chunks", "three_chunks"])
@pytest.mark.parametrize("mode", list(MODES))
def test_decode_attention_matches_jax_attention(mode, starts, heads):
    """The plain decode attention of each mode against the JAX package's
    attention layer on the same q, k, v and cache, over one, two and three
    chunk buffers, at every position of the last chunk."""
    cfg = _jcfg(mode, J_GQA if heads == "gqa" else J_SAMPLER)
    rng = np.random.default_rng(5)
    c0 = _random_cache(rng, cfg, cfg.cache_bits == 4)
    for pos in range(starts[-1], S):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        got, want = _attend(cfg, c0, x, pos, starts)
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"pos {pos}")


def test_int8_dots_chunks_change_jax_numbers_and_the_port_follows():
    """The JAX package's docstrings call the chunk split a regrouping of
    float32 sums; under ``int8_dots`` it is not: the probabilities are
    quantized per chunk, so one chunk and two chunks split at row 8 give
    different attention at position 20 (by about 1e-3 here), far more than
    without ``int8_dots`` (1e-7). The port matches each split."""
    pos, split = 20, 8
    moved = {}
    for dots in (False, True):
        cfg = dataclasses.replace(J_SAMPLER, quantize_cache=True,
                                  int8_dots=dots)
        rng = np.random.default_rng(11)
        c0 = _random_cache(rng, cfg, False)
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        got1, one = _attend(cfg, c0, x, pos, (0,))
        got2, two = _attend(cfg, c0, x, pos, (0, split))
        np.testing.assert_allclose(got1, one, **TOL)
        np.testing.assert_allclose(got2, two, **TOL)
        moved[dots] = float(np.abs(one - two).max())
    assert moved[False] < 1e-6
    assert moved[True] > 1e-4


@pytest.mark.parametrize("mode", list(MODES))
def test_prefill_then_decode_matches_jax(trees, mode):
    """``prefill`` of a padded prompt into a fresh int4 (or int8) cache,
    then decode steps over it: JAX continues it as one chunk."""
    cfg = _jcfg(mode)
    js, jp, ts = _pair(trees["mha"], cfg)
    rng = np.random.default_rng(3)
    T = 30
    tok = rng.integers(0, cfg.vocab_with_special,
                       (B, cfg.num_codebooks, T)).astype(np.int32)
    cond = rng.standard_normal((B, T, cfg.cond_dim)).astype(np.float32)
    jl, jc = js.apply({"params": jp}, jnp.asarray(tok), jnp.asarray(cond),
                      method=js.prefill)
    tl, tc = ts.prefill(torch.from_numpy(tok), torch.from_numpy(cond))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    packed = cfg.cache_bits == 4
    assert tc["k"].shape[-1] == (cfg.head_dim // 2 if packed else cfg.head_dim)
    _assert_cache_close(tc, jc, T, packed)
    for pos in (20, 21):
        jl1, jc = js.apply({"params": jp}, jnp.asarray(tok[:, :, pos:pos + 1]),
                           jnp.asarray(cond[:, pos:pos + 1]), jc,
                           jnp.int32(pos), method=js.decode_step)
        tl1 = ts.decode_step(torch.from_numpy(tok[:, :, pos:pos + 1]),
                             torch.from_numpy(cond[:, pos:pos + 1]), tc, pos)
        np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), **TOL)


@pytest.mark.parametrize("hd", [32, 64, 96, 128])
def test_int4_tile_rows_and_the_products_shared_memory(hd):
    """An int4 row (``hd / 2`` bytes) is read whole by both lanes of a row,
    eight lanes (four rows) a shared-memory phase of 16-byte loads: the
    four rows' 16-byte slots must fall into distinct 4-bank groups. The
    int8 x int8 kernel's block holds the flagship's 8 groups with room to
    spare and refuses what does not fit."""
    from vaura_tpu_torch.ops.decode_attention import (
        SMEM_LIMIT,
        dots_smem_bytes,
        smem_bytes,
        tile_row_bytes,
    )

    rb = tile_row_bytes(hd, 4)
    assert rb % 16 == 0 and rb >= hd // 2
    assert len({(r * rb // 16) % 8 for r in range(4)}) == 4
    floats = 4 * (hd + 4 * (hd + 2) + (hd + 2) + 2 + 8 * (hd + 2))
    assert smem_bytes(hd, 1, 8, cache_bits=4) == 2 * (64 * rb + 2 * hd) + 16 \
        + floats
    assert smem_bytes(hd, 1, 8, cache_bits=4) < smem_bytes(hd, 1, 8,
                                                             cache_bits=8)
    assert dots_smem_bytes(hd, 1, 230, 8) < 48 * 1024
    assert dots_smem_bytes(hd, 4, 1024, 8) < SMEM_LIMIT
    assert dots_smem_bytes(hd, 16, 2048, 64) > SMEM_LIMIT


def test_decode_attention_refuses_int8_dots_without_a_quantized_cache():
    from vaura_tpu_torch.ops.decode_attention import decode_attention

    q = torch.zeros(1, 4, 12)
    kv = torch.zeros(1, 3, 4, 12)
    with pytest.raises(ValueError, match="int8_dots"):
        decode_attention(q, kv, kv, q, q, 2, int8_dots=True)


def test_decode_attention_refuses_int8_dots_without_groups():
    """``chunk_starts`` is required with ``int8_dots``: no call quietly
    takes one group."""
    from vaura_tpu_torch.ops.decode_attention import decode_attention

    q = torch.zeros(1, 4, 12)
    kv = torch.zeros(1, 3, 4, 12, dtype=torch.int8)
    s = torch.ones(1, 3, 4)
    with pytest.raises(ValueError, match="chunk_starts"):
        decode_attention(q, kv, kv, q, q, 2, s, s, int8_dots=True)


@pytest.mark.parametrize("mode", list(MODES))
def test_fresh_caches_hold_one_group_under_int8_dots(trees, mode):
    """``init_cache`` and ``prefill`` give an ``int8_dots`` cache one
    quantization group (``[0]``, JAX's single chunk) and no other cache
    any."""
    cfg = _jcfg(mode)
    _, _, ts = _pair(trees["mha"], cfg)
    tok = np.zeros((B, cfg.num_codebooks, 6), np.int32)
    cond = np.zeros((B, 6, cfg.cond_dim), np.float32)
    _, prefilled = ts.prefill(torch.from_numpy(tok), torch.from_numpy(cond))
    for cache in (ts.init_cache(B, 6), prefilled):
        if cfg.int8_dots:
            assert cache["chunk_starts"].dtype == torch.int32
            assert cache["chunk_starts"].tolist() == [0]
        else:
            assert "chunk_starts" not in cache


def _one_block_dots_smem_bytes(hd, rep, S, groups):
    """The int8 x int8 kernel's shared memory before its cluster split (one
    block per (b, KV head) holding every row's probabilities): what the
    kernel accepted then."""
    up = lambda n: -(-n // 16) * 16
    sp = max(4, -(-S // 4) * 4)
    return (up(rep * hd) + up(rep * sp) + up(4 * rep * hd) + up(4 * rep * sp)
            + up(4 * rep * groups) + up(8 * rep) + up(4 * rep * groups * hd)
            + up(4 * rep * groups) + up(4 * groups))


@pytest.mark.parametrize("hd", [32, 64, 96, 128])
def test_int8_dots_forms_shared_memory(hd):
    """Both forms of the int8 x int8 kernel over hd 32-128, 1-8 query heads
    per KV head, caches up to 1,024 rows and up to 64 groups: the plan
    takes a form whose block fits 227 KB and refuses exactly where neither
    does; every shape the one-block kernel took still fits; the cluster
    form holds a cluster's share of the rows, the serving form all of
    them."""
    from vaura_tpu_torch.ops.decode_attention import (
        SMEM_LIMIT,
        dots_smem_bytes,
        kernel_plan,
    )

    for cache_bits in (8, 4):
        for rep in range(1, 9):
            for S in (1, 24, 63, 64, 230, 511, 512, 1024):
                for groups in (1, 8, 33, 64):
                    cl = dots_smem_bytes(hd, rep, S, groups, form="cluster",
                                         cache_bits=cache_bits)
                    sv = dots_smem_bytes(hd, rep, S, groups, form="serve",
                                         cache_bits=cache_bits)
                    assert cl <= sv
                    for B in (2, 128):
                        kw = dict(kind="dots", cache_bits=cache_bits,
                                  groups=groups)
                        if min(cl, sv) > SMEM_LIMIT:
                            with pytest.raises(ValueError, match="shared"):
                                kernel_plan(B, 16 * rep, 16, S, hd, 0, True,
                                            **kw)
                            continue
                        plan = kernel_plan(B, 16 * rep, 16, S, hd, 0, True,
                                           **kw)
                        assert plan["smem"] <= SMEM_LIMIT
                        assert plan["smem"] == (cl if plan["form"] == "cluster"
                                                else sv)
                    if _one_block_dots_smem_bytes(hd, rep, S, groups) <= SMEM_LIMIT:
                        assert cl <= SMEM_LIMIT
    # the flagship's block in either form, and a shape no form holds
    assert dots_smem_bytes(hd, 1, 230, 8, form="cluster") < 32 * 1024
    assert dots_smem_bytes(hd, 1, 230, 8) < 48 * 1024
    with pytest.raises(ValueError, match="shared"):
        kernel_plan(2, 128, 8, 1024, 128, 0, True, kind="dots", groups=64)
