"""The port's decode attention (plain version, the path CPU tensors take)
against the JAX package's Pallas kernel in interpret mode and its dense
reference.

Tolerance 2e-5 absolute/relative: both sides compute float32 scores, one
softmax and a float32 value sum over the same operands; only the order of
the float32 sums differs (the Pallas kernel accumulates 64-position blocks
online)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaura_tpu.ops.pallas_attention import (
    decode_attention as jax_decode_attention,
    decode_attention_reference,
)
from vaura_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
)

B, S, H, HD = 3, 100, 2, 64  # S not a multiple of the 64-position tile


def _inputs(seed, Hkv=H):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, HD)).astype(np.float32)
    kc = rng.standard_normal((B, S, Hkv, HD)).astype(np.float32)
    vc = rng.standard_normal((B, S, Hkv, HD)).astype(np.float32)
    kcur = rng.standard_normal((B, Hkv, HD)).astype(np.float32)
    vcur = rng.standard_normal((B, Hkv, HD)).astype(np.float32)
    return q, kc, vc, kcur, vcur


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("pos", [0, 1, 63, 64, 65, 99])
def test_plain_matches_pallas_interpret_and_reference(pos):
    q, kc, vc, kcur, vcur = _inputs(pos)
    # stale data at positions >= pos must not be read: make it huge
    kc[:, pos:] = 1e4
    vc[:, pos:] = -1e4
    got = decode_attention(*_t(q, kc, vc, kcur, vcur), pos).numpy()
    want_ref = np.asarray(decode_attention_reference(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kcur),
        jnp.asarray(vcur), jnp.int32(pos)))
    np.testing.assert_allclose(got, want_ref, rtol=2e-5, atol=2e-5)
    if pos > 0:  # the Pallas wrapper needs at least one cached position
        want_kernel = np.asarray(jax_decode_attention(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kcur),
            jnp.asarray(vcur), jnp.int32(pos), interpret=True))
        np.testing.assert_allclose(got, want_kernel, rtol=2e-5, atol=2e-5)


def test_plain_gqa_matches_repeated_heads():
    """GQA: head h reads KV head h // rep; the same as repeating the KV
    heads (how the JAX einsum path handles ``rep``)."""
    q, kc, vc, kcur, vcur = _inputs(7, Hkv=1)
    got = decode_attention_plain(*_t(q, kc, vc, kcur, vcur), 50).numpy()
    rep = lambda a, ax: np.repeat(a, H, axis=ax)
    want = np.asarray(decode_attention_reference(
        jnp.asarray(q), jnp.asarray(rep(kc, 2)), jnp.asarray(rep(vc, 2)),
        jnp.asarray(rep(kcur, 1)), jnp.asarray(rep(vcur, 1)), jnp.int32(50)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel entry point raises on tensors off the card instead of
    falling back to the plain version."""
    from vaura_tpu_torch.ops.decode_attention import decode_attention_cuda

    q, kc, vc, kcur, vcur = _t(*_inputs(1))
    with pytest.raises(ValueError):
        decode_attention_cuda(q, kc, vc, kcur, vcur, 5)


# --------------------------------------------------------------------------
# pos as a device scalar (a one-element int32 tensor), as the JAX package
# passes it, and the launch the kernel would make for it
EDGE_POSITIONS = [0, 1, 63, 64, 65, 128, 228, 229]


def _long_inputs(seed, S2=230, Hkv=H):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(2, H, HD), f(2, S2, Hkv, HD), f(2, S2, Hkv, HD), f(2, Hkv, HD), f(2, Hkv, HD)


@pytest.mark.parametrize("Hkv", [H, 1])
@pytest.mark.parametrize("pos", EDGE_POSITIONS)
def test_pos_tensor_equals_int_and_matches_jax(pos, Hkv):
    """``pos`` as a one-element int32 tensor gives the ``int`` form's output
    bit for bit, through the dispatcher and through the plain version, and
    stays within 2e-5 of the JAX package (GQA there by repeated KV heads)."""
    q, kc, vc, kcur, vcur = _long_inputs(pos + 7 * Hkv, Hkv=Hkv)
    kc[:, pos:] = 1e4   # stale rows must not be read
    vc[:, pos:] = -1e4
    args = _t(q, kc, vc, kcur, vcur)
    pos_t = torch.arange(230, dtype=torch.int32)[pos:pos + 1]
    want = decode_attention(*args, pos)
    for fn in (decode_attention, decode_attention_plain):
        assert torch.equal(fn(*args, pos_t), want)
        assert torch.equal(fn(*args, torch.tensor(pos, dtype=torch.int32)), want)
    rep = H // Hkv
    jargs = [jnp.asarray(a) for a in (
        q, np.repeat(kc, rep, 2), np.repeat(vc, rep, 2),
        np.repeat(kcur, rep, 1), np.repeat(vcur, rep, 1))]
    ref = np.asarray(decode_attention_reference(*jargs, jnp.int32(pos)))
    np.testing.assert_allclose(want.numpy(), ref, rtol=2e-5, atol=2e-5)
    if pos > 0:
        kern = np.asarray(jax_decode_attention(*jargs, jnp.int32(pos),
                                               interpret=True))
        np.testing.assert_allclose(want.numpy(), kern, rtol=2e-5, atol=2e-5)


def test_pos_tensor_is_clamped_like_the_kernel():
    """The kernel clamps a device ``pos`` to [0, S]; the plain version does
    the same with a tensor, while an ``int`` outside the range raises."""
    args = _t(*_inputs(3))
    full = decode_attention_plain(*args, S)
    over = decode_attention_plain(*args, torch.tensor([S + 5], dtype=torch.int32))
    assert torch.equal(full, over)
    with pytest.raises(ValueError):
        decode_attention(*args, S + 1)
    with pytest.raises(ValueError):
        decode_attention(*args, -1)


@pytest.mark.parametrize(
    "bad",
    [
        lambda: torch.tensor([5], dtype=torch.int64),         # dtype
        lambda: torch.tensor([5, 6], dtype=torch.int32),      # size
        lambda: torch.empty(1, dtype=torch.int32, device="meta"),  # device
    ],
)
def test_pos_tensor_of_wrong_dtype_size_or_device_raises(bad):
    with pytest.raises(ValueError):
        decode_attention(*_t(*_inputs(4)), bad())


@pytest.mark.parametrize(
    "S2,pos,on_device,want",
    [
        # flagship cache, pos in device memory: the launch covers S + 1 rows
        (230, 0, True, dict(tiles=4, cluster=4, tiles_per_block=1)),
        # pos on the host: as many tiles as pos + 1 rows need
        (230, 0, False, dict(tiles=1, cluster=1, tiles_per_block=1)),
        (230, 63, False, dict(tiles=1, cluster=1, tiles_per_block=1)),
        (230, 64, False, dict(tiles=2, cluster=2, tiles_per_block=1)),
        (230, 229, False, dict(tiles=4, cluster=4, tiles_per_block=1)),
        # more tiles than the portable cluster of 8: a block walks several
        (1024, 0, True, dict(tiles=17, cluster=8, tiles_per_block=3)),
        (1024, 511, False, dict(tiles=8, cluster=8, tiles_per_block=1)),
        (1024, 512, False, dict(tiles=9, cluster=8, tiles_per_block=2)),
    ],
)
def test_launch_plan(S2, pos, on_device, want):
    from vaura_tpu_torch.ops.decode_attention import launch_plan

    assert launch_plan(S2, pos, on_device) == want


def test_shared_memory_plan_fits_a_block():
    from vaura_tpu_torch.ops.decode_attention import SMEM_LIMIT, smem_bytes

    # flagship: hd 96, one query head per KV head, a cluster of 4
    flagship = smem_bytes(96, 1, 4)
    assert flagship == 2 * 65 * 224 + 16 + 4 * (96 + 4 * 98 + 98 + 2 + 4 * 98)
    assert flagship < 48 * 1024
    # GQA of 4 and a long cache (cluster of 8), the widest head dim
    assert smem_bytes(128, 4, 8) < SMEM_LIMIT
    # shared memory grows with the heads a block serves, up to refusal
    assert smem_bytes(128, 64, 8) > SMEM_LIMIT


@pytest.mark.parametrize("hd", [32, 64, 96, 128])
def test_int8_tile_rows_avoid_bank_conflicts(hd):
    """Two lanes read a row, each every other 16-byte vector, eight lanes
    (four rows) per shared-memory phase: row strides that are odd multiples
    of 32 bytes put the eight 16-byte reads in distinct banks."""
    from vaura_tpu_torch.ops.decode_attention import tile_row_bytes

    for int8 in (False, True):
        rb = tile_row_bytes(hd, 8 if int8 else 16)
        assert rb % 16 == 0 and (rb // 32) % 2 == 1 and rb % 32 == 0
        assert rb >= hd * (1 if int8 else 2)
        slots = {(r * rb + h * 16) % 128 for r in range(4) for h in range(2)}
        assert len(slots) == 8


def test_int8_shared_memory_plan():
    """An int8 tile is 64 rows of hd bytes (padded to an odd multiple of 32)
    plus the current position's bf16 row; the float part is the bf16
    kernel's. The launch plan does not depend on the cache's type."""
    from vaura_tpu_torch.ops.decode_attention import SMEM_LIMIT, smem_bytes

    floats = 4 * (96 + 4 * 98 + 98 + 2 + 4 * 98)
    assert smem_bytes(96, 1, 4, cache_bits=8) == 2 * (64 * 96 + 192) + 16 + floats
    assert smem_bytes(64, 1, 4, cache_bits=8) == (
        2 * (64 * 96 + 128) + 16 + 4 * (64 + 4 * 66 + 66 + 2 + 4 * 66))
    for hd in (32, 64, 96, 128):
        assert smem_bytes(hd, 4, 8, cache_bits=8) < smem_bytes(hd, 4, 8)
    assert smem_bytes(128, 4, 8, cache_bits=8) < SMEM_LIMIT
    assert smem_bytes(128, 64, 8, cache_bits=8) > SMEM_LIMIT


# --------------------------------------------------------------------------
# the two forms: the cluster form at the model's batch, the serving form at
# serving batches, chosen from the shapes alone
KINDS = ("bf16", "int8", "int4", "dots")


@pytest.mark.parametrize("kind", KINDS)
def test_launch_plan_picks_the_form_from_the_shapes(kind):
    """The flagship's B2 = 4 (64 (batch row, KV head) pairs) takes the
    cluster form, a serving B2 = 256 (4,096 pairs) the serving form; with
    pos in device memory the plan is the same at every position, and with
    pos on the host the form is too."""
    from vaura_tpu_torch.ops.decode_attention import launch_plan

    small = launch_plan(230, 0, True, pairs=64, kind=kind)
    assert small == dict(tiles=4, cluster=4, tiles_per_block=1,
                         form="cluster")
    big = launch_plan(230, 0, True, pairs=4096, kind=kind)
    assert big == dict(tiles=4, cluster=1, tiles_per_block=4, form="serve")
    for pos in range(0, 231, 7):
        for pairs, want in ((64, small), (4096, big)):
            assert launch_plan(230, pos, True, pairs=pairs, kind=kind) == want
            assert launch_plan(230, pos, False, pairs=pairs,
                               kind=kind)["form"] == want["form"]
    # a cache of one tile keeps the cluster form; a form that does not fit
    # a block is not taken
    assert launch_plan(63, 0, True, pairs=4096, kind=kind)["form"] == "cluster"
    assert launch_plan(230, 0, True, pairs=4096, kind=kind,
                       serve_fits=False)["form"] == "cluster"


def test_serving_form_thresholds_are_measured_crossovers():
    """The quantized kinds take the serving form from B2 = 16 at H_kv = 16
    (256 pairs), bf16 from B2 = 64 (1,024): below that the cluster form."""
    from vaura_tpu_torch.ops.decode_attention import SERVE_FROM_PAIRS, launch_plan

    for kind, first in (("int8", 16), ("int4", 16), ("dots", 16), ("bf16", 64)):
        assert SERVE_FROM_PAIRS[kind] == first * 16
        for B2 in (4, 8, 16, 32, 64, 128, 256):
            form = launch_plan(230, 0, True, pairs=B2 * 16, kind=kind)["form"]
            assert form == ("serve" if B2 >= first else "cluster")


def test_kernel_plan_adds_shared_memory_and_forced_forms():
    from vaura_tpu_torch.ops.decode_attention import kernel_plan, smem_bytes

    plan = kernel_plan(4, 16, 16, 230, 96, 0, True, kind="int8")
    assert plan["form"] == "cluster"
    assert plan["smem"] == smem_bytes(96, 1, 4, cache_bits=8)
    plan = kernel_plan(256, 16, 16, 230, 96, 0, True, kind="int8")
    assert plan["form"] == "serve"
    assert plan["smem"] == smem_bytes(96, 1, cache_bits=8, form="serve")
    # a check forces either form at any batch
    assert kernel_plan(4, 16, 16, 230, 96, 0, True, kind="int8",
                       form="serve")["form"] == "serve"
    assert kernel_plan(256, 16, 16, 230, 96, 0, True, kind="int8",
                       form="cluster")["cluster"] == 4
    with pytest.raises(ValueError):
        kernel_plan(4, 16, 16, 230, 96, 0, True, kind="int8", form="tiles")
    # the cluster form's grid is (tiles, B * H_kv): at most 65,535 pairs
    with pytest.raises(ValueError):
        kernel_plan(5000, 16, 16, 230, 96, 0, True, kind="bf16",
                    form="cluster")
    assert kernel_plan(5000, 16, 16, 230, 96, 0, True,
                       kind="bf16")["form"] == "serve"


@pytest.mark.parametrize("cache_bits", [16, 8, 4])
def test_serving_form_shared_memory(cache_bits):
    """The serving form's block: two stages of a K and a V tile, the
    current position's bf16 rows, two mbarriers, q and each of the four
    warps' running partials per query head; it fits 227 KB for hd 32-128
    and 1-8 query heads per KV head, and 96 query heads of dim 128 are
    refused."""
    from vaura_tpu_torch.ops.decode_attention import (
        SMEM_LIMIT,
        kernel_plan,
        smem_bytes,
        tile_row_bytes,
    )

    kind = {16: "bf16", 8: "int8", 4: "int4"}[cache_bits]
    for hd in (32, 64, 96, 128):
        rb = tile_row_bytes(hd, cache_bits)
        for rep in range(1, 9):
            want = (2 * 2 * 64 * rb + 4 * hd + 16
                    + 4 * rep * (hd + 4 * (hd + 2)))
            assert smem_bytes(hd, rep, cache_bits=cache_bits,
                              form="serve") == want
            assert want <= SMEM_LIMIT
            plan = kernel_plan(256, 16 * rep, 16, 230, hd, 0, True, kind=kind,
                               form="serve")
            assert plan["smem"] == want
    assert smem_bytes(128, 96, cache_bits=cache_bits, form="serve") > SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        kernel_plan(256, 96, 1, 230, 128, 0, True, kind=kind, form="serve")
