"""Decode attention over the KV cache for one step of one layer.

Counterpart of ``vaura_tpu/ops/pallas_attention.py``: the query of position
``pos`` attends over the cached positions ``< pos`` plus the current
position's ``k_cur``/``v_cur`` (not yet committed to the cache), with a
float32 softmax. On a CUDA tensor ``decode_attention`` launches a kernel of
``csrc/decode_attention.cu`` once, with no scratch tensor, in one of two
forms that ``launch_plan`` picks from the shapes alone (the number of
(batch row, KV head) pairs ``B * H_kv``, ``S`` and the kind of cache; never
from ``pos``):

* the cluster form, for few pairs (the model's batch): the 64-row tiles of
  one pair are the blocks of a thread-block cluster, each fetched by bulk
  asynchronous copies and serving every query head of the KV head; the
  blocks merge their partials through distributed shared memory;
* the serving form, from ``SERVE_FROM_PAIRS`` pairs on (a serving batch,
  where the pairs alone fill the card): one block per pair, no cluster, its
  tiles through a ring of bulk copies so that one tile is in flight while
  another is computed, the merge inside the block.

A check can force a form (``form=`` on ``decode_attention_cuda``, or
``forced_form`` around a model call); the plan never falls back from one to
the other. ``form_launches`` counts the launches of each. On a CPU tensor it
runs ``decode_attention_plain``, the same function in plain PyTorch.

``pos`` is an ``int`` or, as in the JAX package, a scalar on the device: a
one-element int32 tensor on ``q``'s device. With the tensor the launch
covers the whole cache length and the kernel reads ``pos`` itself, so the
launch is the same for every position (what replaying a captured decode
step needs); the kernel clamps it to ``[0, S]``.

The int8 cache (``k_scale``/``v_scale`` given): int8 rows with one float32
scale per (position, KV head), the JAX package's einsum branch
(``vaura_tpu/models/sampler.py:296-391``): the cache scores are ``q . k``
times ``1/sqrt(hd)`` times ``k_scale``, the current position's k/v stay
unquantized, one softmax, and the cache probabilities are multiplied by
``v_scale`` before the value product. On the card the same kernel reads int8
tiles (a second instantiation); the scales keep JAX's ``[B, S, H_kv]``
layout, so the cache compares with JAX's as it is: the kernel loads a row's
two scales with plain loads from the lane that reads the row, beside the
tile's bulk copies, rather than giving them a layout of their own.

The int4 cache (``cache_bits=4``): two values a byte, half-split (byte
``j`` holds element ``j`` in its low nibble and ``j + hd/2`` in its high
one, ``ops/quantization.py::quantize_kv4``), the same scales; the JAX
package unpacks and then computes what the int8 cache computes
(``sampler.py:317-321``), and so does the plain version. On the card the
kernel's third instantiation reads the packed tiles and widens the nibbles
in registers.

The int8 x int8 products (``int8_dots``, over an int8 or int4 cache; JAX
``sampler.py:306-391``): q is quantized per query head
(``quantize_rows``), a cache score is the exact int32 product ``q8 . k8``
times ``scale * q_scale * k_scale``, the current position's score stays
``q . k_cur * scale``, one float32 softmax; then for each quantization group
of cache rows the probabilities times ``v_scale`` are quantized
(``quantize_rows`` over the group's rows: rows at or past ``pos`` count as
0, the 1e-8 floor holds), multiplied with the int8 values in int32 and
rescaled, and the current position's ``p * v_cur`` is added last. The groups
are the JAX package's chunk buffers: ``chunk_starts``, the first cache row
of each group in increasing order (rows below the second start belong to
the first group; ``[0]`` is one group), an int32 tensor on ``q``'s device
that the kernel reads, so the launch is the same at every step; it is
required with ``int8_dots``. The groups change the numbers: the quantization
scale of a probability is its group's. On the card a kernel of its own (the
softmax's max and sum must be known before any int8 probability exists), in
the same two forms: the cluster form splits a pair's rows over the blocks of
a cluster, which exchange their (max, sum), their group maxima and their
exact int32 group sums through distributed shared memory; the serving form
takes one block per pair (see ``csrc/decode_attention.cu``).

Layouts (JAX's, kept at the public function):
  q, k_cur, v_cur  [B, H, hd] / [B, H_kv, hd]
  k_cache, v_cache [B, S, H_kv, hd]  (one layer of the [L, B, S, H_kv, hd]
                                      cache; stale at positions >= pos;
                                      hd / 2 int8 bytes for the int4 cache)
  k_scale, v_scale [B, S, H_kv]      (int8 and int4 caches)
  chunk_starts     [G] int32         (int8_dots only)
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Union

import torch

from vaura_tpu_torch.kernels import build
from vaura_tpu_torch.ops.quantization import quantize_rows, unpack_int4

# launches of the CUDA kernels (one per call on a CUDA tensor), how many of
# them took ``pos`` from device memory, how many read int8 tiles, int4 tiles
# and how many took the int8 x int8 products (over either cache); and the
# launches of each form
launches = 0
device_pos_launches = 0
int8_launches = 0
int4_launches = 0
int8_dots_launches = 0
form_launches = {"cluster": 0, "serve": 0}

TILE = 64          # cache positions per block
MAX_CLUSTER = 8    # blocks of one cluster (the portable limit)
SMEM_LIMIT = 227 * 1024
MAX_GROUPS = 64    # quantization groups the int8 x int8 kernel takes
SERVE_STAGES = 2   # tile stages of the serving form's ring (kStages)
DOTS_STAGES = 2    # the same for the int8 x int8 kernel (kDotStages)
DOTS_WARPS = 8     # warp slots of an int8 x int8 block's reductions
# the serving form from this many (batch row, KV head) pairs on, for each
# kind of cache: where ``python3 -m vaura_tpu_torch.profile_kernels forms``
# measured it faster on the card at H_kv = 16, S = 230 (PERF.md): the
# quantized kinds from B2 = 16, bf16 from B2 = 64
SERVE_FROM_PAIRS = {"bf16": 1024, "int8": 256, "int4": 256, "dots": 256}
FORMS = ("cluster", "serve")
_SUPPORTED_HD = (32, 64, 96, 128)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {
    "vt_decode_attention": [_P] * 6 + [_I] * 7 + [_P, _P],
    "vt_decode_attention_int8": [_P] * 8 + [_I] * 7 + [_P, _P],
    "vt_decode_attention_int4": [_P] * 8 + [_I] * 7 + [_P, _P],
    "vt_decode_attention_dots": [_P] * 9 + [_I] * 9 + [_P, _P],
    "vt_decode_attention_empty": [_I] * 10 + [_P],
}
# the entry point of each kind of cache, and its code for the empty launch
_KINDS = {"bf16": 0, "int8": 1, "int4": 2, "dots": 3}
_CACHE_BITS = {"bf16": 16, "int8": 8, "int4": 4}

Pos = Union[int, torch.Tensor]
_forced_form = None


def launch_plan(S: int, pos: int, pos_on_device: bool, *, pairs=None,
                kind: str = "bf16", serve_fits: bool = True) -> dict:
    """The launch ``decode_attention`` makes: ``cluster`` blocks per (batch
    row, KV head), each walking ``tiles_per_block`` tiles of ``TILE`` rows
    at most, over the ``pos`` cached rows and the current one. With ``pos``
    on the device the plan covers ``S + 1`` rows.

    Given the number of (batch row, KV head) ``pairs`` and the ``kind`` of
    cache (``bf16``, ``int8``, ``int4`` or ``dots``), the plan also names its
    ``form``: the serving form (one block per pair over all its tiles) from
    ``SERVE_FROM_PAIRS[kind]`` pairs on where ``S`` spans more than one tile
    and the form's shared memory fits (``serve_fits``), else the cluster
    form. The form depends on shapes only, never on ``pos``."""
    tiles = (S if pos_on_device else pos) // TILE + 1
    cluster = min(tiles, MAX_CLUSTER)
    plan = {"tiles": tiles, "cluster": cluster,
            "tiles_per_block": -(-tiles // cluster)}
    if pairs is None:
        return plan
    if pairs >= SERVE_FROM_PAIRS[kind] and S >= TILE and serve_fits:
        return _serve_plan(tiles)
    return dict(plan, form="cluster")


def _serve_plan(tiles: int) -> dict:
    return {"tiles": tiles, "cluster": 1, "tiles_per_block": tiles,
            "form": "serve"}


def tile_row_bytes(hd: int, cache_bits: int = 16) -> int:
    """Bytes between two rows of a tile in shared memory. bf16 and int8
    rows: an odd multiple of 32, so that the two lanes of a row, each taking
    every other 16-byte vector, read without bank conflicts (bf16 rows
    padded by 32 bytes, int8 rows by 32 where ``hd / 32`` is even). Int4
    rows (``hd / 2`` bytes) are read whole by both lanes: padded by 16 bytes
    where ``hd / 32`` is a multiple of 4, so that the four rows of a quarter
    warp meet distinct banks."""
    if cache_bits == 8:
        return hd + (0 if (hd // 32) % 2 else 32)
    if cache_bits == 4:
        return hd // 2 + (16 if (hd // 32) % 4 == 0 else 0)
    return 2 * hd + 32


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(hd: int, rep: int, cluster: int = MAX_CLUSTER,
               cache_bits: int = 16, form: str = "cluster") -> int:
    """Dynamic shared memory of one block. The cluster form: the K and V
    tiles (``TILE`` rows and the current position's, which is bf16 in an
    int8 or int4 tile too), two mbarriers and, per query head of the KV head
    (``rep`` of them), q, the four warps' partials of a tile, the block's
    running partial and rank 0's inbox of one partial per block of the
    cluster (``DecodeSmem`` in ``csrc/decode_attention.cu``). The serving
    form (``form="serve"``, ``cluster`` unused): ``SERVE_STAGES`` stages of a
    K and a V tile, the current position's bf16 rows, the stages' mbarriers,
    q and each warp's running partial per head (``ServeSmem``)."""
    partial = hd + 2
    rb = tile_row_bytes(hd, cache_bits)
    if form == "serve":
        return (SERVE_STAGES * 2 * TILE * rb + 4 * hd + _up16(8 * SERVE_STAGES)
                + 4 * rep * (hd + 4 * partial))
    floats = rep * (hd + 4 * partial + partial + 2 + cluster * partial)
    tile = TILE * rb + 2 * hd if cache_bits != 16 else (TILE + 1) * rb
    return 2 * tile + 16 + 4 * floats


def dots_row_bytes(hd: int, cache_bits: int = 8) -> int:
    """Bytes between two rows of a staged tile of the int8 x int8 kernel:
    an odd multiple of 16 (the eight rows a warp scores at once, four lanes
    a row reading one 4-byte word each, meet distinct banks)."""
    rd = hd // 2 if cache_bits == 4 else hd
    return rd + (0 if (rd // 16) % 2 else 16)


def dots_smem_bytes(hd: int, rep: int, S: int, groups: int, *,
                    cache_bits: int = 8, form: str = "serve") -> int:
    """Dynamic shared memory of one block of the int8 x int8 kernel for a
    cache of ``S`` rows with ``pos`` in device memory: the ring of
    ``DOTS_STAGES`` staged tiles, q as int8 and float32, the int8
    probabilities and float32 scores of the block's rows (all ``S // 64 +
    1`` tiles in the serving form, the cluster's share in the cluster form)
    for its ``rep`` query heads, the current position's k and v in float32,
    the rows' two scales, each group's max, every block's (max, sum), per-head
    statistics and warp partials, the integer sums ``[rep, groups, hd]`` and
    the group starts, each part rounded up to 16 bytes. Mirrors
    ``DotsLayout``."""
    tiles = S // TILE + 1
    per_block = -(-tiles // min(tiles, MAX_CLUSTER)) if form == "cluster" \
        else tiles
    rows = per_block * TILE
    return (DOTS_STAGES * TILE * dots_row_bytes(hd, cache_bits)
            + _up16(rep * hd) + _up16(rep * rows) + _up16(4 * rep * hd)
            + _up16(8 * hd) + _up16(4 * rep * rows) + 2 * _up16(4 * rows)
            + _up16(4 * rep * groups) + _up16(8 * rep * MAX_CLUSTER)
            + _up16(16 * rep) + _up16(8 * rep * DOTS_WARPS)
            + _up16(4 * rep * groups * hd) + _up16(4 * groups) + 8 * DOTS_STAGES)


def kernel_plan(B: int, H: int, Hkv: int, S: int, hd: int, pos: int,
                pos_on_device: bool, *, kind: str = "bf16",
                cache_bits: int = 8, groups: int = 1, form=None) -> dict:
    """``launch_plan`` for a call: its form (``form`` forces one, for
    checks) and the block's shared memory (``smem``); raises ``ValueError``
    where the form does not fit a block or takes no such grid. ``kind``:
    ``bf16``, ``int8``, ``int4`` or ``dots`` (over a ``cache_bits`` cache,
    ``groups`` groups)."""
    rep = H // Hkv
    base = launch_plan(S, pos, pos_on_device)

    def need(f):
        if kind == "dots":
            return dots_smem_bytes(hd, rep, S, groups, cache_bits=cache_bits,
                                   form=f)
        return smem_bytes(hd, rep, base["cluster"], _CACHE_BITS[kind], form=f)

    if form is None:
        plan = launch_plan(S, pos, pos_on_device, pairs=B * Hkv, kind=kind,
                           serve_fits=need("serve") <= SMEM_LIMIT)
    elif form == "serve":
        plan = _serve_plan(base["tiles"])
    elif form == "cluster":
        plan = dict(base, form="cluster")
    else:
        raise ValueError(f"decode_attention: form {form!r} not in {FORMS}")
    plan["smem"] = need(plan["form"])
    if plan["smem"] > SMEM_LIMIT:
        what = (f"int8_dots over {S} rows, {groups} groups and {rep} query "
                f"heads per KV head of dim {hd}" if kind == "dots" else
                f"{rep} query heads per KV head of dim {hd} over a cluster of "
                f"{plan['cluster']} blocks")
        raise ValueError(f"decode_attention: {what}: too large for a block's "
                         f"shared memory in the {plan['form']} form")
    if kind != "dots" and plan["form"] == "cluster" and B * Hkv > 65535:
        raise ValueError(f"decode_attention: {B * Hkv} (batch row, KV head) "
                         "pairs, the cluster form takes 65,535")
    return plan


@contextlib.contextmanager
def forced_form(form):
    """Every CUDA launch inside takes ``form`` (``cluster`` or ``serve``)
    whatever the plan picks: for checks that hold one form against the
    other on a model's path."""
    global _forced_form
    if form not in FORMS:
        raise ValueError(f"forced_form: {form!r} not in {FORMS}")
    before, _forced_form = _forced_form, form
    try:
        yield
    finally:
        _forced_form = before


def decode_attention_plain(q, k_cache, v_cache, k_cur, v_cur, pos: Pos,
                           k_scale=None, v_scale=None, *, cache_bits: int = 8,
                           int8_dots: bool = False, chunk_starts=None):
    """Dense reference: float32 scores over the positions ``< pos`` and the
    current one, one softmax, float32 value sum, cast to ``q.dtype``. A
    ``pos`` tensor is read back to the host and clamped as the kernel
    clamps it. With ``k_scale``/``v_scale`` the cache is int8 (int4 with
    ``cache_bits=4``), and ``int8_dots`` takes the int8 x int8 products over
    ``chunk_starts``' groups (see the module docstring)."""
    if isinstance(pos, torch.Tensor):
        pos = max(0, min(int(pos.item()), k_cache.shape[1]))
    if k_scale is not None:
        if cache_bits == 4:
            k_cache, v_cache = unpack_int4(k_cache), unpack_int4(v_cache)
        if int8_dots:
            return _plain_dots(q, k_cache, v_cache, k_cur, v_cur, pos,
                               k_scale, v_scale, chunk_starts)
        return _plain_int8(q, k_cache, v_cache, k_cur, v_cur, pos, k_scale,
                           v_scale)
    B, H, hd = q.shape
    rep = H // k_cache.shape[2]
    qf = q.float() * hd ** -0.5
    kc = k_cache[:, :pos].float()
    vc = v_cache[:, :pos].float()
    kcur, vcur = k_cur.float(), v_cur.float()
    if rep != 1:
        kc, vc = kc.repeat_interleave(rep, 2), vc.repeat_interleave(rep, 2)
        kcur, vcur = kcur.repeat_interleave(rep, 1), vcur.repeat_interleave(rep, 1)
    scores = torch.cat(
        [torch.einsum("bhd,bshd->bhs", qf, kc),
         (qf * kcur).sum(-1, keepdim=True)],
        dim=-1,
    )
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", probs[..., :pos], vc)
    out = out + probs[..., pos:] * vcur
    return out.to(q.dtype)


def _plain_int8(q, k_cache, v_cache, k_cur, v_cur, pos: int, k_scale,
                v_scale):
    """The JAX package's int8 einsums, in its order, in float32."""
    rep = q.shape[1] // k_cache.shape[2]
    rp = lambda t, dim: t.repeat_interleave(rep, dim) if rep != 1 else t
    qf = q.float()
    scale = q.shape[-1] ** -0.5
    kc, vc = rp(k_cache[:, :pos].float(), 2), rp(v_cache[:, :pos].float(), 2)
    ks = rp(k_scale[:, :pos].float(), 2).transpose(1, 2)  # [B, H, pos]
    vs = rp(v_scale[:, :pos].float(), 2).transpose(1, 2)
    kcur, vcur = rp(k_cur.float(), 1), rp(v_cur.float(), 1)
    scores = torch.cat(
        [torch.einsum("bhd,bshd->bhs", qf, kc) * scale * ks,
         (qf * kcur).sum(-1, keepdim=True) * scale],
        dim=-1,
    )
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", probs[..., :pos] * vs, vc)
    out = out + probs[..., pos:] * vcur
    return out.to(q.dtype)


def group_bounds(chunk_starts, pos: int) -> list:
    """The row ranges ``[lo, hi)`` of the quantization groups below ``pos``:
    group ``g`` runs from its start to the next one, the first from row 0,
    the last to ``pos``; empty ranges are kept (they add nothing)."""
    starts = [int(x) for x in (chunk_starts.tolist()
                               if isinstance(chunk_starts, torch.Tensor)
                               else chunk_starts)]
    edges = [0] + [min(max(x, 0), pos) for x in starts[1:]] + [pos]
    return list(zip(edges[:-1], edges[1:]))


def dots_probs(q, k_cache, k_cur, pos: int, k_scale):
    """The float32 softmax of the int8 x int8 scores, ``[B, H, pos + 1]``
    (the cache rows below ``pos``, then the current position), as
    ``int8_dots`` computes it; ``k_cache`` int8 (an int4 cache unpacked)."""
    rep = q.shape[1] // k_cache.shape[2]
    rp = lambda t, dim: t.repeat_interleave(rep, dim) if rep != 1 else t
    scale = q.shape[-1] ** -0.5
    q8, q_s = quantize_rows(q)                            # [B, H, hd], [B, H]
    kc = rp(k_cache[:, :pos].to(torch.int32), 2)          # [B, pos, H, hd]
    ks = rp(k_scale[:, :pos].float(), 2).transpose(1, 2)  # [B, H, pos]
    kcur = rp(k_cur.float(), 1)
    dots = (q8.to(torch.int32)[:, None] * kc).sum(-1).transpose(1, 2)
    scores = torch.cat(
        [dots.float() * (scale * q_s)[..., None] * ks,
         (q.float() * kcur).sum(-1, keepdim=True) * scale],
        dim=-1,
    )
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _plain_dots(q, k_cache, v_cache, k_cur, v_cur, pos: int, k_scale,
                v_scale, chunk_starts):
    """The JAX package's ``int8_dots`` einsums, in its order: integer
    products exact in int32, float32 elsewhere, the probabilities quantized
    per group (``group_bounds``)."""
    rep = q.shape[1] // k_cache.shape[2]
    rp = lambda t, dim: t.repeat_interleave(rep, dim) if rep != 1 else t
    vc = rp(v_cache[:, :pos].to(torch.int32), 2)          # [B, pos, H, hd]
    vs = rp(v_scale[:, :pos].float(), 2).transpose(1, 2)  # [B, H, pos]
    vcur = rp(v_cur.float(), 1)
    probs = dots_probs(q, k_cache, k_cur, pos, k_scale)
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for lo, hi in group_bounds(chunk_starts, pos):
        if hi <= lo:
            continue
        p8, p_s = quantize_rows(probs[..., lo:hi] * vs[..., lo:hi])
        acc = (p8.to(torch.int32)[..., None]
               * vc[:, lo:hi].transpose(1, 2)).sum(2)     # [B, H, hd]
        out = out + acc.float() * p_s[..., None]
    out = out + probs[..., pos:] * vcur
    return out.to(q.dtype)


def _check_pos(pos: Pos, S: int, device) -> None:
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int32:
            raise ValueError(f"decode_attention: a pos tensor must be int32, "
                             f"got {pos.dtype}")
        if pos.numel() != 1:
            raise ValueError(f"decode_attention: a pos tensor must hold one "
                             f"element, got {tuple(pos.shape)}")
        if pos.device != device:
            raise ValueError(f"decode_attention: the pos tensor must be on "
                             f"{device}, got {pos.device}")
    elif not 0 <= int(pos) <= S:
        raise ValueError(f"decode_attention: pos={pos} outside [0, {S}]")


def _check(q, k_cache, v_cache, k_cur, v_cur, pos: Pos, k_scale=None,
           v_scale=None, cache_bits: int = 8, int8_dots: bool = False,
           chunk_starts=None, form=None) -> dict:
    """Raises on any input outside the kernels' contract; returns the
    launch's ``kernel_plan``."""
    B, H, hd = q.shape
    _, S, Hkv, hd_c = k_cache.shape
    quant = k_scale is not None
    if cache_bits not in (8, 4):
        raise ValueError(f"decode_attention: cache_bits {cache_bits} not in "
                         "(8, 4)")
    if int8_dots and not quant:
        raise ValueError("decode_attention: int8_dots needs a quantized cache "
                         "(k_scale, v_scale)")
    cache_dtype = torch.int8 if quant else torch.bfloat16
    tensors = [("q", q, torch.bfloat16), ("k_cache", k_cache, cache_dtype),
               ("v_cache", v_cache, cache_dtype), ("k_cur", k_cur, torch.bfloat16),
               ("v_cur", v_cur, torch.bfloat16)]
    if quant or v_scale is not None:
        tensors += [("k_scale", k_scale, torch.float32),
                    ("v_scale", v_scale, torch.float32)]
    if int8_dots:
        tensors += [("chunk_starts", chunk_starts, torch.int32)]
    for name, t, dtype in tensors:
        if t is None:
            raise ValueError(f"decode_attention: {name} is missing")
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"decode_attention: {name} must be on {q.device}")
        if t.dtype != dtype:
            raise ValueError(f"decode_attention: {name} must be {dtype}, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    packed = quant and cache_bits == 4
    if hd not in _SUPPORTED_HD or hd_c != (hd // 2 if packed else hd):
        raise ValueError(f"decode_attention: head dim {hd} not in "
                         f"{_SUPPORTED_HD}, or a cache row of {hd_c} values")
    if v_cache.shape != k_cache.shape or k_cache.shape[0] != B:
        raise ValueError("decode_attention: cache shapes disagree")
    if quant and (k_scale.shape != (B, S, Hkv) or v_scale.shape != (B, S, Hkv)):
        raise ValueError("decode_attention: k_scale/v_scale must be "
                         "[B, S, H_kv]")
    if k_cur.shape != (B, Hkv, hd) or v_cur.shape != (B, Hkv, hd):
        raise ValueError("decode_attention: k_cur/v_cur must be [B, H_kv, hd]")
    if H % Hkv:
        raise ValueError(f"decode_attention: H={H} not a multiple of "
                         f"H_kv={Hkv}")
    _check_pos(pos, S, q.device)
    groups = 1
    if int8_dots:
        groups = chunk_starts.numel()
        if chunk_starts.dim() != 1:
            raise ValueError("decode_attention: chunk_starts must be 1-D")
        if not 1 <= groups <= MAX_GROUPS:
            raise ValueError(f"decode_attention: {groups} groups, the kernel "
                             f"takes 1 .. {MAX_GROUPS}")
    kind = ("dots" if int8_dots else "bf16" if not quant else
            f"int{cache_bits}")
    on_device = isinstance(pos, torch.Tensor)
    return kernel_plan(B, H, Hkv, S, hd, 0 if on_device else int(pos),
                       on_device, kind=kind, cache_bits=cache_bits,
                       groups=groups, form=form)


def decode_attention_cuda(q, k_cache, v_cache, k_cur, v_cur, pos: Pos,
                          k_scale=None, v_scale=None, *, cache_bits: int = 8,
                          int8_dots: bool = False, chunk_starts=None,
                          form=None):
    """Launch the kernel: its int8 or int4 instantiation when ``k_scale``
    and ``v_scale`` are given (``cache_bits``), the int8 x int8 kernel with
    ``int8_dots``, in the form ``launch_plan`` picks (``form``, or
    ``forced_form`` around the call, forces one: for checks); raises on any
    input outside its contract."""
    global launches, device_pos_launches, int8_launches, int4_launches
    global int8_dots_launches
    plan = _check(q, k_cache, v_cache, k_cur, v_cur, pos, k_scale, v_scale,
                  cache_bits, int8_dots, chunk_starts, form or _forced_form)
    B, H, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    on_device = isinstance(pos, torch.Tensor)
    quant = k_scale is not None
    out = torch.empty_like(q)
    lib = build.load("decode_attention", _SIG)
    tail = (FORMS.index(plan["form"]), 0 if on_device else int(pos),
            build.ptr(pos) if on_device else None, build.stream_ptr(q.device))
    if int8_dots:
        rc = lib.vt_decode_attention_dots(
            build.ptr(q), build.ptr(k_cache), build.ptr(v_cache),
            build.ptr(k_scale), build.ptr(v_scale), build.ptr(k_cur),
            build.ptr(v_cur), build.ptr(out), build.ptr(chunk_starts),
            chunk_starts.numel(), B, H, Hkv, S, hd, cache_bits, *tail)
    else:
        scales = (build.ptr(k_scale), build.ptr(v_scale)) if quant else ()
        fn = (lib.vt_decode_attention if not quant else
              lib.vt_decode_attention_int4 if cache_bits == 4 else
              lib.vt_decode_attention_int8)
        rc = fn(build.ptr(q), build.ptr(k_cache), build.ptr(v_cache), *scales,
                build.ptr(k_cur), build.ptr(v_cur), build.ptr(out), B, H, Hkv,
                S, hd, *tail)
    build.check(lib, rc, "decode_attention")
    launches += 1
    device_pos_launches += on_device
    int8_dots_launches += int8_dots
    int8_launches += quant and not int8_dots and cache_bits == 8
    int4_launches += quant and not int8_dots and cache_bits == 4
    form_launches[plan["form"]] += 1
    return out


def empty_launch(B: int, H: int, Hkv: int, S: int, hd: int, pos: int,
                 pos_on_device: bool, device, kind: str = "bf16",
                 groups: int = 1) -> None:
    """An empty kernel with the grid, cluster and shared memory
    ``decode_attention_cuda`` would launch for these sizes and this kind of
    cache (``bf16``, ``int8``, ``int4`` or ``dots``: the int8 x int8 kernel
    over ``groups`` groups of an int8 cache), in the plan's form: a
    yardstick for what one launch costs. Not counted as a launch of the
    kernel."""
    plan = kernel_plan(B, H, Hkv, S, hd, int(pos), pos_on_device, kind=kind,
                       groups=groups)
    lib = build.load("decode_attention", _SIG)
    rc = lib.vt_decode_attention_empty(B, H, Hkv, S, hd, int(pos),
                                       int(pos_on_device), _KINDS[kind],
                                       int(groups), FORMS.index(plan["form"]),
                                       build.stream_ptr(device))
    build.check(lib, rc, "decode_attention_empty")


def decode_attention(q, k_cache, v_cache, k_cur, v_cur, pos: Pos,
                     k_scale=None, v_scale=None, *, cache_bits: int = 8,
                     int8_dots: bool = False, chunk_starts=None):
    """Attention of position ``pos`` (an ``int`` or a one-element int32
    tensor on ``q``'s device) over the cache prefix and itself, over an int8
    (or, with ``cache_bits=4``, int4) cache when ``k_scale``/``v_scale`` are
    given, with the int8 x int8 products over ``chunk_starts``' groups when
    ``int8_dots``: the CUDA kernels for CUDA tensors, the plain version for
    CPU tensors."""
    kw = dict(cache_bits=cache_bits, int8_dots=int8_dots,
              chunk_starts=chunk_starts)
    if q.is_cuda:
        return decode_attention_cuda(q, k_cache, v_cache, k_cur, v_cur, pos,
                                     k_scale, v_scale, **kw)
    _check_pos(pos, k_cache.shape[1], q.device)
    if int8_dots and k_scale is None:
        raise ValueError("decode_attention: int8_dots needs a quantized cache "
                         "(k_scale, v_scale)")
    if int8_dots and chunk_starts is None:
        raise ValueError("decode_attention: int8_dots needs chunk_starts")
    return decode_attention_plain(q, k_cache, v_cache, k_cur, v_cur, pos,
                                  k_scale, v_scale, **kw)
