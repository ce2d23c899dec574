"""Decode attention over the KV cache for one step of one layer.

Counterpart of ``vaura_tpu/ops/pallas_attention.py``: the query of position
``pos`` attends over the cached positions ``< pos`` plus the current
position's ``k_cur``/``v_cur`` (not yet committed to the cache), with a
float32 softmax. On a CUDA tensor ``decode_attention`` launches the kernel
of ``csrc/decode_attention.cu`` once: the 64-row tiles of one (batch row, KV
head) are the blocks of a thread-block cluster, each fetched by bulk
asynchronous copies and serving every query head of the KV head; the blocks
send their partial softmaxes into the first block's shared memory, which
merges them, so there is no scratch tensor and no second launch. On a CPU
tensor it runs
``decode_attention_plain``, the same function in plain PyTorch.

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

Layouts (JAX's, kept at the public function):
  q, k_cur, v_cur  [B, H, hd] / [B, H_kv, hd]
  k_cache, v_cache [B, S, H_kv, hd]  (one layer of the [L, B, S, H_kv, hd]
                                      cache; stale at positions >= pos)
  k_scale, v_scale [B, S, H_kv]      (int8 cache only)
"""

from __future__ import annotations

import ctypes
from typing import Union

import torch

from vaura_tpu_torch.kernels import build

# launches of the CUDA kernel (one per call on a CUDA tensor), how many of
# them took ``pos`` from device memory and how many read int8 tiles
launches = 0
device_pos_launches = 0
int8_launches = 0

TILE = 64          # cache positions per block
MAX_CLUSTER = 8    # blocks of one cluster (the portable limit)
SMEM_LIMIT = 227 * 1024
_SUPPORTED_HD = (32, 64, 96, 128)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {
    "vt_decode_attention": [_P] * 6 + [_I] * 6 + [_P, _P],
    "vt_decode_attention_int8": [_P] * 8 + [_I] * 6 + [_P, _P],
    "vt_decode_attention_empty": [_I] * 8 + [_P],
}

Pos = Union[int, torch.Tensor]


def launch_plan(S: int, pos: int, pos_on_device: bool) -> dict:
    """The launch ``decode_attention`` makes: ``cluster`` blocks per (batch
    row, KV head), each walking ``tiles_per_block`` tiles of ``TILE`` rows
    at most, over the ``pos`` cached rows and the current one. With ``pos``
    on the device the plan covers ``S + 1`` rows."""
    tiles = (S if pos_on_device else pos) // TILE + 1
    cluster = min(tiles, MAX_CLUSTER)
    return {"tiles": tiles, "cluster": cluster,
            "tiles_per_block": -(-tiles // cluster)}


def tile_row_bytes(hd: int, int8: bool = False) -> int:
    """Bytes between two rows of a tile in shared memory: an odd multiple of
    32, so that the two lanes of a row read without bank conflicts (bf16
    rows padded by 32 bytes, int8 rows by 32 where ``hd / 32`` is even)."""
    if int8:
        return hd + (0 if (hd // 32) % 2 else 32)
    return 2 * hd + 32


def smem_bytes(hd: int, rep: int, cluster: int = MAX_CLUSTER,
               int8: bool = False) -> int:
    """Dynamic shared memory of one block: the K and V tiles (``TILE`` rows
    and the current position's, which is bf16 in an int8 tile too), two
    mbarriers and, per query head of the KV head (``rep`` of them), q, the
    four warps' partials of a tile, the block's running partial and rank 0's
    inbox of one partial per block of the cluster. Mirrors ``DecodeSmem`` in
    ``csrc/decode_attention.cu``."""
    partial = hd + 2
    floats = rep * (hd + 4 * partial + partial + 2 + cluster * partial)
    rb = tile_row_bytes(hd, int8)
    tile = TILE * rb + 2 * hd if int8 else (TILE + 1) * rb
    return 2 * tile + 16 + 4 * floats


def decode_attention_plain(q, k_cache, v_cache, k_cur, v_cur, pos: Pos,
                           k_scale=None, v_scale=None):
    """Dense reference: float32 scores over the positions ``< pos`` and the
    current one, one softmax, float32 value sum, cast to ``q.dtype``. A
    ``pos`` tensor is read back to the host and clamped as the kernel
    clamps it. With ``k_scale``/``v_scale`` the cache is int8 (see the
    module docstring)."""
    if isinstance(pos, torch.Tensor):
        pos = max(0, min(int(pos.item()), k_cache.shape[1]))
    if k_scale is not None:
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
           v_scale=None):
    B, H, hd = q.shape
    _, S, Hkv, hd_c = k_cache.shape
    int8 = k_scale is not None
    cache_dtype = torch.int8 if int8 else torch.bfloat16
    tensors = [("q", q, torch.bfloat16), ("k_cache", k_cache, cache_dtype),
               ("v_cache", v_cache, cache_dtype), ("k_cur", k_cur, torch.bfloat16),
               ("v_cur", v_cur, torch.bfloat16)]
    if int8 or v_scale is not None:
        tensors += [("k_scale", k_scale, torch.float32),
                    ("v_scale", v_scale, torch.float32)]
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
    if hd not in _SUPPORTED_HD or hd_c != hd:
        raise ValueError(f"decode_attention: head dim {hd} not in "
                         f"{_SUPPORTED_HD}")
    if v_cache.shape != k_cache.shape or k_cache.shape[0] != B:
        raise ValueError("decode_attention: cache shapes disagree")
    if int8 and (k_scale.shape != (B, S, Hkv) or v_scale.shape != (B, S, Hkv)):
        raise ValueError("decode_attention: k_scale/v_scale must be "
                         "[B, S, H_kv]")
    if k_cur.shape != (B, Hkv, hd) or v_cur.shape != (B, Hkv, hd):
        raise ValueError("decode_attention: k_cur/v_cur must be [B, H_kv, hd]")
    if H % Hkv:
        raise ValueError(f"decode_attention: H={H} not a multiple of "
                         f"H_kv={Hkv}")
    _check_pos(pos, S, q.device)
    plan = launch_plan(S, 0 if isinstance(pos, torch.Tensor) else int(pos),
                       isinstance(pos, torch.Tensor))
    if smem_bytes(hd, H // Hkv, plan["cluster"], int8) > SMEM_LIMIT:
        raise ValueError(
            f"decode_attention: {H // Hkv} query heads per KV head of dim "
            f"{hd} over a cluster of {plan['cluster']} blocks do not fit a "
            "block's shared memory")


def decode_attention_cuda(q, k_cache, v_cache, k_cur, v_cur, pos: Pos,
                          k_scale=None, v_scale=None):
    """Launch the kernel (its int8 instantiation when ``k_scale`` and
    ``v_scale`` are given); raises on any input outside its contract."""
    global launches, device_pos_launches, int8_launches
    _check(q, k_cache, v_cache, k_cur, v_cur, pos, k_scale, v_scale)
    B, H, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    on_device = isinstance(pos, torch.Tensor)
    int8 = k_scale is not None
    out = torch.empty_like(q)
    lib = build.load("decode_attention", _SIG)
    scales = (build.ptr(k_scale), build.ptr(v_scale)) if int8 else ()
    fn = lib.vt_decode_attention_int8 if int8 else lib.vt_decode_attention
    rc = fn(
        build.ptr(q), build.ptr(k_cache), build.ptr(v_cache), *scales,
        build.ptr(k_cur), build.ptr(v_cur), build.ptr(out), B, H, Hkv, S, hd,
        0 if on_device else int(pos), build.ptr(pos) if on_device else None,
        build.stream_ptr(q.device),
    )
    build.check(lib, rc, "decode_attention")
    launches += 1
    device_pos_launches += on_device
    int8_launches += int8
    return out


def empty_launch(B: int, H: int, Hkv: int, S: int, hd: int, pos: int,
                 pos_on_device: bool, device, int8: bool = False) -> None:
    """An empty kernel with the grid, cluster and shared memory
    ``decode_attention_cuda`` would launch for these sizes: a yardstick for
    what one launch costs. Not counted as a launch of the kernel."""
    lib = build.load("decode_attention", _SIG)
    rc = lib.vt_decode_attention_empty(B, H, Hkv, S, hd, int(pos),
                                       int(pos_on_device), int(int8),
                                       build.stream_ptr(device))
    build.check(lib, rc, "decode_attention_empty")


def decode_attention(q, k_cache, v_cache, k_cur, v_cur, pos: Pos,
                     k_scale=None, v_scale=None):
    """Attention of position ``pos`` (an ``int`` or a one-element int32
    tensor on ``q``'s device) over the cache prefix and itself, over an int8
    cache when ``k_scale``/``v_scale`` are given: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if q.is_cuda:
        return decode_attention_cuda(q, k_cache, v_cache, k_cur, v_cur, pos,
                                     k_scale, v_scale)
    _check_pos(pos, k_cache.shape[1], q.device)
    return decode_attention_plain(q, k_cache, v_cache, k_cur, v_cur, pos,
                                  k_scale, v_scale)
