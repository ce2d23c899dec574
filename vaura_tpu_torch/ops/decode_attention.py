"""Decode attention over the KV cache for one step of one layer.

Counterpart of ``vaura_tpu/ops/pallas_attention.py``: the query of position
``pos`` attends over the cached positions ``< pos`` plus the current
position's ``k_cur``/``v_cur`` (not yet committed to the cache), with a
float32 softmax. On a CUDA tensor ``decode_attention`` launches the
split-K kernel of ``csrc/decode_attention.cu``; on a CPU tensor it runs
``decode_attention_plain``, the same function in plain PyTorch.

Layouts (JAX's, kept at the public function):
  q, k_cur, v_cur  [B, H, hd] / [B, H_kv, hd]
  k_cache, v_cache [B, S, H_kv, hd]  (one layer of the [L, B, S, H_kv, hd]
                                      cache; stale at positions >= pos)
"""

from __future__ import annotations

import ctypes

import torch

from vaura_tpu_torch.kernels import build

# launches of the CUDA kernel (one per call on a CUDA tensor)
launches = 0

TILE = 64
_SUPPORTED_HD = (32, 64, 96, 128)
_SIG = {
    "vt_decode_attention": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
}


def decode_attention_plain(q, k_cache, v_cache, k_cur, v_cur, pos: int):
    """Dense reference: float32 scores over the positions ``< pos`` and the
    current one, one softmax, float32 value sum, cast to ``q.dtype``."""
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


def _check(q, k_cache, v_cache, k_cur, v_cur, pos: int):
    B, H, hd = q.shape
    _, S, Hkv, hd_c = k_cache.shape
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("k_cur", k_cur), ("v_cur", v_cur)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"decode_attention: {name} must be on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"decode_attention: {name} must be bfloat16, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    if hd not in _SUPPORTED_HD or hd_c != hd:
        raise ValueError(f"decode_attention: head dim {hd} not in "
                         f"{_SUPPORTED_HD}")
    if v_cache.shape != k_cache.shape or k_cache.shape[0] != B:
        raise ValueError("decode_attention: cache shapes disagree")
    if k_cur.shape != (B, Hkv, hd) or v_cur.shape != (B, Hkv, hd):
        raise ValueError("decode_attention: k_cur/v_cur must be [B, H_kv, hd]")
    if H % Hkv:
        raise ValueError(f"decode_attention: H={H} not a multiple of "
                         f"H_kv={Hkv}")
    if not 0 <= pos <= S:
        raise ValueError(f"decode_attention: pos={pos} outside [0, {S}]")


def decode_attention_cuda(q, k_cache, v_cache, k_cur, v_cur, pos: int):
    """Launch the kernel; raises on any input outside its contract."""
    global launches
    pos = int(pos)
    _check(q, k_cache, v_cache, k_cur, v_cur, pos)
    B, H, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    n_split = -(-pos // TILE)
    part = torch.empty(max(B * H * n_split * (hd + 2), 1), dtype=torch.float32,
                       device=q.device)
    out = torch.empty_like(q)
    lib = build.load("decode_attention", _SIG)
    rc = lib.vt_decode_attention(
        build.ptr(q), build.ptr(k_cache), build.ptr(v_cache), build.ptr(k_cur),
        build.ptr(v_cur), build.ptr(part), build.ptr(out),
        B, H, Hkv, S, hd, pos, build.stream_ptr(q.device),
    )
    build.check(lib, rc, "decode_attention")
    launches += 1
    return out


def decode_attention(q, k_cache, v_cache, k_cur, v_cur, pos: int):
    """Attention of position ``pos`` over the cache prefix and itself:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.is_cuda:
        return decode_attention_cuda(q, k_cache, v_cache, k_cur, v_cur, pos)
    return decode_attention_plain(q, k_cache, v_cache, k_cur, v_cur, pos)
