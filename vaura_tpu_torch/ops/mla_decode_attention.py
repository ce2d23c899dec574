"""Absorbed multi-head latent attention at one decode position: every head
of a row against that row's cache of latent rows.

DeepSeek-V3's latent attention (``models/sampler.py::LatentAttention``) in
its absorbed form: the query of each head is moved into the latent space
(``q_lat = q_nope W_uk``, 512 wide, beside its 64-wide ``q_pe``), every
head scores the same cached ``[c; k_pe]`` rows (576 values a row) and
averages the same ``c`` rows, so a row's heads share one read of its cache:

    s_t = (q_lat . c_t + q_pe . k_pe_t) * scale      t < pos, and the new row
    out = softmax(s) @ [c_0 .. c_{pos-1}; c_new]     [B, H, R] float32

No TPU kernel of the JAX package computes this (it has no latent attention);
``ops/decode_attention.py`` takes heads of 32 to 128 with keys and values of
one width, and reads a K and a V row per KV head. Bound on the card: the
cache's bytes (576 bf16 values a cached row and layer), since each row's
16 heads make 16 x 1,088 operations of a 1,152-byte row (about 15 a byte,
far under the H100's ~295). Design: one Triton program a batch row holds
its 16 heads' queries (``[16, 512]`` and ``[16, 64]``), walks the rows
below ``pos`` in tiles of ``BLOCK_S`` (each tile read once, for every head)
with an online softmax in float32, scores and the value product on the
tensor cores (``tl.dot``: 16 heads are the rows of the products, the
probabilities cast to bf16 for the second, as the value products of the
port's other decode kernels), then adds the new row. ``pos`` is read from
device memory, so one launch serves every step of a recorded CUDA graph.

``mla_decode_attention_plain`` is the same function in plain PyTorch (the
CPU's path, and the card's check); the wrapper takes it only for CPU
tensors. ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import functools
from typing import Union

import torch

launches = 0

BLOCK_S = 32


def _check(q, c_cache, pe_cache, c_new, pe_new):
    B, H, W = q.shape
    Bc, S, R = c_cache.shape
    r = pe_cache.shape[-1]
    if (Bc != B or pe_cache.shape != (B, S, r) or W != R + r
            or c_new.shape != (B, R) or pe_new.shape != (B, r)):
        raise ValueError(
            f"mla_decode_attention: q {tuple(q.shape)}, c_cache "
            f"{tuple(c_cache.shape)}, pe_cache {tuple(pe_cache.shape)}, c_new "
            f"{tuple(c_new.shape)}, pe_new {tuple(pe_new.shape)}: want q [B, "
            "H, R + r], caches [B, S, R] and [B, S, r], new rows [B, R], "
            "[B, r]")


def mla_decode_attention(q: torch.Tensor, c_cache: torch.Tensor,
                         pe_cache: torch.Tensor, c_new: torch.Tensor,
                         pe_new: torch.Tensor, pos: Union[int, torch.Tensor],
                         scale: float) -> torch.Tensor:
    """``q [B, H, R + r]`` (``q_lat`` then ``q_pe``), the cache ``c_cache
    [B, S, R]``, ``pe_cache [B, S, r]`` read below ``pos`` (an ``int`` or a
    one-element int32 tensor on the device), this position's ``c_new [B,
    R]`` and ``pe_new [B, r]``. Returns ``[B, H, R]`` float32."""
    _check(q, c_cache, pe_cache, c_new, pe_new)
    if not q.is_cuda:
        return mla_decode_attention_plain(q, c_cache, pe_cache, c_new, pe_new,
                                          pos, scale)
    return _launch(q, c_cache, pe_cache, c_new, pe_new, pos, scale)


def mla_decode_attention_plain(q, c_cache, pe_cache, c_new, pe_new, pos,
                               scale: float) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: float32 scores and softmax,
    the cached rows' probabilities (before the normalisation) in the cache's
    dtype for the value product (bf16 on the card), the new row's in
    float32."""
    B, S, R = c_cache.shape
    qf = q.float()
    lat = torch.cat([c_cache, pe_cache], dim=-1).float()
    new = torch.cat([c_new, pe_new], dim=-1).float()
    s = torch.einsum("bhc,bsc->bhs", qf, lat) * scale
    s_new = torch.einsum("bhc,bc->bh", qf, new) * scale
    pos = torch.as_tensor(pos, device=q.device).reshape(-1)[:1]
    below = torch.arange(S, device=q.device) < pos
    s = torch.where(below, s, float("-inf"))
    m = torch.maximum(s.amax(-1), s_new)
    p = torch.exp(s - m[..., None])
    p_new = torch.exp(s_new - m)
    out = (torch.einsum("bhs,bsc->bhc", p.to(c_cache.dtype).float(),
                        c_cache.float())
           + p_new[..., None] * c_new.float()[:, None])
    return out / (p.sum(-1) + p_new)[..., None]


@functools.lru_cache(maxsize=None)
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def mla_decode_kernel(Q, C, PE, CN, PN, POS, OUT, scale,
                          s_qb, s_qh, s_cb, s_cs, s_pb, s_ps, s_nb, s_mb,
                          s_ob, s_oh,
                          H: tl.constexpr, R: tl.constexpr, RP: tl.constexpr,
                          BLOCK: tl.constexpr):
        b = tl.program_id(0).to(tl.int64)
        pos = tl.load(POS)
        h = tl.arange(0, H)
        c = tl.arange(0, R)
        p = tl.arange(0, RP)
        q_lat = tl.load(Q + b * s_qb + h[:, None] * s_qh + c[None, :])
        q_pe = tl.load(Q + b * s_qb + h[:, None] * s_qh + R + p[None, :])
        m = tl.full([H], float("-inf"), tl.float32)
        l = tl.zeros([H], tl.float32)
        acc = tl.zeros([H, R], tl.float32)
        for start in range(0, pos, BLOCK):
            t = start + tl.arange(0, BLOCK)
            live = t < pos
            cb = tl.load(C + b * s_cb + t[:, None] * s_cs + c[None, :],
                         mask=live[:, None], other=0.0)
            pb = tl.load(PE + b * s_pb + t[:, None] * s_ps + p[None, :],
                         mask=live[:, None], other=0.0)
            s = (tl.dot(q_lat, tl.trans(cb)) + tl.dot(q_pe, tl.trans(pb))) * scale
            s = tl.where(live[None, :], s, float("-inf"))
            m_new = tl.maximum(m, tl.max(s, 1))
            alpha = tl.exp(m - m_new)
            pr = tl.exp(s - m_new[:, None])
            l = l * alpha + tl.sum(pr, 1)
            acc = acc * alpha[:, None] + tl.dot(pr.to(tl.bfloat16), cb)
            m = m_new
        cn = tl.load(CN + b * s_nb + c).to(tl.float32)
        pn = tl.load(PN + b * s_mb + p).to(tl.float32)
        s_new = (tl.sum(q_lat.to(tl.float32) * cn[None, :], 1)
                 + tl.sum(q_pe.to(tl.float32) * pn[None, :], 1)) * scale
        m_new = tl.maximum(m, s_new)
        alpha = tl.exp(m - m_new)
        p_new = tl.exp(s_new - m_new)
        l = l * alpha + p_new
        acc = acc * alpha[:, None] + p_new[:, None] * cn[None, :]
        tl.store(OUT + b * s_ob + h[:, None] * s_oh + c[None, :],
                 acc / l[:, None])

    return mla_decode_kernel


def _launch(q, c_cache, pe_cache, c_new, pe_new, pos, scale):
    global launches
    for name, t in (("q", q), ("c_cache", c_cache), ("pe_cache", pe_cache),
                    ("c_new", c_new), ("pe_new", pe_new)):
        if t.dtype != torch.bfloat16 or t.stride(-1) != 1:
            raise ValueError(f"mla_decode_attention: {name} must be bf16 with "
                             f"unit last stride, got {t.dtype}, {t.stride()}")
    B, H, _ = q.shape
    R, r = c_cache.shape[-1], pe_cache.shape[-1]
    if any(n < 16 or n & (n - 1) for n in (H, R, r)):
        raise ValueError(f"mla_decode_attention: heads {H}, latent {R} and "
                         f"rope {r} must be powers of two from 16 (the tiles "
                         "of the kernel's products)")
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((1,), int(pos), dtype=torch.int32, device=q.device)
    if pos.dtype != torch.int32 or pos.device != q.device:
        raise ValueError("mla_decode_attention: pos must be an int32 tensor "
                         "on q's device")
    out = torch.empty(B, H, R, dtype=torch.float32, device=q.device)
    _kernel()[(B,)](
        q, c_cache, pe_cache, c_new, pe_new, pos, out, float(scale),
        q.stride(0), q.stride(1), c_cache.stride(0), c_cache.stride(1),
        pe_cache.stride(0), pe_cache.stride(1), c_new.stride(0),
        pe_new.stride(0), out.stride(0), out.stride(1),
        H=H, R=R, RP=r, BLOCK=BLOCK_S, num_warps=4, num_stages=2)
    launches += 1
    return out
