"""Fused divided-attention and MLP sublayers of the MotionFormer encoder.

Counterpart of ``vaura_tpu/ops/encoder_fused.py``:

  fused_attention_sublayer  y = x + proj(divided_attention(LN(x)))
  fused_mlp_sublayer        y = x + fc2(gelu_exact(fc1(LN(x))))

Tokens are group-major (``x_tok [B', G*L, D]``, each group's L rows
contiguous) and the CLS row is carried apart (``x_cls [B', 1, D]``). Every
token group attends within itself plus the CLS key/value; the CLS query
attends over all rows.

On CUDA tensors the attention sublayer launches the three kernels of
``csrc/encoder_attention.cu``: layer norm of the token rows (once per row,
not once per head, rounded to the compute dtype as the plain version rounds
it), group attention (one block per pack, head and batch row: normalised
rows and the head's weights arrive by ``cp.async`` in a three-stage
shared-memory ring, the q/k/v product runs as ``wgmma`` from that ring, the
attention of every group length on the tensor cores with each query masked
to its own group and the CLS column, then the CLS partials), and the
projection GEMM with bias and residual (``wgmma`` from a four-stage
``cp.async`` ring). ``attention_plan`` says how a shape is cut into packs
and blocks. The MLP sublayer (``csrc/encoder_mlp.cu``) launches the same
layer norm, then fc1 as that GEMM with bias and the exact GELU in its
epilogue and fc2 as that GEMM with bias and residual; the hidden activation
lies in a scratch tensor between the two (``mlp_plan``). The layer norm and
the GEMM are ``csrc/gemm.cuh``, the group attention ``csrc/group_attention.cuh``.
On CPU tensors the ``*_plain`` functions compute the same arithmetic in
plain PyTorch: bf16 operands, float32 products and
softmax, the same roundings to the compute dtype. The CLS row's q/k/v, the
flash merge of the per-pack CLS partials and the CLS projection are plain
PyTorch on both devices, as the JAX package keeps them outside Pallas.

Weights take torch's ``nn.Linear`` layout: ``wqkv [3D, D]`` (q | k | v
rows), ``wproj [D, D]``, ``w1 [Dh, D]``, ``w2 [D, Dh]``; biases and LN
parameters are float32.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from vaura_tpu_torch.kernels import build

# calls of the CUDA paths: one per sublayer call on CUDA tensors. A call of
# the attention sublayer makes ATTENTION_LAUNCHES_PER_CALL launches (layer
# norm, group attention, projection), a call of the MLP sublayer
# MLP_LAUNCHES_PER_CALL (layer norm, fc1, fc2)
attention_launches = 0
mlp_launches = 0

MAX_PACK_ROWS = 256  # rows of one pack in the group-attention kernel
KERNEL_HEAD_DIM = 64
ATTENTION_LAUNCHES_PER_CALL = 3
MLP_LAUNCHES_PER_CALL = 3
RING_STAGES = 3      # k-slabs in flight in the group-attention kernel
SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may use on Hopper
SM_COUNT = 132       # streaming multiprocessors of an H100 SXM
# the GEMM of csrc/gemm.cuh: a 128 x 192 tile a block, K in slabs of 64
# through a four-stage ring
GEMM_ROW_TILE, GEMM_COL_TILE, GEMM_K_SLAB, GEMM_STAGES = 128, 192, 64, 4
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ATTN_SIG = {
    "vt_layernorm_rows": [_P] * 4 + [_I, _I, _F, _P],
    "vt_group_attention": [_P] * 10 + [_I] * 6 + [_P],
    "vt_proj_residual": [_P] * 5 + [_I] * 3 + [_P],
}
_MLP_SIG = {"vt_encoder_mlp": [_P] * 10 + [_I] * 3 + [_F, _I, _P]}
MLP_PARTS = {"layernorm": 1, "fc1": 2, "fc2": 4}  # bits of ``parts``


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    """Float32 layer norm in the ``E[x^2] - mean^2`` form of the JAX
    package; returns float32."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    return (xf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def pack_rows(L: int) -> int:
    """Rows per pack of whole groups: as many groups as fit the
    ``MAX_PACK_ROWS`` rows one block of the kernel computes (time axis L=8
    -> 256 rows, space axis L=196 -> 196)."""
    return L * max(1, MAX_PACK_ROWS // L)


def attention_plan(N: int, L: int, rows_per_pack: Optional[int] = None) -> dict:
    """How the group-attention kernel cuts ``N`` rows in groups of ``L``:
    packs and the rows of the last one, the rows the tensor cores compute
    per block (4 warpgroups of 64), the 16-row query tiles of a full pack,
    and the block's dynamic shared memory: a ring of ``RING_STAGES`` k-slabs
    (64 columns: 128-byte rows) of the padded rows and of a head's 192 weight
    rows, over which q, k and v (144-byte rows, 16 rows of overhang) are laid
    afterwards, plus the CLS key/value tile and the CLS partial's scratch. Mirrors ``GroupSmem`` in
    ``csrc/encoder_attention.cu``."""
    rows = pack_rows(L) if rows_per_pack is None else rows_per_pack
    if N % L or rows % L or not 0 < rows <= MAX_PACK_ROWS:
        raise ValueError(f"attention_plan: N={N}, L={L}, pack rows {rows}")
    n_packs = -(-N // rows)
    padded, hd = MAX_PACK_ROWS, KERNEL_HEAD_DIM
    ring = RING_STAGES * (padded * 128 + 3 * hd * 128)
    qkv = 3 * (padded + 16) * (hd + 8) * 2
    small = 2 * 16 * (hd + 8) * 2 + 2 * 4 * padded + 4 * (padded * 2 // hd) * hd
    smem = -(-ring // 1024) * 1024 + small + 1024
    if qkv > ring or smem > SMEM_LIMIT:
        raise ValueError("attention_plan: the block's shared memory is over")
    return {
        "rows_per_pack": rows, "n_packs": n_packs,
        "last_pack_rows": N - (n_packs - 1) * rows,
        "padded_rows": padded, "query_tiles": -(-min(rows, N) // 16),
        "ring_bytes": ring, "qkv_bytes": qkv, "smem_bytes": smem,
    }


def _bf(w: torch.Tensor, dtype) -> torch.Tensor:
    return w if w.dtype == dtype else w.to(dtype)


def _f32(b: Optional[torch.Tensor], n: int, like: torch.Tensor) -> torch.Tensor:
    if b is None:
        return torch.zeros(n, dtype=torch.float32, device=like.device)
    return b.float().contiguous()


# --------------------------------------------------------------------------
# attention sublayer
# --------------------------------------------------------------------------
def group_attention_plain(x_tok, ln_scale, ln_bias, wqkv, bqkv, cls_q, cls_k,
                          cls_v, *, num_heads: int, L: int, eps: float,
                          rows_per_pack: int):
    """Plain version of launch (a): LN, q/k/v, group attention with the CLS
    column. Returns the attention output ``[B', N, D]`` (compute dtype) and
    the CLS query's per-pack flash partials ``m, l [B', n_packs, H]`` and
    ``acc [B', n_packs, H, hd]`` (float32)."""
    Bp, N, D = x_tok.shape
    H, cdt = num_heads, x_tok.dtype
    hd, G = D // H, N // L
    ln = layernorm(x_tok, ln_scale, ln_bias, eps).to(cdt)
    qkv = ln.float() @ wqkv.float().t() + bqkv
    q = (qkv[..., :D] * hd ** -0.5).to(cdt).float()
    k = qkv[..., D:2 * D].to(cdt).float()
    v = qkv[..., 2 * D:].to(cdt).float()
    cq, ck, cv = (t.float().reshape(Bp, H, hd) for t in (cls_q, cls_k, cls_v))

    qg, kg, vg = (t.reshape(Bp, G, L, H, hd) for t in (q, k, v))
    s = torch.einsum("bglhd,bgmhd->bghlm", qg, kg)
    sc = torch.einsum("bglhd,bhd->bghl", qg, ck)[..., None]
    full = torch.cat([sc, s], dim=-1)
    p = torch.exp(full - full.amax(-1, keepdim=True))
    den = p.sum(-1, keepdim=True)
    o = torch.einsum("bghlm,bgmhd->bglhd", p[..., 1:], vg)
    o = o + p[..., 0].permute(0, 1, 3, 2)[..., None] * cv[:, None, None]
    o = o / den.permute(0, 1, 3, 2, 4)
    attn = o.reshape(Bp, N, D).to(cdt)

    n_packs = -(-N // rows_per_pack)
    pad = n_packs * rows_per_pack - N
    kh, vh = k.reshape(Bp, N, H, hd), v.reshape(Bp, N, H, hd)
    sct = torch.einsum("bnhd,bhd->bnh", kh, cq)
    if pad:
        sct = torch.cat([sct, sct.new_full((Bp, pad, H), float("-inf"))], 1)
        vh = torch.cat([vh, vh.new_zeros((Bp, pad, H, hd))], 1)
    sct = sct.reshape(Bp, n_packs, rows_per_pack, H)
    m = sct.amax(2)
    e = torch.exp(sct - m[:, :, None])
    l = e.sum(2)
    acc = torch.einsum("bprh,bprhd->bphd", e,
                       vh.reshape(Bp, n_packs, rows_per_pack, H, hd))
    return attn, m, l, acc


def proj_residual_plain(attn, wproj, bproj, x_tok):
    """Plain version of launch (b): ``x + attn @ wproj^T + bproj``."""
    y = x_tok.float() + bproj + attn.float() @ wproj.float().t()
    return y.to(x_tok.dtype)


def _attention_cuda(x_tok, ln_scale, ln_bias, wqkv, bqkv, cls_q, cls_k, cls_v,
                    wproj, bproj, *, num_heads, L, eps, rows_per_pack):
    global attention_launches
    Bp, N, D = x_tok.shape
    if D != num_heads * KERNEL_HEAD_DIM:
        raise ValueError(f"fused_attention_sublayer: the CUDA kernel takes "
                         f"head dim {KERNEL_HEAD_DIM}, got D={D}, "
                         f"H={num_heads}")
    if L > MAX_PACK_ROWS or N % L:
        raise ValueError(f"fused_attention_sublayer: group length {L} must "
                         f"divide N={N} and be <= {MAX_PACK_ROWS}")
    if x_tok.dtype != torch.bfloat16:
        raise ValueError("fused_attention_sublayer: the CUDA kernel takes "
                         f"bfloat16 tokens, got {x_tok.dtype}")
    x_tok = x_tok.contiguous()
    n_packs = -(-N // rows_per_pack)
    dev = x_tok.device
    attn = torch.empty_like(x_tok)
    x_ln = torch.empty_like(x_tok)
    part_m = torch.empty((Bp, n_packs, num_heads), dtype=torch.float32,
                         device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((Bp, n_packs, num_heads, KERNEL_HEAD_DIM),
                           dtype=torch.float32, device=dev)
    cq, ck, cv = (t.reshape(Bp, D).contiguous() for t in (cls_q, cls_k, cls_v))
    lib = build.load("encoder_attention", _ATTN_SIG)
    stream = build.stream_ptr(dev)
    rc = lib.vt_layernorm_rows(build.ptr(x_tok), build.ptr(ln_scale),
                               build.ptr(ln_bias), build.ptr(x_ln), Bp * N, D,
                               float(eps), stream)
    build.check(lib, rc, "layernorm_rows")
    rc = lib.vt_group_attention(
        build.ptr(x_ln), build.ptr(wqkv), build.ptr(bqkv), build.ptr(cq),
        build.ptr(ck), build.ptr(cv), build.ptr(attn), build.ptr(part_m),
        build.ptr(part_l), build.ptr(part_acc), Bp, N, D, num_heads, L,
        rows_per_pack, stream,
    )
    build.check(lib, rc, "group_attention")
    y_tok = torch.empty_like(x_tok)
    rc = lib.vt_proj_residual(
        build.ptr(attn), build.ptr(wproj), build.ptr(bproj), build.ptr(x_tok),
        build.ptr(y_tok), Bp * N, D, D, stream,
    )
    build.check(lib, rc, "proj_residual")
    attention_launches += 1
    return y_tok, part_m, part_l, part_acc


def cls_merge(cls_q, cls_k, cls_v, m, l, acc, num_heads: int) -> torch.Tensor:
    """Exact flash merge of the per-pack CLS partials with the CLS
    self-term; returns the CLS attention output ``[B', D]`` (float32)."""
    Bp = cls_q.shape[0]
    cq, ck, cv = (t.float().reshape(Bp, num_heads, -1)
                  for t in (cls_q, cls_k, cls_v))
    s_self = (cq * ck).sum(-1)  # [B', H]
    m_tot = torch.maximum(m.amax(1), s_self)
    w = torch.exp(m - m_tot[:, None])  # [B', n_packs, H]
    w_self = torch.exp(s_self - m_tot)
    l_tot = (l * w).sum(1) + w_self
    a_tot = (acc * w[..., None]).sum(1) + w_self[..., None] * cv
    return (a_tot / l_tot[..., None]).reshape(Bp, -1)


def _attention_sublayer(x_tok, x_cls, ln_scale, ln_bias, wqkv, bqkv, wproj,
                        bproj, *, num_heads: int, L: int, eps: float,
                        use_kernel: bool):
    Bp, N, D = x_tok.shape
    if N % L:
        raise ValueError(f"tokens {N} not divisible by group length {L}")
    cdt = x_tok.dtype
    hd = D // num_heads
    wqkv, wproj = _bf(wqkv, cdt).contiguous(), _bf(wproj, cdt).contiguous()
    bqkv = _f32(bqkv, 3 * D, x_tok)
    bproj = _f32(bproj, D, x_tok)
    ln_scale, ln_bias = ln_scale.float().contiguous(), ln_bias.float().contiguous()

    # the CLS row's q/k/v (one row per segment-batch)
    ln_cls = layernorm(x_cls, ln_scale, ln_bias, eps).to(cdt)[:, 0]
    cls_qkv = (ln_cls @ wqkv.t()).float() + bqkv
    cls_q = (cls_qkv[:, :D] * hd ** -0.5).to(cdt)
    cls_k = cls_qkv[:, D:2 * D].to(cdt)
    cls_v = cls_qkv[:, 2 * D:].to(cdt)

    rows = pack_rows(L)
    if use_kernel:
        y_tok, m, l, acc = _attention_cuda(
            x_tok, ln_scale, ln_bias, wqkv, bqkv, cls_q, cls_k, cls_v, wproj,
            bproj, num_heads=num_heads, L=L, eps=eps, rows_per_pack=rows)
    else:
        attn, m, l, acc = group_attention_plain(
            x_tok, ln_scale, ln_bias, wqkv, bqkv, cls_q, cls_k, cls_v,
            num_heads=num_heads, L=L, eps=eps, rows_per_pack=rows)
        y_tok = proj_residual_plain(attn, wproj, bproj, x_tok)

    cls_attn = cls_merge(cls_q, cls_k, cls_v, m, l, acc, num_heads).to(cdt)
    y_cls = (x_cls.float() + (cls_attn @ wproj.t()).float()[:, None]
             + bproj).to(cdt)
    return y_tok, y_cls


def fused_attention_sublayer(
    x_tok: torch.Tensor,       # [B', G*L, D] group-major
    x_cls: torch.Tensor,       # [B', 1, D]
    ln_scale: torch.Tensor,    # [D]
    ln_bias: torch.Tensor,     # [D]
    wqkv: torch.Tensor,        # [3D, D]
    bqkv: Optional[torch.Tensor],   # [3D] or None
    wproj: torch.Tensor,       # [D, D]
    bproj: Optional[torch.Tensor],  # [D] or None
    *,
    num_heads: int,
    L: int,
    eps: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One divided-attention sublayer: returns
    ``(x_tok + proj(attn), x_cls + proj(cls_attn))``; the CUDA kernels for
    CUDA tensors, the plain version for CPU tensors."""
    return _attention_sublayer(
        x_tok, x_cls, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
        num_heads=num_heads, L=L, eps=eps, use_kernel=x_tok.is_cuda)


def fused_attention_sublayer_plain(x_tok, x_cls, ln_scale, ln_bias, wqkv,
                                   bqkv, wproj, bproj, *, num_heads: int,
                                   L: int, eps: float):
    """The plain PyTorch version on any device (the kernels' yardstick)."""
    return _attention_sublayer(
        x_tok, x_cls, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
        num_heads=num_heads, L=L, eps=eps, use_kernel=False)


# --------------------------------------------------------------------------
# MLP sublayer
# --------------------------------------------------------------------------
def _mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, *, eps: float):
    cdt = x.dtype
    ln = layernorm(x, ln_scale, ln_bias, eps).to(cdt)
    h = torch.nn.functional.gelu(ln.float() @ w1.float().t() + b1)
    h = h.to(cdt)
    return (x.float() + b2 + h.float() @ w2.float().t()).to(cdt)


def mlp_plan(M: int, D: int, Dh: int) -> dict:
    """How the MLP sublayer's three launches cut ``M`` rows of width ``D``
    and hidden width ``Dh``: the layer norm, then fc1 (a grid of ``Dh / 192``
    by ``M / 128`` blocks, a tile each) and fc2 (``D / 192`` by ``M / 128``)
    over a hidden scratch of ``M x Dh``. Waves count a launch's blocks over
    the card's 132 SMs, rounded up. Shared memory is the GEMM's ring of four
    k-slabs (128 + 192 rows of 128 bytes), the residual tile for fc2, and the
    alignment slack. Mirrors ``vt_encoder_mlp`` in ``csrc/encoder_mlp.cu``
    and ``launch_gemm_bias`` in ``csrc/gemm.cuh``."""
    if M <= 0 or D <= 0 or Dh <= 0 or D % GEMM_K_SLAB or Dh % GEMM_K_SLAB:
        raise ValueError(f"mlp_plan: the CUDA kernels take M > 0 and D, hidden "
                         f"multiples of {GEMM_K_SLAB}, got M={M}, D={D}, "
                         f"hidden={Dh}")
    tiles = -(-M // GEMM_ROW_TILE)
    blocks1 = -(-Dh // GEMM_COL_TILE) * tiles
    blocks2 = -(-D // GEMM_COL_TILE) * tiles
    ring = GEMM_STAGES * (GEMM_ROW_TILE + GEMM_COL_TILE) * 2 * GEMM_K_SLAB
    return {
        "row_tile": GEMM_ROW_TILE, "col_tile": GEMM_COL_TILE,
        "launches": MLP_LAUNCHES_PER_CALL,
        "fc1_blocks": blocks1, "fc2_blocks": blocks2,
        "fc1_waves": -(-blocks1 // SM_COUNT),
        "fc2_waves": -(-blocks2 // SM_COUNT),
        "fc1_smem_bytes": ring + 1024,
        "fc2_smem_bytes": ring + GEMM_ROW_TILE * GEMM_COL_TILE * 2 + 1024,
        "scratch_bytes": 2 * M * (D + Dh),
    }


def _mlp_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2, *, eps: float,
              parts: int = 7, scratch=None):
    """Launch the sublayer's kernels; raises on any input outside their
    contract. ``parts`` and ``scratch`` (the ``(x_ln, hidden, y)`` of an
    earlier full call) let a measurement run one kind of launch alone."""
    global mlp_launches
    Bp, N, D = x.shape
    Dh = w1.shape[0]
    mlp_plan(Bp * N, D, Dh)  # raises on widths the kernels do not take
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_mlp_sublayer: the CUDA kernel takes "
                         f"bfloat16, got {x.dtype}")
    if not x.is_cuda:
        raise ValueError("fused_mlp_sublayer: the CUDA kernel takes tensors "
                         f"on the card, got {x.device}")
    x = x.contiguous()
    if scratch is None:
        scratch = (torch.empty_like(x),
                   torch.empty((Bp * N, Dh), dtype=x.dtype, device=x.device),
                   torch.empty_like(x))
    x_ln, hidden, y = scratch
    lib = build.load("encoder_mlp", _MLP_SIG)
    rc = lib.vt_encoder_mlp(
        build.ptr(x), build.ptr(ln_scale), build.ptr(ln_bias), build.ptr(w1),
        build.ptr(b1), build.ptr(w2), build.ptr(b2), build.ptr(x_ln),
        build.ptr(hidden), build.ptr(y), Bp * N, D, Dh, float(eps), parts,
        build.stream_ptr(x.device),
    )
    build.check(lib, rc, "encoder_mlp")
    if parts == 7:
        mlp_launches += 1
    return y


def _mlp_sublayer(x, ln_scale, ln_bias, w1, b1, w2, b2, *, eps: float,
                  use_kernel: bool):
    cdt = x.dtype
    D, Dh = x.shape[-1], w1.shape[0]
    w1, w2 = _bf(w1, cdt).contiguous(), _bf(w2, cdt).contiguous()
    b1, b2 = _f32(b1, Dh, x), _f32(b2, D, x)
    ln_scale, ln_bias = ln_scale.float().contiguous(), ln_bias.float().contiguous()
    if use_kernel:
        return _mlp_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=eps)
    return _mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=eps)


def fused_mlp_sublayer(
    x: torch.Tensor,          # [B', N, D]
    ln_scale: torch.Tensor,   # [D]
    ln_bias: torch.Tensor,    # [D]
    w1: torch.Tensor,         # [Dh, D]
    b1: Optional[torch.Tensor],
    w2: torch.Tensor,         # [D, Dh]
    b2: Optional[torch.Tensor],
    *,
    eps: float,
) -> torch.Tensor:
    """``x + fc2(gelu_exact(fc1(layernorm(x))))``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. The plain version rounds
    LN and the GELU output to the compute dtype and keeps products and the
    residual sum in float32, as the kernel does."""
    return _mlp_sublayer(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=eps,
                         use_kernel=x.is_cuda)


def fused_mlp_sublayer_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, *,
                             eps: float):
    """The plain PyTorch version on any device (the kernel's yardstick)."""
    return _mlp_sublayer(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=eps,
                         use_kernel=False)
