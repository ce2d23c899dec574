"""Grouped attention with a shared CLS key/value column.

Counterpart of ``vaura_tpu/ops/divided_attention.py``. Divided space-time
attention runs many small independent attentions: on the time axis each of
the n spatial locations attends over its f frames, on the space axis each
frame over its n locations, and every group also sees the CLS key/value.

Layout contract (the caller transposes once per axis, as in the JAX
package):

  q, k, v:      [BH, G, L, hd]   (BH = batch * heads, G groups of L tokens)
  cls_k, cls_v: [BH, 1, hd]
  out:          [BH, G, L, hd]   softmax([q . cls_k, q k^T]) @ [cls_v; v]

``q`` is pre-scaled by ``1/sqrt(hd)``. On CUDA tensors
``grouped_cls_attention`` launches the kernel of
``csrc/grouped_cls_attention.cu`` (bf16, head dim 64, L <= 256; anything
else raises): one kernel for both axes, a block a pack of whole groups, the
attention on the tensor cores in registers (``csrc/group_attention.cuh``,
which the fused encoder sublayer runs too); ``grouped_plan`` says how a shape
is cut into packs and blocks. On CPU tensors it runs
``grouped_cls_attention_plain``.

Differentiable, as the JAX package's ``custom_vjp`` is: the forward saves
its five inputs and the backward recomputes through the plain version on
whatever device the tensors lie (the JAX package has no backward kernel
either: ``_bwd`` takes ``jax.vjp`` of its einsum reference).
"""

from __future__ import annotations

import ctypes

import torch

from vaura_tpu_torch.kernels import build

# launches of the CUDA kernel (one per forward call on CUDA tensors)
launches = 0

KERNEL_HEAD_DIM = 64
MAX_GROUP_LEN = 256  # longest group: one pack of 256 rows in shared memory
MAX_WARPS = 8        # warps of one block, at most
SM_SMEM = 228 * 1024  # shared memory of one SM; a block reserves 1 KB more
SM_THREADS = 2048
SM_REGISTERS = 65536
KERNEL_REGISTERS = 128  # a thread's registers, at most (__launch_bounds__)


def pack_rows(L: int) -> int:
    """Rows of one block's pack: whole groups, ``L * max(1, 128 // L)``
    (time axis L=8 -> 128 rows, space axis L=196 -> 196), so that the q/k/v
    tiles of two blocks fit an SM's shared memory together."""
    return L * max(1, 128 // L)


def grouped_plan(N: int, L: int) -> dict:
    """How the kernel cuts the ``N = G * L`` rows of one ``bh`` (the grid
    is packs by BH): packs and the rows of the last one, the 16-row query
    tiles of the longest pack, the warps of a block (one a tile, at most 8),
    the block's dynamic shared memory (q, k and v tiles of pack rows + 16
    rows of 144 bytes and the CLS key and value tiles of 16 rows), and the
    blocks an SM holds by shared memory, threads and registers (the kernel
    is compiled for two blocks of 8 warps: at most 128 registers a thread).
    Mirrors ``vt_grouped_cls_attention`` in
    ``csrc/grouped_cls_attention.cu``."""
    if not 0 < L <= MAX_GROUP_LEN or N <= 0 or N % L:
        raise ValueError(f"grouped_plan: N={N}, L={L}: the CUDA kernel takes "
                         f"whole groups of at most {MAX_GROUP_LEN} rows")
    rows = pack_rows(L)
    tiles = -(-min(rows, N) // 16)
    warps = min(MAX_WARPS, tiles)
    n_packs = -(-N // rows)
    smem = (3 * (rows + 16) + 2 * 16) * (KERNEL_HEAD_DIM + 8) * 2
    return {
        "rows_per_pack": rows, "n_packs": n_packs,
        "last_pack_rows": N - (n_packs - 1) * rows, "query_tiles": tiles,
        "warps": warps, "smem_bytes": smem,
        "blocks_per_sm": min(SM_SMEM // (smem + 1024),
                             SM_THREADS // (32 * warps),
                             SM_REGISTERS // (KERNEL_REGISTERS * 32 * warps)),
    }


_SIG = {
    "vt_grouped_cls_attention": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
}


def grouped_cls_attention_plain(q, k, v, cls_k, cls_v):
    """The einsum formulation, on any device; the counterpart of the JAX
    package's ``_reference``. Scores and the softmax are float32; the
    softmax is normalised FIRST and the probabilities are then rounded to
    the value dtype before they multiply the values. (The kernels, here and
    in the JAX package, multiply the unnormalised float32 probabilities and
    divide by the float32 denominator afterwards: in bf16 the two differ by
    the rounding of the probabilities, about 2^-9 relative.)"""
    scores = torch.einsum("bgld,bgmd->bglm", q.float(), k.float())
    s_cls = torch.einsum("bgld,bd->bgl", q.float(), cls_k[:, 0].float())
    full = torch.cat([s_cls[..., None], scores], dim=-1)
    p = torch.softmax(full, dim=-1)
    p_cls, p_tok = p[..., :1], p[..., 1:].to(v.dtype)
    out = torch.einsum("bglm,bgmd->bgld", p_tok, v)
    return out + p_cls.to(cls_v.dtype) * cls_v[:, None]


def grouped_cls_attention_cuda(q, k, v, cls_k, cls_v):
    """Launch the kernel; raises on any input outside its contract."""
    global launches
    if q.ndim != 4:
        raise ValueError("grouped_cls_attention: q must be [BH, G, L, hd]")
    BH, G, L, hd = q.shape
    for name, t, shape in (("q", q, q.shape), ("k", k, q.shape),
                           ("v", v, q.shape), ("cls_k", cls_k, (BH, 1, hd)),
                           ("cls_v", cls_v, (BH, 1, hd))):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"grouped_cls_attention: {name} must be on "
                             f"{q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"grouped_cls_attention: the CUDA kernel takes "
                             f"bfloat16, got {name} {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"grouped_cls_attention: {name} has shape "
                             f"{tuple(t.shape)}, expected {tuple(shape)}")
    if hd != KERNEL_HEAD_DIM or L > MAX_GROUP_LEN:
        raise ValueError(f"grouped_cls_attention: the CUDA kernel takes head "
                         f"dim {KERNEL_HEAD_DIM} and L <= {MAX_GROUP_LEN}, "
                         f"got hd={hd}, L={L}")
    plan = grouped_plan(G * L, L)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    cls_k, cls_v = cls_k.contiguous(), cls_v.contiguous()
    out = torch.empty_like(q)
    lib = build.load("grouped_cls_attention", _SIG)
    rc = lib.vt_grouped_cls_attention(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(cls_k),
        build.ptr(cls_v), build.ptr(out), BH, G * L, L,
        plan["rows_per_pack"], plan["warps"],
        build.stream_ptr(q.device),
    )
    build.check(lib, rc, "grouped_cls_attention")
    launches += 1
    return out


class _GroupedClsAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, cls_k, cls_v):
        ctx.save_for_backward(q, k, v, cls_k, cls_v)
        if q.is_cuda:
            return grouped_cls_attention_cuda(q, k, v, cls_k, cls_v)
        return grouped_cls_attention_plain(q, k, v, cls_k, cls_v)

    @staticmethod
    def backward(ctx, grad_out):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True)
                      for t in ctx.saved_tensors]
            out = grouped_cls_attention_plain(*inputs)
        return torch.autograd.grad(out, inputs, grad_out.to(out.dtype))


def grouped_cls_attention(q, k, v, cls_k, cls_v):
    """Grouped attention with the CLS column: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors; the gradient of either
    goes through the plain version."""
    return _GroupedClsAttention.apply(q, k, v, cls_k, cls_v)
