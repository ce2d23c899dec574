"""The decode block's elementwise work as three fused operations: the
residual add with the RMS norm after it, RoPE on the fused q/k/v with the
int8 cache rows, and SwiGLU's product.

On a CUDA tensor each ``*_cuda`` function launches one kernel of
``csrc/decode_block.cu``: one read of its inputs and one write of its
outputs, where eager PyTorch issued 8 to 18 full-tensor passes. On a CPU
tensor each ``*_plain`` function computes the arithmetic of the modules it
replaces in plain PyTorch (``models/sampler.py``'s ``RMSNorm`` after ``x +
a``, ``ops/rope.py::apply_rotary_emb`` with ``ops/quantization.py::
quantize_kv``, ``F.silu(g) * u``), so every CPU run of the decode path
computes what those modules compute. ``kernels/ops.py`` registers both as
``torch.ops.vaura_torch.rmsnorm``, ``add_rmsnorm``, ``rope_qkv_store`` and
``swiglu``; the decode path alone calls them (``Sampler.decode_rows``,
``TransformerBlock.decode``, ``Attention.decode``, ``FeedForward.decode``),
never training or ``prefill``.

* ``add_rmsnorm(x, a, w, eps) -> (h, n)``: ``h = x + a`` in ``x``'s dtype,
  ``n = RMSNorm(h) * w`` in float32, cast to ``x``'s dtype; ``a`` None is
  the no-residual form (``h`` is ``x``; operator ``rmsnorm``).
* ``rope_qkv_store(qkv, cos_sin, n_heads, n_kv, k_rows, v_rows, k_scale,
  v_scale, layer) -> (q, k, v)``: ``qkv [B, 1, (H + 2 H_kv) hd]`` (the wqkv
  output) and one RoPE row ``cos_sin [1, hd/2, 2]`` -> contiguous ``q [B,
  H, hd]``, ``k``, ``v [B, H_kv, hd]``; given the step's int8 rows buffers
  (``k_rows``/``v_rows [L, B, H_kv, hd]`` int8, ``k_scale``/``v_scale [L,
  B, H_kv]`` float32), it also writes layer ``layer``'s quantized k and v
  into them (the operator's only mutation).
* ``swiglu(g, u) -> silu(g) * u``.

Arithmetic, kernel against plain (``csrc/decode_block.cu`` says how): RoPE,
the int8 rows and SwiGLU bit for bit with the eager ops on the card; the
norm within one ulp of its dtype (the sum of squares in another order).

``launches`` counts each kernel's launches (one a call on a CUDA tensor;
``rmsnorm`` and ``add_rmsnorm`` are one kernel).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from vaura_tpu_torch.kernels import build
from vaura_tpu_torch.ops.quantization import quantize_kv
from vaura_tpu_torch.ops.rope import apply_rotary_emb

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIG = {
    "vt_add_rmsnorm": [_P, _P, _P, _P, _P, _LL, _I, ctypes.c_float, _I, _I,
                       _P],
    "vt_rope_qkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I,
                    _I, _P],
    "vt_swiglu": [_P, _P, _P, _LL, _I, _I, _P],
}
DTYPES = (torch.float32, torch.bfloat16)

# launches of each CUDA kernel (one per call on a CUDA tensor)
launches = {"add_rmsnorm": 0, "rope_qkv_store": 0, "swiglu": 0}


# ------------------------------------------------------------------ plain --
def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor,
                  eps: float) -> torch.Tensor:
    xf = x.float()
    norm = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (norm * w).to(x.dtype)


def add_rmsnorm_plain(x: torch.Tensor, a: torch.Tensor, w: torch.Tensor,
                      eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    h = x + a
    return h, rmsnorm_plain(h, w, eps)


def rope_qkv_store_plain(qkv: torch.Tensor, cos_sin: torch.Tensor,
                         n_heads: int, n_kv: int,
                         k_rows: Optional[torch.Tensor] = None,
                         v_rows: Optional[torch.Tensor] = None,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None,
                         layer: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, hd = qkv.shape[0], 2 * cos_sin.shape[-2]
    q, k, v = qkv.reshape(B, 1, -1).split(
        [n_heads * hd, n_kv * hd, n_kv * hd], dim=-1)
    q = apply_rotary_emb(q.reshape(B, 1, n_heads, hd), cos_sin)[:, 0]
    k = apply_rotary_emb(k.reshape(B, 1, n_kv, hd), cos_sin)[:, 0]
    v = v.reshape(B, n_kv, hd).clone(memory_format=torch.contiguous_format)
    if k_rows is not None:
        for t, rows, scale in ((k, k_rows, k_scale), (v, v_rows, v_scale)):
            tq, ts = quantize_kv(t)
            rows[layer].copy_(tq)
            scale[layer].copy_(ts)
    return q.contiguous(), k.contiguous(), v


def swiglu_plain(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return F.silu(g) * u


# ------------------------------------------------------------------- CUDA --
def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _dtype_code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in DTYPES:
        raise TypeError(f"{what}: dtype {t.dtype}; the kernel takes float32 "
                        "and bf16")
    return DTYPES.index(t.dtype)


def _same(what: str, ref: torch.Tensor, *ts: torch.Tensor) -> None:
    for t in ts:
        if (t.shape != ref.shape or t.dtype != ref.dtype
                or t.device != ref.device or not t.is_contiguous()):
            raise ValueError(f"{what}: every input must be a contiguous "
                             f"{tuple(ref.shape)} {ref.dtype} on {ref.device}"
                             f", got {tuple(t.shape)} {t.dtype} on {t.device}")


def _norm_cuda(x: torch.Tensor, a: Optional[torch.Tensor], w: torch.Tensor,
               eps: float) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    dtype = _dtype_code(x, "add_rmsnorm")
    if not x.is_contiguous():
        raise ValueError(f"add_rmsnorm: x must be contiguous, got strides "
                         f"{x.stride()}")
    if a is not None:
        _same("add_rmsnorm", x, a)
    D = x.shape[-1]
    if (w.shape != (D,) or w.dtype != torch.float32 or w.device != x.device
            or not w.is_contiguous()):
        raise ValueError(f"add_rmsnorm: w must be a contiguous [{D}] float32 "
                         f"on {x.device}, got {tuple(w.shape)} {w.dtype} on "
                         f"{w.device}")
    h = None if a is None else torch.empty_like(x)
    n = torch.empty_like(x)
    vec = int(D * x.element_size() % 16 == 0 and _aligned(
        *(t for t in (x, a, h, n) if t is not None)))
    lib = build.load("decode_block", _SIG)
    rc = lib.vt_add_rmsnorm(build.ptr(x), None if a is None else build.ptr(a),
                            build.ptr(w), None if h is None else build.ptr(h),
                            build.ptr(n), x.numel() // D, D, eps, dtype, vec,
                            build.stream_ptr(x.device))
    build.check(lib, rc, "add_rmsnorm")
    launches["add_rmsnorm"] += 1
    return h, n


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float
                 ) -> torch.Tensor:
    """Launch the norm kernel without a residual; raises on any input
    outside its contract."""
    return _norm_cuda(x, None, w, eps)[1]


def add_rmsnorm_cuda(x: torch.Tensor, a: torch.Tensor, w: torch.Tensor,
                     eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the norm kernel with the residual add; raises on any input
    outside its contract."""
    return _norm_cuda(x, a, w, eps)


def rope_qkv_store_cuda(qkv: torch.Tensor, cos_sin: torch.Tensor,
                        n_heads: int, n_kv: int,
                        k_rows: Optional[torch.Tensor] = None,
                        v_rows: Optional[torch.Tensor] = None,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None,
                        layer: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the RoPE kernel (with the int8 store when the rows buffers
    are given); raises on any input outside its contract."""
    dtype = _dtype_code(qkv, "rope_qkv_store")
    B, hd = qkv.shape[0], 2 * cos_sin.shape[-2]
    N = (n_heads + 2 * n_kv) * hd
    if qkv.numel() != B * N or not qkv.is_contiguous():
        raise ValueError(f"rope_qkv_store: qkv must be a contiguous [{B}, 1, "
                         f"{N}], got {tuple(qkv.shape)} with strides "
                         f"{qkv.stride()}")
    if (cos_sin.dtype != torch.float32 or cos_sin.device != qkv.device
            or cos_sin.numel() != hd or not cos_sin.is_contiguous()):
        raise ValueError(f"rope_qkv_store: cos_sin must be a contiguous "
                         f"[1, {hd // 2}, 2] float32 on {qkv.device}, got "
                         f"{tuple(cos_sin.shape)} {cos_sin.dtype}")
    store = (k_rows, v_rows, k_scale, v_scale)
    if any(t is not None for t in store):
        if any(t is None for t in store):
            raise ValueError("rope_qkv_store: give all four rows buffers "
                             "or none")
        L = k_rows.shape[0]
        if not 0 <= layer < L:
            raise ValueError(f"rope_qkv_store: layer {layer} outside the "
                             f"buffers' {L}")
        for t, shape, dt in ((k_rows, (L, B, n_kv, hd), torch.int8),
                             (v_rows, (L, B, n_kv, hd), torch.int8),
                             (k_scale, (L, B, n_kv), torch.float32),
                             (v_scale, (L, B, n_kv), torch.float32)):
            if (tuple(t.shape) != shape or t.dtype != dt
                    or t.device != qkv.device or not t.is_contiguous()):
                raise ValueError(f"rope_qkv_store: a rows buffer must be a "
                                 f"contiguous {shape} {dt} on {qkv.device}, "
                                 f"got {tuple(t.shape)} {t.dtype}")
        slabs = [t[layer] for t in store]
    else:
        slabs = [None] * 4
    q = qkv.new_empty(B, n_heads, hd)
    k = qkv.new_empty(B, n_kv, hd)
    v = qkv.new_empty(B, n_kv, hd)
    chunk = 16 // qkv.element_size()
    vec = int(hd % chunk == 0 and _aligned(qkv, q, k, v, *(
        s for s in slabs[:2] if s is not None)))
    lib = build.load("decode_block", _SIG)
    rc = lib.vt_rope_qkv(
        build.ptr(qkv), build.ptr(cos_sin), build.ptr(q), build.ptr(k),
        build.ptr(v), *(None if s is None else build.ptr(s) for s in slabs),
        B, n_heads, n_kv, hd, dtype, vec, build.stream_ptr(qkv.device))
    build.check(lib, rc, "rope_qkv_store")
    launches["rope_qkv_store"] += 1
    return q, k, v


def swiglu_cuda(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Launch the SwiGLU kernel; raises on any input outside its
    contract."""
    dtype = _dtype_code(g, "swiglu")
    if not g.is_contiguous():
        raise ValueError(f"swiglu: g must be contiguous, got strides "
                         f"{g.stride()}")
    _same("swiglu", g, u)
    out = torch.empty_like(g)
    vec = int(g.numel() * g.element_size() % 16 == 0
              and _aligned(g, u, out))
    lib = build.load("decode_block", _SIG)
    rc = lib.vt_swiglu(build.ptr(g), build.ptr(u), build.ptr(out), g.numel(),
                       dtype, vec, build.stream_ptr(g.device))
    build.check(lib, rc, "swiglu")
    launches["swiglu"] += 1
    return out
