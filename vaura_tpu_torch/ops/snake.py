"""Snake, the DAC's activation: ``x + sin^2(alpha x) / (alpha + 1e-9)`` over
``x [B, C, T]`` with one ``alpha`` a channel.

On a CUDA tensor ``snake_cuda`` launches ``csrc/snake.cu`` once: one read of
``x`` and one write of the output, where eager PyTorch took five
full-tensor kernels. On a CPU tensor ``snake_plain`` computes the same
arithmetic in plain PyTorch. ``kernels/ops.py`` registers both as
``torch.ops.vaura_torch.snake``, which ``models/dac/layers.py::Snake1d``
calls, so an exported DAC decode records the operator.

Arithmetic, both versions:

* float32 (and any dtype but bf16 on the CPU): the eager formula,
  ``t = a*x``, ``s = sin(t)``, ``x + s*s / (a + 1e-9)``; the kernel's precise
  ``sinf`` and IEEE divide give eager PyTorch's values bit for bit;
* bf16: the JAX package's bf16 form (``vaura_tpu/models/dac/layers.py``,
  ``Snake1d``): ``a*x`` rounded to bf16, ``sin^2`` and the divide in float32
  with ``alpha`` widened, the quotient rounded to bf16 before the add. The
  JAX package takes ``sin^2`` from a polynomial (error ~5e-7), this port
  from ``sin``.

``launches`` counts the kernel's launches (one a call on a CUDA tensor).
"""

from __future__ import annotations

import ctypes

import torch

from vaura_tpu_torch.kernels import build

_SIG = {"vt_snake": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}
DTYPES = (torch.float32, torch.bfloat16)

# launches of the CUDA kernel (one per call on a CUDA tensor)
launches = 0


def snake_plain(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    a = alpha.to(x.dtype)[None, :, None]
    if x.dtype != torch.bfloat16:
        return x + torch.sin(a * x) ** 2 / (a + 1e-9)
    s2 = torch.sin((a * x).float()) ** 2
    return x + (s2 / (a.float() + 1e-9)).to(x.dtype)


def vector_path(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether every row of ``x`` and ``y`` ``[B, C, T]`` starts 16-byte
    aligned: the kernel then moves 16-byte vectors, else scalars."""
    return (x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
            and x.shape[-1] * x.element_size() % 16 == 0)


def _check(x: torch.Tensor, alpha: torch.Tensor) -> None:
    if x.dtype not in DTYPES:
        raise TypeError(f"snake: dtype {x.dtype}; the kernel takes float32 "
                        "and bf16")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"snake: x must be a contiguous [B, C, T], got "
                         f"{tuple(x.shape)} with strides {x.stride()}")
    if (alpha.shape != (x.shape[1],) or alpha.dtype != x.dtype
            or alpha.device != x.device or not alpha.is_contiguous()):
        raise ValueError(f"snake: alpha must be a contiguous [{x.shape[1]}] "
                         f"{x.dtype} on {x.device}, got {tuple(alpha.shape)} "
                         f"{alpha.dtype} on {alpha.device}")


def snake_cuda(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Launch the kernel; raises on any input outside its contract."""
    global launches
    _check(x, alpha)
    y = torch.empty_like(x)
    B, C, T = x.shape
    lib = build.load("snake", _SIG)
    rc = lib.vt_snake(build.ptr(x), build.ptr(alpha), build.ptr(y), B, C, T,
                      DTYPES.index(x.dtype), int(vector_path(x, y)),
                      build.stream_ptr(x.device))
    build.check(lib, rc, "snake")
    launches += 1
    return y
