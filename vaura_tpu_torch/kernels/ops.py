"""Decode attention and Snake as registered PyTorch operators,
``torch.ops.vaura_torch.decode_attention`` and ``torch.ops.vaura_torch.snake``.

``torch.export`` records a registered operator in its graph but cannot
trace through the ``ctypes`` launch of ``ops/decode_attention.py``, and a
fake tensor has no data pointer to hand it. The operator's kernel, for CPU
and CUDA tensors alike, is ``ops.decode_attention.decode_attention``: on
CUDA tensors ``decode_attention_cuda`` (the same ``_check``, ``launch_plan``
and launch counters), on CPU tensors the plain version. Its fake
implementation returns ``torch.empty_like(q)``. One operator covers every
kind of cache: bf16, int8 and int4 (``k_scale``/``v_scale`` given,
``cache_bits``) and the int8 x int8 products (``int8_dots`` over
``chunk_starts``' groups); ``pos`` is the one-element int32 tensor on
``q``'s device that the kernels read.

It is defined with ``torch.library.Library``, one kernel for each of the
CPU and CUDA dispatch keys, not with ``torch.library.custom_op``: the latter
wraps every call in an autograd layer and an aliasing check, which cost 113
us of host time a call against 60 us here and 46 us for the direct call (on
an NVIDIA H100 80GB HBM3 machine at the flagship's decode shapes;
``PERF.md`` §6), 24 calls a decode step. The operator has no
backward: it serves generation, which records no graph.

``snake(x, alpha)`` (``ops/snake.py``) is registered the same way: the
kernel ``snake_cuda`` for CUDA tensors, ``snake_plain`` for CPU tensors, a
fake that returns ``torch.empty_like(x)``, no backward (the codec runs
without a graph). ``models/dac/layers.py::Snake1d`` calls it, so the
exported epilogue's DAC decode records it.

Importing this module registers the operators and imports no model, so a
process that loads an exported graph (``utils/aot.py::load_generate``) needs
only this. Every decode step of the model (``Sampler.decode_rows``, whose
position is a tensor) reaches decode attention through the operator,
replayed from a CUDA graph or run eagerly.
"""

from __future__ import annotations

import torch

from vaura_tpu_torch.ops.decode_attention import decode_attention
from vaura_tpu_torch.ops.snake import snake_cuda, snake_plain

SCHEMA = ("decode_attention(Tensor q, Tensor k_cache, Tensor v_cache, "
          "Tensor k_cur, Tensor v_cur, Tensor pos, Tensor? k_scale=None, "
          "Tensor? v_scale=None, int cache_bits=8, bool int8_dots=False, "
          "Tensor? chunk_starts=None) -> Tensor")

_LIB = torch.library.Library("vaura_torch", "DEF")
_LIB.define(SCHEMA)
_LIB.define("snake(Tensor x, Tensor alpha) -> Tensor")


def _decode_attention(q, k_cache, v_cache, k_cur, v_cur, pos, k_scale=None,
                      v_scale=None, cache_bits=8, int8_dots=False,
                      chunk_starts=None):
    return decode_attention(q, k_cache, v_cache, k_cur, v_cur, pos, k_scale,
                            v_scale, cache_bits=cache_bits,
                            int8_dots=int8_dots, chunk_starts=chunk_starts)


for _key in ("CPU", "CUDA"):
    _LIB.impl("decode_attention", _decode_attention, _key)


@torch.library.register_fake("vaura_torch::decode_attention")
def _decode_attention_fake(q, k_cache, v_cache, k_cur, v_cur, pos,
                           k_scale=None, v_scale=None, cache_bits=8,
                           int8_dots=False, chunk_starts=None):
    return torch.empty_like(q)


decode_attention_op = torch.ops.vaura_torch.decode_attention.default


_LIB.impl("snake", snake_plain, "CPU")
_LIB.impl("snake", snake_cuda, "CUDA")


@torch.library.register_fake("vaura_torch::snake")
def _snake_fake(x, alpha):
    return torch.empty_like(x)


snake_op = torch.ops.vaura_torch.snake.default
