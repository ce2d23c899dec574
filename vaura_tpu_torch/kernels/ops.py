"""Decode attention, Snake and the decode block's fused elementwise work as
registered PyTorch operators: ``torch.ops.vaura_torch.decode_attention``,
``snake``, ``rmsnorm``, ``add_rmsnorm``, ``rope_qkv_store`` and ``swiglu``.

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

The decode block's operators (``ops/decode_block.py``) are registered the
same way: the ``*_cuda`` kernels for CUDA tensors, the ``*_plain`` versions
for CPU tensors, fakes that return empty outputs, no backward (decode runs
without a graph). ``rope_qkv_store`` mutates its optional int8 rows buffers
(``Tensor(a!)?`` in its schema), so an exported step records the writes.

Importing this module registers the operators and imports no model, so a
process that loads an exported graph (``utils/aot.py::load_generate``) needs
only this. Every decode step of the model (``Sampler.decode_rows``, whose
position is a tensor) reaches decode attention through the operator,
replayed from a CUDA graph or run eagerly.
"""

from __future__ import annotations

import torch

from vaura_tpu_torch.ops.decode_attention import decode_attention
from vaura_tpu_torch.ops import decode_block as db
from vaura_tpu_torch.ops.snake import snake_cuda, snake_plain

SCHEMA = ("decode_attention(Tensor q, Tensor k_cache, Tensor v_cache, "
          "Tensor k_cur, Tensor v_cur, Tensor pos, Tensor? k_scale=None, "
          "Tensor? v_scale=None, int cache_bits=8, bool int8_dots=False, "
          "Tensor? chunk_starts=None) -> Tensor")

_LIB = torch.library.Library("vaura_torch", "DEF")
_LIB.define(SCHEMA)
_LIB.define("snake(Tensor x, Tensor alpha) -> Tensor")
_LIB.define("rmsnorm(Tensor x, Tensor w, float eps) -> Tensor")
_LIB.define("add_rmsnorm(Tensor x, Tensor a, Tensor w, float eps) "
            "-> (Tensor, Tensor)")
_LIB.define("rope_qkv_store(Tensor qkv, Tensor cos_sin, int n_heads, "
            "int n_kv, Tensor(a!)? k_rows=None, Tensor(b!)? v_rows=None, "
            "Tensor(c!)? k_scale=None, Tensor(d!)? v_scale=None, "
            "int layer=0) -> (Tensor, Tensor, Tensor)")
_LIB.define("swiglu(Tensor g, Tensor u) -> Tensor")


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


for _name in ("rmsnorm", "add_rmsnorm", "rope_qkv_store", "swiglu"):
    _LIB.impl(_name, getattr(db, f"{_name}_plain"), "CPU")
    _LIB.impl(_name, getattr(db, f"{_name}_cuda"), "CUDA")


@torch.library.register_fake("vaura_torch::rmsnorm")
def _rmsnorm_fake(x, w, eps):
    return torch.empty_like(x)


@torch.library.register_fake("vaura_torch::add_rmsnorm")
def _add_rmsnorm_fake(x, a, w, eps):
    return torch.empty_like(x), torch.empty_like(x)


@torch.library.register_fake("vaura_torch::rope_qkv_store")
def _rope_qkv_store_fake(qkv, cos_sin, n_heads, n_kv, k_rows=None,
                         v_rows=None, k_scale=None, v_scale=None, layer=0):
    B, hd = qkv.shape[0], 2 * cos_sin.shape[-2]
    return (qkv.new_empty(B, n_heads, hd), qkv.new_empty(B, n_kv, hd),
            qkv.new_empty(B, n_kv, hd))


@torch.library.register_fake("vaura_torch::swiglu")
def _swiglu_fake(g, u):
    return torch.empty_like(g)


rmsnorm_op = torch.ops.vaura_torch.rmsnorm.default
add_rmsnorm_op = torch.ops.vaura_torch.add_rmsnorm.default
rope_qkv_store_op = torch.ops.vaura_torch.rope_qkv_store.default
swiglu_op = torch.ops.vaura_torch.swiglu.default
