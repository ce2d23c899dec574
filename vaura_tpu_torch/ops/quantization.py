"""int8 weights and the int8 KV cache of the decode path.

Counterpart of ``vaura_tpu/ops/quantization.py`` (``quantize_weight``,
``quantize_sampler_params``, ``quant_dense``, ``quantize_kv``,
``quantize_rows``, ``quantize_encoder_params``, ``quantize_kv4``,
``unpack_int4``).

Weights: symmetric per output channel, ``W ~ q * scale`` with ``scale =
max|W| / 127`` over the input axis, in the port's ``[out, in]`` layout
(``kernel_q [out, in]`` int8, ``scale [out]`` float32). The KV cache:
symmetric int8 over ``head_dim`` with one float32 scale per (position, KV
head); the scales fold outside the attention products (scores times
``k_scale``, probabilities times ``v_scale``). Rounding is half to even, as
``jnp.round``. The int4 cache (``cache_bits=4``): symmetric in [-7, 7] with
``scale = max|x| / 7``, two values a byte, half-split: byte ``j`` holds
value ``j`` in its low nibble and value ``j + hd/2`` in its high nibble.

The int8 encoder (``MotionFormerConfig.quantize``): the divided blocks'
matmul weights and the MLP's as above, and each activation row quantized on
the fly (``quantize_rows``); ``int8_matmul`` multiplies the two exactly in
int32 (``torch._int_mm`` on the card, an int32 product on the CPU).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

# the sampler's matmul weights that int8 weights replace (state-dict names
# of the port, ``layers.<i>.`` before the per-layer ones)
QUANT_LAYER_WEIGHTS = ("attention.wqkv", "attention.wo", "feed_forward.w1",
                       "feed_forward.w2", "feed_forward.w3")
QUANT_WEIGHTS = ("lm_head",)
# the encoder's matmul weights that the int8 encoder quantizes (per layer,
# ``blocks.<i>.`` before them): the JAX package's ``ENCODER_QUANT_PATHS``
# (``blocks/timeattn/qkv/kernel`` ...) under the port's names. The MLP's
# exist in every block layout; the two attentions' only in the divided one.
ENCODER_QUANT_PATHS = ("timeattn.qkv", "timeattn.proj", "attn.qkv",
                       "attn.proj", "mlp.fc1", "mlp.fc2")


def _symmetric(x: torch.Tensor, dim: int, levels: float = 127.0):
    xf = x.float()
    scale = (xf.abs().amax(dim=dim, keepdim=True) / levels).clamp_min(1e-8)
    q = torch.round(xf / scale).clamp_(-levels, levels).to(torch.int8)
    return q, scale.squeeze(dim)


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``[out, in]`` float -> ``{"kernel_q" int8 [out, in], "scale" float32
    [out]}``."""
    q, scale = _symmetric(w, dim=-1)
    return {"kernel_q": q, "scale": scale}


def _is_quantized(name: str, stack: str, layer_weights, weights=()) -> bool:
    base = name[:-len(".weight")] if name.endswith(".weight") else None
    if base is None:
        return False
    if base in weights:
        return True
    parts = base.split(".", 2)
    return len(parts) == 3 and parts[0] == stack and parts[2] in layer_weights


def _quantize_named(state_dict: Dict[str, torch.Tensor], *args
                    ) -> Dict[str, torch.Tensor]:
    out = {}
    for name, value in state_dict.items():
        if _is_quantized(name, *args):
            base = name[:-len(".weight")]
            for k, v in quantize_weight(value).items():
                out[f"{base}.{k}"] = v
        else:
            out[name] = value
    return out


def quantize_sampler_params(state_dict: Dict[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """The sampler's state dict with its big matmul weights replaced by
    ``<name>.kernel_q`` / ``<name>.scale`` (for a ``Sampler`` built with
    ``quantize_weights=True``); every other entry unchanged."""
    return _quantize_named(state_dict, "layers", QUANT_LAYER_WEIGHTS,
                           QUANT_WEIGHTS)


def quantize_encoder_params(state_dict: Dict[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """The encoder's state dict with the blocks' ``ENCODER_QUANT_PATHS``
    weights replaced by ``kernel_q`` / ``scale`` (for a ``MotionFormer``
    built with ``quantize=True``); biases, norms, embeddings, the patch
    embedding and the aggregation layers unchanged."""
    return _quantize_named(state_dict, "blocks", ENCODER_QUANT_PATHS)


def quant_dense(x: torch.Tensor, kernel_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``y = (x @ kernel_q^T) * scale`` in ``x``'s dtype: the int8 weight is
    upcast to it (exact), scaled in float32 and rounded once more."""
    y = torch.matmul(x, kernel_q.t().to(x.dtype))
    return (y.float() * scale.float()).to(x.dtype)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the last axis (head_dim): ``(q int8, scale
    float32 [...])`` with ``x ~ q * scale[..., None]``."""
    return _symmetric(x, dim=-1)


def quantize_kv4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int4 over the last axis, two values a byte: ``(packed int8
    [..., hd/2], scale float32 [...])``; packed byte ``j`` holds value ``j``
    in its low nibble and value ``j + hd/2`` in its high nibble."""
    hd = x.shape[-1]
    if hd % 2:
        raise ValueError(f"quantize_kv4: head_dim {hd} is odd")
    q, scale = _symmetric(x, dim=-1, levels=7.0)
    lo, hi = q[..., :hd // 2], q[..., hd // 2:]
    return (lo & 0x0F) | (hi << 4), scale


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_kv4``'s packing: int8 ``[..., hd/2]`` -> int8
    ``[..., hd]``, both nibbles sign-extended (the low ones first)."""
    return torch.cat([(packed << 4) >> 4, packed >> 4], dim=-1)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric int8 of activation rows (over the last axis):
    ``(q int8, scale float32 [...])`` with ``x ~ q * scale[..., None]``."""
    return _symmetric(x, dim=-1)


# torch._int_mm's shape rules on CUDA: more than 16 rows, and the inner and
# output widths multiples of 8
INT_MM_MIN_ROWS, INT_MM_MULTIPLE = 17, 8


def int8_matmul(xq: torch.Tensor, kernel_q: torch.Tensor) -> torch.Tensor:
    """``xq [..., in] int8 @ kernel_q [out, in]^T int8 -> [..., out]`` int32,
    exact. On the card ``torch._int_mm`` (PyTorch's int8 GEMM), its
    operands zero-padded up to its shape rules (zeros add nothing to an
    integer sum) and the padding cut off after; on the CPU an int32
    product."""
    lead, K = xq.shape[:-1], xq.shape[-1]
    N = kernel_q.shape[0]
    x2 = xq.reshape(-1, K)
    if not xq.is_cuda:
        return (x2.to(torch.int32) @ kernel_q.t().to(torch.int32)).reshape(
            *lead, N)
    M = x2.shape[0]
    pad_k = -K % INT_MM_MULTIPLE
    pad_n = -N % INT_MM_MULTIPLE
    pad_m = max(INT_MM_MIN_ROWS - M, 0)
    w = kernel_q
    if pad_k or pad_n:
        w = F.pad(w, (0, pad_k, 0, pad_n))
    if pad_k or pad_m:
        x2 = F.pad(x2, (0, pad_k, 0, pad_m))
    y = torch._int_mm(x2, w.t())
    return y[:M, :N].reshape(*lead, N)


def int8_dense(x: torch.Tensor, kernel_q: torch.Tensor, scale: torch.Tensor,
               bias=None) -> torch.Tensor:
    """The int8 encoder's dense layer (``EncDense`` with ``quantize``):
    ``(quantize_rows(x) @ kernel_q^T) * x_scale * w_scale`` in float32,
    plus the float32 bias, returned in float32."""
    xq, xs = quantize_rows(x)
    y = int8_matmul(xq, kernel_q).float() * xs[..., None] * scale
    return y if bias is None else y + bias
