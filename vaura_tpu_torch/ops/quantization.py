"""int8 weights and the int8 KV cache of the decode path.

Counterpart of ``vaura_tpu/ops/quantization.py`` (``quantize_weight``,
``quantize_sampler_params``, ``quant_dense``, ``quantize_kv``); the int4
cache and the int8 x int8 attention products (``cache_bits=4``,
``int8_dots``) are not ported.

Weights: symmetric per output channel, ``W ~ q * scale`` with ``scale =
max|W| / 127`` over the input axis, in the port's ``[out, in]`` layout
(``kernel_q [out, in]`` int8, ``scale [out]`` float32). The KV cache:
symmetric int8 over ``head_dim`` with one float32 scale per (position, KV
head); the scales fold outside the attention products (scores times
``k_scale``, probabilities times ``v_scale``). Rounding is half to even, as
``jnp.round``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

# the sampler's matmul weights that int8 weights replace (state-dict names
# of the port, ``layers.<i>.`` before the per-layer ones)
QUANT_LAYER_WEIGHTS = ("attention.wqkv", "attention.wo", "feed_forward.w1",
                       "feed_forward.w2", "feed_forward.w3")
QUANT_WEIGHTS = ("lm_head",)


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


def _is_quantized(name: str) -> bool:
    base = name[:-len(".weight")] if name.endswith(".weight") else None
    if base is None:
        return False
    if base in QUANT_WEIGHTS:
        return True
    parts = base.split(".", 2)
    return (len(parts) == 3 and parts[0] == "layers"
            and parts[2] in QUANT_LAYER_WEIGHTS)


def quantize_sampler_params(state_dict: Dict[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """The sampler's state dict with its big matmul weights replaced by
    ``<name>.kernel_q`` / ``<name>.scale`` (for a ``Sampler`` built with
    ``quantize_weights=True``); every other entry unchanged."""
    out = {}
    for name, value in state_dict.items():
        if _is_quantized(name):
            base = name[:-len(".weight")]
            for k, v in quantize_weight(value).items():
                out[f"{base}.{k}"] = v
        else:
            out[name] = value
    return out


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
