"""Sampling primitives and the CFG blend.

Counterpart of ``vaura_tpu/ops/sampling.py``. JAX samples from masked logits
with the Gumbel trick; here the masked logits go through a float32 softmax
and ``torch.multinomial`` with an explicit ``torch.Generator``. Both draw
from the same distribution; they cannot draw the same tokens.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1.0e30


def multinomial(logits: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """One index per distribution on the last axis of ``logits``."""
    probs = torch.softmax(logits.float(), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    idx = torch.multinomial(flat, 1, generator=generator)
    return idx.reshape(probs.shape[:-1])


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask everything below the k-th largest value to ``NEG_INF``; values
    tied with the k-th are kept (the ``>=`` threshold)."""
    k = min(int(k), logits.shape[-1])
    threshold = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits >= threshold, logits,
                       torch.full_like(logits, NEG_INF))


def sample_top_k(logits: torch.Tensor, k: int,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    return multinomial(top_k_mask(logits, k), generator)


def sample_top_p(logits: torch.Tensor, p: float,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """Nucleus sampling: a token is kept while ``cumsum(probs) - probs <= p``
    over the descending order."""
    sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True)
    sorted_probs = torch.softmax(sorted_logits.float(), dim=-1)
    keep = (torch.cumsum(sorted_probs, dim=-1) - sorted_probs) <= p
    masked = torch.where(keep, sorted_logits.float(),
                         torch.full_like(sorted_probs, NEG_INF))
    choice = multinomial(masked, generator)
    return torch.gather(sort_idx, -1, choice[..., None])[..., 0]


def cfg_blend(cond_logits: torch.Tensor, uncond_logits: torch.Tensor,
              cfg_scale: float) -> torch.Tensor:
    """Classifier-free guidance: ``uncond + (cond - uncond) * scale``."""
    return uncond_logits + (cond_logits - uncond_logits) * cfg_scale


def sample_tokens(logits: torch.Tensor, *, generator: Optional[torch.Generator],
                  use_sampling: bool = True, temp: float = 1.0, top_k: int = 0,
                  top_p: float = 0.0) -> torch.Tensor:
    """Top-p if > 0, else top-k if > 0, else plain multinomial; greedy
    argmax (first maximum on ties) when sampling is off or ``temp == 0``."""
    if use_sampling and temp > 0.0:
        scaled = logits / temp
        if top_p > 0.0:
            return sample_top_p(scaled, top_p, generator)
        if top_k > 0:
            return sample_top_k(scaled, top_k, generator)
        return multinomial(scaled, generator)
    return torch.argmax(logits, dim=-1)
