"""Sampling primitives and the CFG blend.

Counterpart of ``vaura_tpu/ops/sampling.py``. Both sample from masked
logits with the Gumbel trick (``argmax(logits + gumbel)``), here with the
uniform noise of an explicit ``torch.Generator``; the two packages draw from
the same distribution but cannot draw the same tokens.

The noise is drawn for the WHOLE batch: under a mesh (``rows``: this rank's
first row and the whole batch's row count) every rank draws it from the one
generator and keeps its own rows, so that a batch draws the same tokens
however it is sharded, and as one process draws them.

The uniform draw may instead come in as ``noise`` (a graph traced once for
every step cannot hold a generator: ``utils/aot.py``): the caller then draws
it with ``uniform_noise``, the same call on the same generator, so the
tokens do not change.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1.0e30


Rows = Optional[Tuple[int, int]]


def uniform_noise(shape, generator: Optional[torch.Generator],
                  device) -> torch.Tensor:
    """The uniform draw behind the Gumbel noise of a whole batch of
    ``shape``: what ``gumbel_noise`` draws when it is given no ``noise``."""
    return torch.rand(tuple(shape), generator=generator, device=device)


def gumbel_noise(shape, rows: Tuple[int, int],
                 generator: Optional[torch.Generator], device,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` (this rank's rows): the rows
    ``rows[0] .. rows[0] + shape[0]`` of a draw of ``rows[1]`` rows, or of
    ``noise``, that draw made by the caller (``uniform_noise``)."""
    row0, total = rows
    if noise is None:
        noise = uniform_noise((total,) + tuple(shape[1:]), generator, device)
    u = noise[row0:row0 + shape[0]]
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def multinomial(logits: torch.Tensor,
                generator: Optional[torch.Generator],
                rows: Rows = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One index per distribution on the last axis of ``logits``, by the
    Gumbel trick; ``rows`` (default: ``logits`` is the whole batch) places
    its rows in the whole batch's noise, which ``noise`` may hold."""
    g = gumbel_noise(logits.shape, rows or (0, logits.shape[0]), generator,
                     logits.device, noise)
    return torch.argmax(logits.float() + g, dim=-1)


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask everything below the k-th largest value to ``NEG_INF``; values
    tied with the k-th are kept (the ``>=`` threshold)."""
    k = min(int(k), logits.shape[-1])
    threshold = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits >= threshold, logits,
                       torch.full_like(logits, NEG_INF))


def sample_top_k(logits: torch.Tensor, k: int,
                 generator: Optional[torch.Generator],
                 rows: Rows = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    return multinomial(top_k_mask(logits, k), generator, rows, noise)


def sample_top_p(logits: torch.Tensor, p: float,
                 generator: Optional[torch.Generator],
                 rows: Rows = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Nucleus sampling: a token is kept while ``cumsum(probs) - probs <= p``
    over the descending order."""
    sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True)
    sorted_probs = torch.softmax(sorted_logits.float(), dim=-1)
    keep = (torch.cumsum(sorted_probs, dim=-1) - sorted_probs) <= p
    masked = torch.where(keep, sorted_logits.float(),
                         torch.full_like(sorted_probs, NEG_INF))
    choice = multinomial(masked, generator, rows, noise)
    return torch.gather(sort_idx, -1, choice[..., None])[..., 0]


def cfg_blend(cond_logits: torch.Tensor, uncond_logits: torch.Tensor,
              cfg_scale: float) -> torch.Tensor:
    """Classifier-free guidance: ``uncond + (cond - uncond) * scale``."""
    return uncond_logits + (cond_logits - uncond_logits) * cfg_scale


def draws_noise(use_sampling: bool = True, temp: float = 1.0) -> bool:
    """Whether ``sample_tokens`` draws Gumbel noise for these settings."""
    return bool(use_sampling) and temp > 0.0


def sample_tokens(logits: torch.Tensor, *, generator: Optional[torch.Generator],
                  use_sampling: bool = True, temp: float = 1.0, top_k: int = 0,
                  top_p: float = 0.0, rows: Rows = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Top-p if > 0, else top-k if > 0, else plain multinomial; greedy
    argmax (first maximum on ties) when sampling is off or ``temp == 0``.
    ``rows`` (under a mesh) and ``noise`` (the uniform draw, made by the
    caller): see the module docstring."""
    if draws_noise(use_sampling, temp):
        scaled = logits / temp
        if top_p > 0.0:
            return sample_top_p(scaled, top_p, generator, rows, noise)
        if top_k > 0:
            return sample_top_k(scaled, top_k, generator, rows, noise)
        return multinomial(scaled, generator, rows, noise)
    return torch.argmax(logits, dim=-1)
