"""Stochastic masks drawn from an explicit ``torch.Generator``, and the
condition-nullification helpers.

``dropout`` and ``drop_path`` take the place of flax's ``nn.Dropout`` and of
the blocks' ``_drop_path`` in the JAX package (``models/sampler.py:451-459``,
``models/motionformer.py:466-472``): ``F.dropout`` takes no generator, and a
training step must be repeatable from its seed. The generator lies on the
tensor's device; ``None`` draws from the device's global generator.

``nullify_condition`` and ``classifier_free_guidance_dropout`` are the
counterparts of ``vaura_tpu/ops/dropout.py`` (the legacy batch-level
utilities; the live CFG path is ``AVCLIPEmbedder.token_drop``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _keep_mask(shape, keep: float, like: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.rand(shape, device=like.device, generator=generator) < keep


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Zero each element with probability ``rate`` and scale the rest by
    ``1 / (1 - rate)``; the identity when not training or at rate 0."""
    if not train or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = _keep_mask(x.shape, keep, x, generator)
    return x * mask.to(x.dtype) / keep


def drop_path(x: torch.Tensor, rate: float, train: bool,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth: drop the whole residual branch of a sample with
    probability ``rate`` (one draw per batch row, mask ``[B, 1, ...]``) and
    scale the kept ones by ``1 / (1 - rate)``."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = _keep_mask((x.shape[0],) + (1,) * (x.ndim - 1), keep, x, generator)
    return x * mask.to(x.dtype) / keep


def nullify_condition(cond: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Collapse ``dim`` (a time axis, never the batch) to a single zero
    step."""
    if dim == 0:
        raise ValueError("dim cannot be the batch dimension")
    return 0.0 * cond.narrow(dim, 0, 1)


def classifier_free_guidance_dropout(
    cond: torch.Tensor, p: float, train: bool = True,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nullify the condition of the whole batch with probability ``p``.
    Returns ``(cond, dropped)``, ``dropped`` a boolean scalar tensor."""
    if not train or p <= 0.0:
        return cond, torch.zeros((), dtype=torch.bool, device=cond.device)
    drop = torch.rand((), device=cond.device, generator=generator) < p
    return torch.where(drop, torch.zeros_like(cond), cond), drop
