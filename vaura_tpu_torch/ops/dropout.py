"""Stochastic masks drawn from an explicit ``torch.Generator``, and the
condition-nullification helpers.

``dropout`` and ``drop_path`` take the place of flax's ``nn.Dropout`` and of
the blocks' ``_drop_path`` in the JAX package (``models/sampler.py:451-459``,
``models/motionformer.py:466-472``): ``F.dropout`` takes no generator, and a
training step must be repeatable from its seed. The generator lies on the
tensor's device; ``None`` draws from the device's global generator.

Under a mesh a rank holds a block of the batch (and, in the decoder's
attention, a block of the heads), and its masks must be the ones a single
process would draw for those rows: ``batch_shard((index, count))`` says, for
the calls inside it, that every leading axis is block ``index`` of
``count`` equal blocks of the whole batch's. Each draw is then made for the
whole batch, from the one generator every rank seeds alike, and this rank
keeps its block (JAX draws its masks for the global array too). Every rank
draws as much as one process would, so masks cost ``count`` times the
local draw; with no ``batch_shard`` the draw is the local one, unchanged.

``nullify_condition`` and ``classifier_free_guidance_dropout`` are the
counterparts of ``vaura_tpu/ops/dropout.py`` (the legacy batch-level
utilities; the live CFG path is ``AVCLIPEmbedder.token_drop``).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import torch

Block = Optional[Tuple[int, int]]  # (index, count) of equal blocks

_BATCH_SHARD: contextvars.ContextVar = contextvars.ContextVar(
    "batch_shard", default=None)


@contextlib.contextmanager
def batch_shard(block: Block):
    """Draw the masks of the calls inside for the whole batch, of which the
    tensors' leading axis is block ``index`` of ``count`` (``block``); None
    draws them for the tensors as they are."""
    token = _BATCH_SHARD.set(block)
    try:
        yield
    finally:
        _BATCH_SHARD.reset(token)


def current_batch_shard() -> Block:
    """The ``block`` of the enclosing ``batch_shard``, or None."""
    return _BATCH_SHARD.get()


def uniform(shape, device, generator: Optional[torch.Generator],
            heads: Block = None) -> torch.Tensor:
    """Uniform ``[0, 1)`` noise of ``shape``, this rank's part of a draw for
    the whole batch (``batch_shard``) and, with ``heads`` = (index, count),
    for all the heads on axis 1."""
    whole, part = list(shape), [slice(None)] * len(shape)
    for axis, block in enumerate((current_batch_shard(), heads)):
        if block is not None:
            i, n = block
            whole[axis] = shape[axis] * n
            part[axis] = slice(i * shape[axis], (i + 1) * shape[axis])
    u = torch.rand(whole, device=device, generator=generator)
    return u[tuple(part)] if whole != list(shape) else u


def _keep_mask(shape, keep: float, like: torch.Tensor,
               generator: Optional[torch.Generator],
               heads: Block = None) -> torch.Tensor:
    return uniform(shape, like.device, generator, heads) < keep


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None,
            heads: Block = None) -> torch.Tensor:
    """Zero each element with probability ``rate`` and scale the rest by
    ``1 / (1 - rate)``; the identity when not training or at rate 0.
    ``heads``: see ``uniform``."""
    if not train or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = _keep_mask(x.shape, keep, x, generator, heads)
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
