"""Per-codebook masked cross entropy.

Counterpart of ``vaura_tpu/ops/losses.py``: cross entropy per codebook over
the mask-valid positions (mean over the valid positions of that codebook),
averaged across codebooks. Invalid positions are weighted to zero, so the
shapes do not depend on the data.
"""

from __future__ import annotations

from typing import Tuple

import torch


def masked_codebook_cross_entropy(
    logits: torch.Tensor,   # [B, K, T, card] (may hold NaN at masked slots)
    targets: torch.Tensor,  # [B, K, T] int
    mask: torch.Tensor,     # [B, K, T] bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(loss, loss_per_codebook [K])``, float32.

    Masked logits may hold the pattern revert's NaN fill. They are replaced
    with ``torch.where`` BEFORE the log-softmax, and the per-position loss
    is masked with ``torch.where`` again, so that neither the value nor what
    autograd sees of it ever multiplies a NaN (``0 * NaN`` is NaN)."""
    B, K, T, card = logits.shape
    if targets.shape != (B, K, T) or mask.shape != (B, K, T):
        raise ValueError(f"targets {tuple(targets.shape)} and mask "
                         f"{tuple(mask.shape)} must be {(B, K, T)}")
    safe = torch.where(mask[..., None], logits,
                       torch.zeros((), dtype=logits.dtype,
                                   device=logits.device)).float()
    logp = torch.log_softmax(safe, dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]  # [B, K, T]
    nll = torch.where(mask, nll, torch.zeros_like(nll))
    count = mask.float().sum(dim=(0, 2)).clamp_min(1.0)  # [K]
    loss_per_codebook = nll.sum(dim=(0, 2)) / count
    return loss_per_codebook.mean(), loss_per_codebook
