"""Per-codebook masked cross entropy.

Counterpart of ``vaura_tpu/ops/losses.py``: cross entropy per codebook over
the mask-valid positions (mean over the valid positions of that codebook),
averaged across codebooks. Invalid positions are weighted to zero, so the
shapes do not depend on the data.

Under a mesh each rank holds some rows of the batch. JAX divides each
codebook's summed loss by its count of valid positions over the WHOLE batch
(``vaura_tpu/ops/losses.py:38-41``); here a rank divides its rows' sum by
that global count (``count_sum`` adds the ranks' counts), so the ranks'
losses add up to the global loss and their gradients, summed over the
batch's shards, are the global gradient.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def masked_codebook_cross_entropy(
    logits: torch.Tensor,   # [B, K, T, card] (may hold NaN at masked slots)
    targets: torch.Tensor,  # [B, K, T] int
    mask: torch.Tensor,     # [B, K, T] bool
    count_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(loss, loss_per_codebook [K])``, float32. ``count_sum``,
    under a mesh, sums the per-codebook counts of valid positions over the
    ranks that hold the batch's other rows (``MeshPlacement.batch_sum``);
    the result is then this rank's share of the global loss.

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
    count = mask.float().sum(dim=(0, 2))  # [K]
    if count_sum is not None:
        count = count_sum(count)
    count = count.clamp_min(1.0)
    loss_per_codebook = nll.sum(dim=(0, 2)) / count
    return loss_per_codebook.mean(), loss_per_codebook
