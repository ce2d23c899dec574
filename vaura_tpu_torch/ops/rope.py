"""Rotary positional embedding, interleaved-pair variant.

Counterpart of ``vaura_tpu/ops/rope.py``: frequencies over even channel
indices, rotation of adjacent channel pairs ``(2i, 2i+1)`` (not the
half-rotation variant). The cos/sin table is built once on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def precompute_freqs_cis(seq_len: int, head_dim: int,
                         base: float = 10000.0) -> np.ndarray:
    """Returns the ``[seq_len, head_dim//2, 2]`` (cos, sin) table, float32."""
    freqs = 1.0 / (
        base ** (np.arange(0, head_dim, 2)[: head_dim // 2].astype(np.float32)
                 / head_dim)
    )
    t = np.arange(seq_len, dtype=np.float32)
    angles = np.outer(t, freqs)  # [seq_len, head_dim//2]
    return np.stack([np.cos(angles), np.sin(angles)], axis=-1)


def apply_rotary_emb(x: torch.Tensor, freqs_cis: torch.Tensor) -> torch.Tensor:
    """Rotate adjacent channel pairs of ``x [B, S, H, D]`` by
    ``freqs_cis [S, D//2, 2]``; computed in float32, returned in x's dtype."""
    B, S, H, D = x.shape
    xf = x.float().reshape(B, S, H, D // 2, 2)
    fc = freqs_cis.reshape(1, S, 1, D // 2, 2)
    cos, sin = fc[..., 0], fc[..., 1]
    x0, x1 = xf[..., 0], xf[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1)
    return out.reshape(B, S, H, D).to(x.dtype)
