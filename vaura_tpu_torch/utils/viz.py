"""Visualization helpers for TensorBoard media logging (counterpart of
``vaura_tpu/utils/viz.py``): each generation step's attention row becomes
one video frame (the reference's attention-weight videos,
``utils/train_utils.py:204-255``) without matplotlib: rows are normalized,
gamma-mapped and nearest-neighbor upscaled to a legible strip.
"""

from __future__ import annotations

import numpy as np


def attn_rows_to_video(
    weights: np.ndarray,  # [T, S] one attention row per generated step
    scale: int = 6,
    height: int = 40,
) -> np.ndarray:
    """Returns [T, H, W, 3] uint8 frames."""
    weights = np.asarray(weights, np.float32)
    lo = weights.min(axis=-1, keepdims=True)
    hi = weights.max(axis=-1, keepdims=True)
    norm = (weights - lo) / np.maximum(hi - lo, 1e-8)
    norm = norm**0.5  # gamma for visibility of small weights
    img = (norm * 255).astype(np.uint8)  # [T, S]
    img = np.repeat(img[:, None, :], height, axis=1)  # [T, H, S]
    img = np.repeat(img, scale, axis=2)  # [T, H, S*scale]
    return np.repeat(img[..., None], 3, axis=-1)


def scale_to_01(x: np.ndarray) -> np.ndarray:
    """Rescale to [0, 1] for human viewing (reference ``scale_tensor``)."""
    x = np.asarray(x, np.float32)
    lo, hi = x.min(), x.max()
    return (x - lo) / max(hi - lo, 1e-8)
