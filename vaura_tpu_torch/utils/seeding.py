"""Deterministic seeding (counterpart of ``vaura_tpu/utils/seeding.py``;
the reference's global seed is 666, ``main.py:83-87``).

Host randomness (python, numpy: the data pipeline) is seeded globally, as
is torch's default generator; device randomness draws from the explicit
``torch.Generator`` returned here, as JAX threads its root key.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from vaura_tpu_torch.utils import DeviceLike, resolve_device


def seed_everything(seed: int, device: DeviceLike = None) -> torch.Generator:
    """Seed python/numpy/torch host RNGs and return a generator on
    ``device`` (``resolve_device``'s rule: CUDA unless another is named)
    seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)
