"""Visual-feature bridges between the encoder and the sampler.

Counterpart of ``vaura_tpu/models/bridges.py`` (``IdentityBridge``,
``MLPBridge``). The shipped configuration uses the identity bridge
(``configs/modules/bridges/dummy_bridge.yaml``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class IdentityBridge(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class MLPBridge(nn.Module):
    """``fc2(act(fc1 x))`` in float32; ``gelu`` is flax's default, the tanh
    approximation."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 activation: str = "gelu", device=None):
        super().__init__()
        if activation not in ("gelu", "relu"):
            raise ValueError(f"unknown activation {activation}")
        self.activation = activation
        self.fc1 = nn.Linear(input_dim, hidden_dim, device=device)
        self.fc2 = nn.Linear(hidden_dim, output_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x.float())
        h = F.gelu(h, approximate="tanh") if self.activation == "gelu" else F.relu(h)
        return self.fc2(h)
