"""Visual-feature bridges between the encoder and the sampler.

Counterpart of ``vaura_tpu/models/bridges.py`` (``IdentityBridge``,
``MLPBridge``, ``ConvBridgeVisual``, ``ConvBridge2D``). The shipped
configuration uses the identity bridge
(``configs/modules/bridges/dummy_bridge.yaml``). Every bridge computes in
float32; ``gelu`` is flax's default, the tanh approximation.
"""

from __future__ import annotations

from typing import Sequence

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


def _same_pad(x: torch.Tensor, kernel: Sequence[int],
              stride: Sequence[int]) -> torch.Tensor:
    """Pad the trailing ``len(kernel)`` axes as flax's ``padding="SAME"``
    does: ``ceil(n / s)`` outputs, the extra element of an odd total
    padding at the end."""
    pads = []
    for n, k, s in zip(x.shape[-len(kernel):], kernel, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return F.pad(x, flat)


class _ConvBridge(nn.Module):
    conv_cls = None

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Sequence[int], stride: Sequence[int],
                 device=None):
        super().__init__()
        self.kernel_size, self.stride = tuple(kernel_size), tuple(stride)
        self.conv = self.conv_cls(in_channels, out_channels, self.kernel_size,
                                  self.stride, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _same_pad(x.float(), self.kernel_size, self.stride)
        return F.gelu(self.conv(x), approximate="tanh")


class ConvBridgeVisual(_ConvBridge):
    """3D conv + GELU on ``[B, C, T, H, W]`` features."""

    conv_cls = nn.Conv3d

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Sequence[int] = (1, 1, 1),
                 stride: Sequence[int] = (1, 1, 1), device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         device)


class ConvBridge2D(_ConvBridge):
    """2D conv + GELU on ``[B, C, H, W]`` features."""

    conv_cls = nn.Conv2d

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Sequence[int] = (1, 1),
                 stride: Sequence[int] = (1, 1), device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         device)
