"""DAC building blocks, channels-first ``[B, C, T]``.

Counterpart of ``vaura_tpu/models/dac/layers.py``. Weight norm is stored
folded (``W = g * v / ||v||``), as the JAX package stores it. Where the JAX
package uses TPU formulations, this port uses the direct ones: ``sin`` for
Snake's ``sin^2`` (JAX: the polynomial ``_sin2_poly``, max error ~5e-7)
and ``F.conv_transpose1d`` for the upsampling (JAX: the polyphase form,
exact). Snake is the operator ``torch.ops.vaura_torch.snake``
(``ops/snake.py``): one kernel on the card, plain PyTorch on the CPU.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vaura_tpu_torch.kernels.ops import snake_op


class Snake1d(nn.Module):
    """``x + sin^2(alpha x) / (alpha + 1e-9)`` with per-channel alpha."""

    def __init__(self, channels: int, device=None, dtype=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(channels, device=device,
                                             dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return snake_op(x, self.alpha.to(x.dtype))


# The JAX package's Conv1d (symmetric padding) and ConvTranspose1d
# (``out_len = (T-1)*s - 2p + k``) are torch's own layers here.
Conv1d = nn.Conv1d
ConvTranspose1d = nn.ConvTranspose1d


class ResidualUnit(nn.Module):
    """Snake -> dilated k=7 conv -> Snake -> k=1 conv, residual add."""

    def __init__(self, dim: int, dilation: int = 1, device=None, dtype=None):
        super().__init__()
        pad = ((7 - 1) * dilation) // 2
        kw = dict(device=device, dtype=dtype)
        self.snake1 = Snake1d(dim, **kw)
        self.conv1 = Conv1d(dim, dim, 7, padding=pad, dilation=dilation, **kw)
        self.snake2 = Snake1d(dim, **kw)
        self.conv2 = Conv1d(dim, dim, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.snake2(self.conv1(self.snake1(x))))
        return x + y


class EncoderBlock(nn.Module):
    """Three residual units, Snake, then a strided downsampling conv.
    ``dim`` is the number of output channels; the units run at ``dim // 2``."""

    def __init__(self, dim: int, stride: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        half = dim // 2
        self.res1 = ResidualUnit(half, 1, **kw)
        self.res2 = ResidualUnit(half, 3, **kw)
        self.res3 = ResidualUnit(half, 9, **kw)
        self.snake = Snake1d(half, **kw)
        self.down = Conv1d(half, dim, 2 * stride, stride=stride,
                           padding=math.ceil(stride / 2), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.res3(self.res2(self.res1(x)))
        return self.down(self.snake(x))


class DecoderBlock(nn.Module):
    """Snake, upsampling transposed conv, three residual units."""

    def __init__(self, input_dim: int, output_dim: int, stride: int,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.snake = Snake1d(input_dim, **kw)
        self.up = ConvTranspose1d(input_dim, output_dim, 2 * stride,
                                  stride=stride, padding=math.ceil(stride / 2),
                                  **kw)
        self.res1 = ResidualUnit(output_dim, 1, **kw)
        self.res2 = ResidualUnit(output_dim, 3, **kw)
        self.res3 = ResidualUnit(output_dim, 9, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.up(self.snake(x))
        return self.res3(self.res2(self.res1(x)))

