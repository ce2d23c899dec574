"""DAC codec, decode direction: codes -> 44.1 kHz waveform.

Counterpart of ``vaura_tpu/models/dac/model.py:44-257`` without the encoder
and the RVQ encode (not on the generation path). Public layouts are the JAX
package's: codes ``[B, K, T]``, audio ``[B, 1, T * hop]``; inside, the
decoder runs channels-first.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from vaura_tpu_torch.models.dac.layers import Conv1d, DecoderBlock, Snake1d

MODEL_SR = [16000, 24000, 44000, 44100]


@dataclasses.dataclass(frozen=True)
class DacConfig:
    sample_rate: int = 44100
    encoder_dim: int = 64
    encoder_rates: Tuple[int, ...] = (2, 4, 8, 8)
    decoder_dim: int = 1536
    decoder_rates: Tuple[int, ...] = (8, 8, 4, 2)
    latent_dim: Optional[int] = None
    n_codebooks: int = 9
    codebook_size: int = 1024
    codebook_dim: int = 8
    dtype: torch.dtype = torch.float32  # compute dtype of the conv stack

    @property
    def resolved_latent_dim(self) -> int:
        if self.latent_dim is not None:
            return self.latent_dim
        return self.encoder_dim * (2 ** len(self.encoder_rates))

    @property
    def hop_length(self) -> int:
        return int(math.prod(self.encoder_rates))


def config_for_sample_rate(model_sr: int) -> DacConfig:
    """The published DAC models, keyed by ``model_sr``."""
    if model_sr not in MODEL_SR:
        raise ValueError(f"Invalid model samplerate {model_sr}")
    if model_sr in (44000, 44100):
        return DacConfig(sample_rate=44100, n_codebooks=9)
    if model_sr == 24000:
        return DacConfig(sample_rate=24000, n_codebooks=32)
    return DacConfig(sample_rate=16000, n_codebooks=12)


class DacDecoder(nn.Module):
    """``[B, latent, T]`` -> ``[B, 1, T * hop]``."""

    def __init__(self, cfg: DacConfig, device=None):
        super().__init__()
        kw = dict(device=device, dtype=cfg.dtype)
        self.conv_in = Conv1d(cfg.resolved_latent_dim, cfg.decoder_dim, 7,
                              padding=3, **kw)
        dim = cfg.decoder_dim
        blocks = []
        for stride in cfg.decoder_rates:
            blocks.append(DecoderBlock(dim, dim // 2, stride, **kw))
            dim //= 2
        self.blocks = nn.ModuleList(blocks)
        self.snake_out = Snake1d(dim, **kw)
        self.conv_out = Conv1d(dim, 1, 7, padding=3, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(z)
        for block in self.blocks:
            x = block(x)
        return torch.tanh(self.conv_out(self.snake_out(x)))


class ResidualVectorQuantize(nn.Module):
    """The RVQ tables needed to turn codes back into the latent: per stage
    a codebook ``[V, cd]`` and a folded out-projection ``[cd, D]``."""

    def __init__(self, cfg: DacConfig, device=None):
        super().__init__()
        K, V, cd, D = (cfg.n_codebooks, cfg.codebook_size, cfg.codebook_dim,
                       cfg.resolved_latent_dim)
        self.codebook_size = V
        self.codebooks = nn.Parameter(torch.empty(K, V, cd, device=device))
        self.out_proj_w = nn.Parameter(torch.empty(K, cd, D, device=device))
        self.out_proj_b = nn.Parameter(torch.zeros(K, D, device=device))

    def from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """``[B, K, T]`` codes -> ``[B, T, D]`` latent (float32)."""
        B, Kc, T = codes.shape
        if Kc > self.codebooks.shape[0]:
            raise ValueError(f"{Kc} codebooks > {self.codebooks.shape[0]}")
        V = self.codebook_size
        flat = self.codebooks[:Kc].reshape(Kc * V, -1)
        idx = codes.long() + (torch.arange(Kc, device=codes.device) * V)[None, :, None]
        z_p = flat.index_select(0, idx.reshape(-1)).reshape(B, Kc, T, -1)
        z_q = torch.einsum("bktc,kcd->btd", z_p, self.out_proj_w[:Kc])
        return z_q + self.out_proj_b[:Kc].sum(0)[None, None, :]


class Dac(nn.Module):
    """Decode entry point of the codec."""

    def __init__(self, cfg: DacConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.quantizer = ResidualVectorQuantize(cfg, device)
        self.decoder = DacDecoder(cfg, device)

    @torch.no_grad()
    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """``[B, K, T]`` codes -> ``[B, 1, T * hop]`` float32 waveform."""
        z_q = self.quantizer.from_codes(codes)  # [B, T, D]
        wav = self.decoder(z_q.transpose(1, 2).to(self.cfg.dtype))
        return wav.float()
