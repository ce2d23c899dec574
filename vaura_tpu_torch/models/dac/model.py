"""DAC codec: waveform -> codes (``encode``, the frozen front of a training
step) and codes -> 44.1 kHz waveform (``decode``).

Counterpart of ``vaura_tpu/models/dac/model.py:44-257``. Public layouts are
the JAX package's: codes ``[B, K, T]``, audio ``[B, 1, T * hop]``; inside,
the conv stacks run channels-first. The codec is never trained: both entry
points run without a graph.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vaura_tpu_torch.models.dac.layers import (
    Conv1d,
    DecoderBlock,
    EncoderBlock,
    Snake1d,
)

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

    @property
    def decoder_receptive_field_frames(self) -> int:
        """Half the decoder's receptive field in latent frames: the context a
        windowed decode needs on each side for its interior samples to equal
        a full decode's (the streaming generators' emit margin). Per level of
        stride ``s`` at cumulative upsampling ``f``: the transposed conv
        spreads an input at most ``1.5 s - 1`` positions, the three dilated
        residual convs ``3 * (1 + 3 + 9)``, both in ``1/f`` frames; plus the
        input and output convs (JAX ``dac/model.py:74-97``)."""
        half = 3.0
        f = 1
        for s in self.decoder_rates:
            f *= s
            half += (1.5 * s - 1.0) / f
            half += 39.0 / f
        return math.ceil(half + 3.0 / f)


def config_for_sample_rate(model_sr: int) -> DacConfig:
    """The published DAC models, keyed by ``model_sr``."""
    if model_sr not in MODEL_SR:
        raise ValueError(f"Invalid model samplerate {model_sr}")
    if model_sr in (44000, 44100):
        return DacConfig(sample_rate=44100, n_codebooks=9)
    if model_sr == 24000:
        return DacConfig(sample_rate=24000, n_codebooks=32)
    return DacConfig(sample_rate=16000, n_codebooks=12)


class DacSpec:
    """``{target, params}`` form of the codec, as
    ``vaura_tpu.models.dac.model.DacSpec``: the published configuration of
    ``model_sr`` with optional ``DacConfig`` field overrides (the tiny test
    configurations) in ``.config``, and ``ckpt_path`` (read by
    ``models.factory.maybe_load_pretrained``)."""

    def __init__(self, model_sr: int = 44100, ckpt_path: Optional[str] = None,
                 **overrides):
        base = config_for_sample_rate(model_sr)
        if overrides:
            valid = {f.name for f in dataclasses.fields(DacConfig)}
            unknown = set(overrides) - valid
            if unknown:
                raise TypeError(f"Unknown DAC config keys: {sorted(unknown)}")
            for key in ("encoder_rates", "decoder_rates"):
                if key in overrides:
                    overrides[key] = tuple(overrides[key])
            base = dataclasses.replace(base, **overrides)
        self.config = base
        self.ckpt_path = ckpt_path


class DacEncoder(nn.Module):
    """``[B, 1, T]`` -> ``[B, latent, T / hop]``."""

    def __init__(self, cfg: DacConfig, device=None):
        super().__init__()
        kw = dict(device=device, dtype=cfg.dtype)
        d = cfg.encoder_dim
        self.conv_in = Conv1d(1, d, 7, padding=3, **kw)
        blocks = []
        for stride in cfg.encoder_rates:
            d *= 2
            blocks.append(EncoderBlock(d, stride, **kw))
        self.blocks = nn.ModuleList(blocks)
        self.snake_out = Snake1d(d, **kw)
        self.conv_out = Conv1d(d, cfg.resolved_latent_dim, 3, padding=1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.blocks:
            x = block(x)
        return self.conv_out(self.snake_out(x))


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
    """Residual vector quantiser: per stage a codebook ``[V, cd]`` and
    folded 1x1 in- and out-projections ``[D, cd]`` / ``[cd, D]``. A stage
    projects the residual to ``codebook_dim``, takes the nearest codebook
    entry by cosine similarity, projects it back and subtracts it."""

    def __init__(self, cfg: DacConfig, device=None):
        super().__init__()
        K, V, cd, D = (cfg.n_codebooks, cfg.codebook_size, cfg.codebook_dim,
                       cfg.resolved_latent_dim)
        self.codebook_size = V
        self.codebooks = nn.Parameter(torch.empty(K, V, cd, device=device))
        self.in_proj_w = nn.Parameter(torch.empty(K, D, cd, device=device))
        self.in_proj_b = nn.Parameter(torch.zeros(K, cd, device=device))
        self.out_proj_w = nn.Parameter(torch.empty(K, cd, D, device=device))
        self.out_proj_b = nn.Parameter(torch.zeros(K, D, device=device))

    def encode(self, z: torch.Tensor, return_margins: bool = False):
        """``[B, T, D]`` latent -> ``[B, K, T]`` codes (int64). A near-tie at
        one stage changes every later stage of that frame; with
        ``return_margins`` the gap between the two best similarities of each
        choice comes back too, ``[B, K, T]``."""
        residual = z.float()
        codes, margins = [], []
        for cb, wi, bi, wo, bo in zip(self.codebooks, self.in_proj_w,
                                      self.in_proj_b, self.out_proj_w,
                                      self.out_proj_b):
            z_e = residual @ wi + bi
            z_en = z_e / (z_e.norm(dim=-1, keepdim=True) + 1e-8)
            cbn = cb / (cb.norm(dim=-1, keepdim=True) + 1e-8)
            sim = z_en @ cbn.t()  # [B, T, V]
            idx = sim.argmax(dim=-1)
            if return_margins:
                top2 = sim.topk(2, dim=-1).values
                margins.append(top2[..., 0] - top2[..., 1])
            residual = residual - (F.embedding(idx, cb) @ wo + bo)
            codes.append(idx)
        codes = torch.stack(codes, dim=1)
        return (codes, torch.stack(margins, dim=1)) if return_margins else codes

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
    """Encoder, RVQ and decoder; ``encode`` and ``decode`` are the entry
    points."""

    def __init__(self, cfg: DacConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = DacEncoder(cfg, device)
        self.quantizer = ResidualVectorQuantize(cfg, device)
        self.decoder = DacDecoder(cfg, device)

    def load_state_dict(self, state_dict, strict: bool = True, **kw):
        """A decode-only state dict (no ``encoder.*`` entry: what the JAX
        package's ``init(method=decode)`` tree converts to) loads the
        quantizer and the decoder and leaves the encoder as it is."""
        if not strict or any(k.startswith("encoder.") for k in state_dict):
            return super().load_state_dict(state_dict, strict=strict, **kw)
        result = super().load_state_dict(state_dict, strict=False, **kw)
        bad = [k for k in result.missing_keys if not k.startswith("encoder.")]
        if bad or result.unexpected_keys:
            raise RuntimeError(f"Dac.load_state_dict: missing {bad}, "
                               f"unexpected {result.unexpected_keys}")
        return result

    def preprocess(self, wav: torch.Tensor) -> torch.Tensor:
        """Right-pad ``[B, 1, T]`` with zeros to a multiple of the hop."""
        hop = self.cfg.hop_length
        return F.pad(wav, (0, (hop - wav.shape[-1] % hop) % hop))

    @torch.no_grad()
    def encode_latent(self, wav: torch.Tensor) -> torch.Tensor:
        """``[B, 1, T]`` waveform -> ``[B, T / hop, D]`` float32 latent."""
        z = self.encoder(self.preprocess(wav).to(self.cfg.dtype))
        return z.transpose(1, 2).float()

    @torch.no_grad()
    def encode(self, wav: torch.Tensor) -> torch.Tensor:
        """``[B, 1, T]`` waveform -> ``[B, K, T / hop]`` codes."""
        return self.quantizer.encode(self.encode_latent(wav))

    @torch.no_grad()
    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """``[B, K, T]`` codes -> ``[B, 1, T * hop]`` float32 waveform."""
        z_q = self.quantizer.from_codes(codes)  # [B, T, D]
        wav = self.decoder(z_q.transpose(1, 2).to(self.cfg.dtype))
        return wav.float()
