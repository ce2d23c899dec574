"""MotionFormer / Segment-AVCLIP visual encoder, inference.

Counterpart of ``vaura_tpu/models/motionformer.py`` for the configuration
the generation path runs: divided space-time blocks in their fused-sublayer
form (``DividedSpaceTimeBlock``, ``:415-451``), separate positional and
temporal embeddings (``:735-755``), final LayerNorm and the per-frame
``SpatialAggregationLayer`` (``:627-692``).

  frames [B, S, C, T, H, W] -> features [B, S, t, D]   (t = T / z_block)

Each block runs three sublayers on the token stream with the CLS row
carried apart: time attention on the n-major layout (groups = spatial
locations, L = t frames), space attention on the f-major layout (groups =
frames, L = hw locations), then the MLP; the CLS row's MLP runs outside the
fused kernel (``:450``). The matmul weights are stored in the compute dtype
(JAX casts them at use); biases, LayerNorm parameters and embeddings stay
float32.

Not ported (no configuration of the generation path uses them): the joint
and trajectory blocks, joint positional embeddings, average-pooling
aggregation, the temporal and global aggregation layers, unfactorised
output.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vaura_tpu_torch.ops.encoder_fused import (
    fused_attention_sublayer,
    fused_mlp_sublayer,
    layernorm,
)


@dataclasses.dataclass(frozen=True)
class MotionFormerConfig:
    """Encoder hyperparameters; the defaults are the flagship divided
    ViT-B/16 over 16-frame 224x224 segments."""

    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    qkv_bias: bool = True
    temporal_resolution: int = 8
    z_block_size: int = 2
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16

    @property
    def grid_hw(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_spatial_patches(self) -> int:
        return self.grid_hw * self.grid_hw

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


class Dense(nn.Module):
    """Weight ``[out, in]`` in the compute dtype, bias float32."""

    def __init__(self, i: int, o: int, dtype, bias: bool = True, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(o, i, dtype=dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros(o, device=device)) if bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        b = None if self.bias is None else self.bias.to(w.dtype)
        return F.linear(x.to(w.dtype), w, b)


class LayerNorm(nn.Module):
    """Float32 LayerNorm, output in the compute dtype."""

    def __init__(self, dim: int, eps: float, dtype, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.scale, self.bias, self.eps).to(self.dtype)


class DividedAttention(nn.Module):
    """The q/k/v and output projections of one divided-attention axis."""

    def __init__(self, cfg: MotionFormerConfig, device=None):
        super().__init__()
        D = cfg.embed_dim
        self.qkv = Dense(D, 3 * D, cfg.dtype, bias=cfg.qkv_bias, device=device)
        self.proj = Dense(D, D, cfg.dtype, device=device)


class Mlp(nn.Module):
    def __init__(self, cfg: MotionFormerConfig, device=None):
        super().__init__()
        D = cfg.embed_dim
        self.fc1 = Dense(D, D * cfg.mlp_ratio, cfg.dtype, device=device)
        self.fc2 = Dense(D * cfg.mlp_ratio, D, cfg.dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class DividedSpaceTimeBlock(nn.Module):
    """Time attention, space attention, MLP; fused-sublayer form."""

    def __init__(self, cfg: MotionFormerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.embed_dim, cfg.dtype
        self.norm3 = LayerNorm(D, cfg.norm_eps, dt, device)
        self.timeattn = DividedAttention(cfg, device)
        self.norm1 = LayerNorm(D, cfg.norm_eps, dt, device)
        self.attn = DividedAttention(cfg, device)
        self.norm2 = LayerNorm(D, cfg.norm_eps, dt, device)
        self.mlp = Mlp(cfg, device)

    def _sublayer(self, norm: LayerNorm, att: DividedAttention, x_tok, x_cls,
                  L: int):
        return fused_attention_sublayer(
            x_tok, x_cls, norm.scale, norm.bias, att.qkv.weight, att.qkv.bias,
            att.proj.weight, att.proj.bias, num_heads=self.cfg.num_heads, L=L,
            eps=self.cfg.norm_eps)

    def forward(self, x_cls: torch.Tensor, x_tok: torch.Tensor, f: int, n: int):
        """``x_cls [B, 1, D]``, ``x_tok [B, f*n, D]`` f-major."""
        B, _, D = x_tok.shape
        xt = x_tok.reshape(B, f, n, D).transpose(1, 2).reshape(B, n * f, D)
        y_tok, x_cls = self._sublayer(self.norm3, self.timeattn, xt, x_cls, f)
        x_tok = y_tok.reshape(B, n, f, D).transpose(1, 2).reshape(B, f * n, D)
        x_tok, x_cls = self._sublayer(self.norm1, self.attn, x_tok, x_cls, n)
        x_tok = fused_mlp_sublayer(
            x_tok, self.norm2.scale, self.norm2.bias, self.mlp.fc1.weight,
            self.mlp.fc1.bias, self.mlp.fc2.weight, self.mlp.fc2.bias,
            eps=self.cfg.norm_eps)
        x_cls = x_cls + self.mlp(self.norm2(x_cls))
        return x_cls, x_tok


class SpatialAggregationLayer(nn.Module):
    """Pre-norm transformer encoder layer with a learned CLS token; returns
    the CLS output, aggregating ``[Bt, N, D]`` into ``[Bt, D]``."""

    def __init__(self, cfg: MotionFormerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.embed_dim, cfg.dtype
        self.cls_token = nn.Parameter(torch.empty(1, 1, D, device=device))
        self.norm1 = LayerNorm(D, cfg.norm_eps, dt, device)
        self.in_proj = Dense(D, 3 * D, dt, device=device)
        self.out_proj = Dense(D, D, dt, device=device)
        self.norm2 = LayerNorm(D, cfg.norm_eps, dt, device)
        self.linear1 = Dense(D, cfg.mlp_ratio * D, dt, device=device)
        self.linear2 = Dense(cfg.mlp_ratio * D, D, dt, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        D, H, hd = cfg.embed_dim, cfg.num_heads, cfg.head_dim
        Bt, N, _ = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(Bt, 1, D), x], dim=1)
        q, k, v = self.in_proj(self.norm1(x)).chunk(3, dim=-1)
        heads = lambda t: t.reshape(Bt, N + 1, H, hd).transpose(1, 2)
        scores = torch.einsum("bhqd,bhkd->bhqk",
                              (heads(q) * hd ** -0.5).float(), heads(k).float())
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        attn = torch.einsum("bhqk,bhkd->bhqd", probs, heads(v))
        x = x + self.out_proj(attn.transpose(1, 2).reshape(Bt, N + 1, D))
        h = self.linear2(F.gelu(self.linear1(self.norm2(x))))
        return (x + h)[:, 0]


class MotionFormer(nn.Module):
    """Divided space-time ViT feature extractor (inference)."""

    def __init__(self, cfg: MotionFormerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.embed_dim, cfg.dtype
        k = (cfg.z_block_size, cfg.patch_size, cfg.patch_size)
        self.patch_embed_3d = nn.Conv3d(cfg.in_chans, D, k, stride=k, dtype=dt,
                                        device=device)
        self.cls_token = nn.Parameter(torch.empty(1, 1, D, device=device))
        hw = cfg.num_spatial_patches
        self.pos_embed = nn.Parameter(torch.empty(1, hw + 1, D, device=device))
        self.temp_embed = nn.Parameter(torch.zeros(1, cfg.temporal_resolution,
                                                   D, device=device))
        self.blocks = nn.ModuleList(DividedSpaceTimeBlock(cfg, device)
                                    for _ in range(cfg.depth))
        self.norm = LayerNorm(D, cfg.norm_eps, dt, device)
        self.spatial_attn_agg = SpatialAggregationLayer(cfg, device)

    @torch.no_grad()
    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, S, C, T, H, W = frames.shape
        t, hw, D = T // cfg.z_block_size, cfg.num_spatial_patches, cfg.embed_dim
        x = frames.reshape(B * S, C, T, H, W).to(cfg.dtype)
        x = self.patch_embed_3d(x).flatten(2).transpose(1, 2)  # [BS, t*hw, D]
        pos = self.pos_embed
        total = torch.cat(
            [pos[:, :1],
             pos[:, 1:].repeat(1, cfg.temporal_resolution, 1)
             + self.temp_embed.repeat_interleave(hw, dim=1)],
            dim=1,
        ).to(x.dtype)
        x_cls = (self.cls_token.to(x.dtype) + total[:, :1]).expand(B * S, 1, D)
        x_tok = x + total[:, 1:]
        for block in self.blocks:
            x_cls, x_tok = block(x_cls, x_tok, t, hw)
        # per-frame aggregation of the hw locations (temporal aggregation is
        # the identity)
        x = self.spatial_attn_agg(self.norm(x_tok).reshape(B * S * t, hw, D))
        return x.reshape(B, S, t, D)
