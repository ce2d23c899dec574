"""MotionFormer / Segment-AVCLIP visual encoder.

Counterpart of ``vaura_tpu/models/motionformer.py`` for the divided
space-time configuration: ``DividedSpaceTimeBlock`` in both of its forms,
separate positional and temporal embeddings (``:735-755``), final LayerNorm
and the per-frame ``SpatialAggregationLayer`` (``:627-692``).

  frames [B, S, C, T, H, W] -> features [B, S, t, D]   (t = T / z_block)

Two forms of the block, the same function of the same parameters:

  * fused sublayers (``:415-451``), inference only: three sublayers on the
    token stream with the CLS row carried apart: time attention on the
    n-major layout (groups = spatial locations, L = t frames), space
    attention on the f-major layout (groups = frames, L = hw locations),
    then the MLP; the CLS row's MLP runs outside the fused kernel (``:450``).
    The CUDA kernels behind them have no backward.
  * unfused (``:453-464``), what ``train=True`` runs: LayerNorm, q/k/v and
    output projections as plain matmuls, the grouped attention of both axes
    through ``ops.divided_attention.grouped_cls_attention``, stochastic
    depth and dropout. Differentiable.

``MotionFormer.forward`` takes the fused form only when ``not train`` (and
``fused_encoder_block`` is not False), as the JAX package does (``:773-805``).

Parameters are stored in ``param_dtype`` (float32 by default, what training
needs) and cast to the compute dtype at each use, as the JAX package does;
a system that only generates may store the matmul weights in the compute
dtype (``param_dtype=torch.bfloat16``), which rounds the same way once.
Biases, LayerNorm parameters and embeddings are always float32.

Not ported (no configuration of the ported paths uses them): the joint and
trajectory blocks, joint positional embeddings, average-pooling
aggregation, the temporal and global aggregation layers, unfactorised
output, the int8 encoder.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

import numpy as np

from vaura_tpu_torch.ops.divided_attention import grouped_cls_attention
from vaura_tpu_torch.ops.dropout import drop_path, dropout
from vaura_tpu_torch.ops.encoder_fused import (
    fused_attention_sublayer,
    fused_mlp_sublayer,
    layernorm,
)
from vaura_tpu_torch.utils import ANY, drop_unported_fields


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
    drop_rate: float = 0.0
    drop_path_rate: float = 0.2
    norm_eps: float = 1e-6
    # The unfused block's grouped attention always goes through
    # ``ops.divided_attention`` (the kernel on the card); the JAX package's
    # switch to a separate einsum path has no counterpart here.
    # Fused-sublayer blocks when not training: None and True take them,
    # False keeps the unfused block for inference too.
    fused_encoder_block: Optional[bool] = None
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32  # storage of the matmul weights

    @property
    def grid_hw(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_spatial_patches(self) -> int:
        return self.grid_hw * self.grid_hw

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


# MotionFormerConfig fields of the JAX package the port has no field for:
# the value of the one configuration the port runs (the divided ViT with
# separate positional embeddings, the spatial aggregation layer and no
# temporal or global one), or ANY where the field changes nothing here
# (knobs of the trajectory attention, the switch for JAX's own fused
# kernels, which the port always takes, the global aggregation's settings
# when it is off)
_JAX_ONLY_FIELDS = {
    "attn_drop_rate": 0.0,
    "pos_embed_type": "separate",
    "attn_layer": "divided",
    "approx_attn_type": ANY,
    "approx_attn_dim": ANY,
    "use_original_code": ANY,
    "fused_divided_attention": ANY,
    "quantize": False,
    "factorize_space_time": True,
    "agg_space_module": "TransformerEncoderLayer",
    "agg_time_module": "Identity",
    "add_global_repr": False,
    "agg_segments_module": ANY,
    "max_segments": ANY,
}


def MotionFormerSpec(
    extract_features: bool = True,
    ckpt_path: Optional[str] = None,
    factorize_space_time: bool = True,
    agg_space_module: str = "TransformerEncoderLayer",
    agg_time_module: str = "torch.nn.Identity",
    add_global_repr: bool = False,
    agg_segments_module: Optional[str] = None,
    max_segments: Optional[int] = None,
    **kwargs,
) -> MotionFormerConfig:
    """``MotionFormerConfig`` from the reference wrapper's parameter names,
    as ``vaura_tpu.models.motionformer.MotionFormerSpec``. ``ckpt_path`` is
    read by ``models.factory.maybe_load_pretrained``. A setting of a
    variant the port lacks raises ``NotImplementedError``."""
    kwargs = dict(
        kwargs, factorize_space_time=factorize_space_time,
        agg_space_module=agg_space_module,
        agg_time_module=("Identity" if "Identity" in agg_time_module
                         else agg_time_module),
        add_global_repr=add_global_repr)
    kwargs = drop_unported_fields(kwargs, _JAX_ONLY_FIELDS, "encoder")
    return MotionFormerConfig(**kwargs)


class Dense(nn.Module):
    """Weight ``[out, in]`` stored in ``param_dtype``, bias float32; both
    are cast to the compute dtype at use."""

    def __init__(self, i: int, o: int, cfg: MotionFormerConfig,
                 bias: bool = True, device=None):
        super().__init__()
        self.dtype = cfg.dtype
        self.weight = nn.Parameter(torch.empty(o, i, dtype=cfg.param_dtype,
                                               device=device))
        self.bias = (nn.Parameter(torch.zeros(o, device=device)) if bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


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
    """One divided-attention axis: the CLS token attends over every token;
    the other tokens attend within their group along one axis (time or
    space) with the CLS key/value appended to every group. The fused
    sublayer reads this module's projections; ``forward`` is the unfused
    form (``vaura_tpu/models/motionformer.py:284-374``)."""

    def __init__(self, cfg: MotionFormerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        self.qkv = Dense(D, 3 * D, cfg, bias=cfg.qkv_bias, device=device)
        self.proj = Dense(D, D, cfg, device=device)

    def forward(self, x: torch.Tensor, axis: str, f: int, n: int
                ) -> torch.Tensor:
        """``x [B, 1 + f*n, D]`` (CLS first, tokens f-major) -> the same
        shape."""
        cfg = self.cfg
        B, N, D = x.shape
        H, hd = cfg.num_heads, cfg.head_dim
        q, k, v = self.qkv(x).reshape(B, N, 3, H, hd).unbind(2)  # [B, N, H, hd]
        q = q * hd ** -0.5

        # the CLS query over every token, float32 softmax
        cls_scores = torch.einsum("bhd,bnhd->bhn", q[:, 0].float(), k.float())
        cls_p = torch.softmax(cls_scores, dim=-1).to(v.dtype)
        cls_out = torch.einsum("bhn,bnhd->bhd", cls_p, v)

        # group-major layout of the op: [BH, G, L, hd]
        if axis == "time":
            perm, G, L = (0, 3, 2, 1, 4), n, f   # [B, H, n, f, hd]
        elif axis == "space":
            perm, G, L = (0, 3, 1, 2, 4), f, n   # [B, H, f, n, hd]
        else:
            raise ValueError(axis)
        to_k = lambda t: (t[:, 1:].reshape(B, f, n, H, hd).permute(perm)
                          .reshape(B * H, G, L, hd))
        o = grouped_cls_attention(
            to_k(q), to_k(k), to_k(v), k[:, 0].reshape(B * H, 1, hd),
            v[:, 0].reshape(B * H, 1, hd))
        inv = (0, 3, 2, 1, 4) if axis == "time" else (0, 2, 3, 1, 4)
        out = o.reshape(B, H, G, L, hd).permute(inv).reshape(B, f * n, D)
        out = torch.cat([cls_out.reshape(B, 1, D).to(out.dtype), out], dim=1)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, cfg: MotionFormerConfig, device=None):
        super().__init__()
        self.drop_rate = cfg.drop_rate
        D = cfg.embed_dim
        self.fc1 = Dense(D, D * cfg.mlp_ratio, cfg, device=device)
        self.fc2 = Dense(D * cfg.mlp_ratio, D, cfg, device=device)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = dropout(F.gelu(self.fc1(x)), self.drop_rate, train, generator)
        return dropout(self.fc2(h), self.drop_rate, train, generator)


class DividedSpaceTimeBlock(nn.Module):
    """Time attention (no stochastic depth on its residual), space
    attention, MLP. ``forward`` is the fused-sublayer form (inference);
    ``forward_unfused`` the differentiable one."""

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

    def forward_unfused(self, x: torch.Tensor, f: int, n: int, train: bool,
                        drop_path_rate: float,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        """``x [B, 1 + f*n, D]`` (CLS first); ``drop_path_rate`` is this
        layer's rate of the linear schedule."""
        dp = lambda t: drop_path(
            t, drop_path_rate,
            train and self.cfg.drop_path_rate != 0.0, generator)
        x = x + self.timeattn(self.norm3(x), "time", f, n)
        x = x + dp(self.attn(self.norm1(x), "space", f, n))
        return x + dp(self.mlp(self.norm2(x), train, generator))


class SpatialAggregationLayer(nn.Module):
    """Pre-norm transformer encoder layer with a learned CLS token; returns
    the CLS output, aggregating ``[Bt, N, D]`` into ``[Bt, D]``."""

    def __init__(self, cfg: MotionFormerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.embed_dim, cfg.dtype
        self.cls_token = nn.Parameter(torch.empty(1, 1, D, device=device))
        self.norm1 = LayerNorm(D, cfg.norm_eps, dt, device)
        self.in_proj = Dense(D, 3 * D, cfg, device=device)
        self.out_proj = Dense(D, D, cfg, device=device)
        self.norm2 = LayerNorm(D, cfg.norm_eps, dt, device)
        self.linear1 = Dense(D, cfg.mlp_ratio * D, cfg, device=device)
        self.linear2 = Dense(cfg.mlp_ratio * D, D, cfg, device=device)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        drop = lambda t: dropout(t, cfg.drop_rate, train, generator)
        D, H, hd = cfg.embed_dim, cfg.num_heads, cfg.head_dim
        Bt, N, _ = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(Bt, 1, D), x], dim=1)
        q, k, v = self.in_proj(self.norm1(x)).chunk(3, dim=-1)
        heads = lambda t: t.reshape(Bt, N + 1, H, hd).transpose(1, 2)
        scores = torch.einsum("bhqd,bhkd->bhqk",
                              (heads(q) * hd ** -0.5).float(), heads(k).float())
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        attn = torch.einsum("bhqk,bhkd->bhqd", probs, heads(v))
        x = x + drop(self.out_proj(attn.transpose(1, 2).reshape(Bt, N + 1, D)))
        h = self.linear2(drop(F.gelu(self.linear1(self.norm2(x)))))
        return (x + drop(h))[:, 0]


class MotionFormer(nn.Module):
    """Divided space-time ViT feature extractor."""

    def __init__(self, cfg: MotionFormerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.embed_dim, cfg.dtype
        k = (cfg.z_block_size, cfg.patch_size, cfg.patch_size)
        self.patch_embed_3d = nn.Conv3d(cfg.in_chans, D, k, stride=k,
                                        dtype=cfg.param_dtype, device=device)
        self.cls_token = nn.Parameter(torch.empty(1, 1, D, device=device))
        hw = cfg.num_spatial_patches
        self.pos_embed = nn.Parameter(torch.empty(1, hw + 1, D, device=device))
        self.temp_embed = nn.Parameter(torch.zeros(1, cfg.temporal_resolution,
                                                   D, device=device))
        self.blocks = nn.ModuleList(DividedSpaceTimeBlock(cfg, device)
                                    for _ in range(cfg.depth))
        self.norm = LayerNorm(D, cfg.norm_eps, dt, device)
        self.spatial_attn_agg = SpatialAggregationLayer(cfg, device)

    def forward(self, frames: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``train`` turns on dropout and stochastic depth (masks drawn from
        ``generator``) and selects the unfused, differentiable blocks.
        Without ``train`` the fused sublayers run; their CUDA kernels have
        no backward, so on the card that path refuses to record a graph."""
        cfg = self.cfg
        B, S, C, T, H, W = frames.shape
        t, hw, D = T // cfg.z_block_size, cfg.num_spatial_patches, cfg.embed_dim
        dt = cfg.dtype
        x = frames.reshape(B * S, C, T, H, W).to(dt)
        pe = self.patch_embed_3d
        x = F.conv3d(x, pe.weight.to(dt), pe.bias.to(dt), stride=pe.stride)
        x = x.flatten(2).transpose(1, 2)  # [BS, t*hw, D]
        pos = self.pos_embed
        total = torch.cat(
            [pos[:, :1],
             pos[:, 1:].repeat(1, cfg.temporal_resolution, 1)
             + self.temp_embed.repeat_interleave(hw, dim=1)],
            dim=1,
        ).to(x.dtype)
        x = torch.cat([self.cls_token.to(x.dtype).expand(B * S, 1, D), x],
                      dim=1) + total
        x = dropout(x, cfg.drop_rate, train, generator)

        if cfg.fused_encoder_block is not False and not train:
            if x.is_cuda and torch.is_grad_enabled() and any(
                    p.requires_grad for p in self.parameters()):
                raise RuntimeError(
                    "the fused encoder sublayers have no backward: call "
                    "under torch.no_grad(), or with train=True for the "
                    "differentiable blocks")
            x_cls, x_tok = x[:, :1], x[:, 1:]
            for block in self.blocks:
                x_cls, x_tok = block(x_cls, x_tok, t, hw)
        else:
            dpr = np.linspace(0.0, cfg.drop_path_rate, cfg.depth)
            for block, rate in zip(self.blocks, dpr):
                x = block.forward_unfused(x, t, hw, train, float(rate),
                                          generator)
            x_tok = x[:, 1:]
        # per-frame aggregation of the hw locations (temporal aggregation is
        # the identity)
        x = self.spatial_attn_agg(self.norm(x_tok).reshape(B * S * t, hw, D),
                                  train, generator)
        return x.reshape(B, S, t, D)
