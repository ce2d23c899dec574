"""MotionFormer / Segment-AVCLIP visual encoder.

Counterpart of ``vaura_tpu/models/motionformer.py``:

  frames [B, S, C, T, H, W] -> features [B, S, t, D]   (t = T / z_block)

with every block layout and aggregation head of the JAX package:

  * ``attn_layer``: ``divided`` (``DividedSpaceTimeBlock``: time, then
    space attention), ``joint`` (``JointSpaceTimeBlock``: one attention
    over all ``1 + t*hw`` tokens, ``joint_224_16x4.yaml``) or
    ``trajectory`` (``TrajectoryBlock``: trajectory attention,
    ``motionformer_224_16x4.yaml``; ``approx_attn_type`` none, nystrom,
    orthoformer or performer, ``ops/trajectory_attention.py``);
  * ``pos_embed_type``: ``separate`` (spatial table tiled over time plus a
    temporal table) or ``joint`` (one ``st_embed`` over all tokens);
  * ``agg_space_module``: the per-frame CLS layer (``spatial_attn_agg``) or
    ``AveragePooling``; ``agg_time_module``: ``Identity``, the temporal CLS
    layer (``temp_attn_agg``) or ``AveragePooling``; ``add_global_repr``:
    a clip-level vector over the segments (``global_attn_agg``, a CLS layer
    with positional embeddings, or ``agg_segments_module:
    AveragePooling``); ``factorize_space_time=False``: the token features
    ``[B, S, t*hw, D]`` with no aggregation;
  * ``quantize``: the int8 encoder (the JAX package's ``EncDense``): the
    divided attentions' projections and every block's MLP take int8
    weights (``kernel_q [out, in]``, ``scale [out]``,
    ``ops.quantization.quantize_encoder_params``) and int8 activation rows
    quantized on the fly, an exact int32 product, rescaled in float32.

The divided block has two forms, the same function of the same parameters:

  * fused sublayers (``:415-451``), inference only: three sublayers on the
    token stream with the CLS row carried apart: time attention on the
    n-major layout (groups = spatial locations, L = t frames), space
    attention on the f-major layout (groups = frames, L = hw locations),
    then the MLP; the CLS row's MLP runs outside the fused kernel (``:450``).
    The CUDA kernels behind them have no backward.
  * unfused (``:453-464``), what ``train=True`` and the int8 encoder run:
    LayerNorm, q/k/v and output projections as matmuls, the grouped
    attention of both axes through
    ``ops.divided_attention.grouped_cls_attention``, stochastic depth and
    dropout. Differentiable.

``MotionFormer.forward`` takes the fused form only for divided blocks, not
``quantize``, not ``train`` and ``fused_encoder_block`` not False, as the
JAX package does (``:773-805``); on the card also only within the JAX
package's shape contract (``:783-796``), outside which the unfused blocks
run. On the CPU the plain versions take any shape.

Parameters are stored in ``param_dtype`` (float32 by default, what training
needs) and cast to the compute dtype at each use, as the JAX package does;
a system that only generates may store the matmul weights in the compute
dtype (``param_dtype=torch.bfloat16``), which rounds the same way once.
Biases, LayerNorm parameters and embeddings are always float32.

The trajectory block's orthoformer and performer draw their randomness
(the first landmarks, the random features) from a CPU generator seeded with
``APPROX_SEED``, the same draw in every block and every call (drawn once a
shape and device, then kept), as the JAX package draws from ``PRNGKey(0)``
in every block; the two packages' draws differ (``jax.random`` cannot be
reproduced), the functions do not.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

import numpy as np

from vaura_tpu_torch.ops import trajectory_attention as TA
from vaura_tpu_torch.ops.divided_attention import grouped_cls_attention
from vaura_tpu_torch.ops.dropout import drop_path, dropout
from vaura_tpu_torch.ops.encoder_fused import (
    fused_attention_sublayer,
    fused_mlp_sublayer,
    layernorm,
)
from vaura_tpu_torch.ops.quantization import int8_dense
from vaura_tpu_torch.utils import ANY, drop_unported_fields
from vaura_tpu_torch.utils.spans import span

TEL = "TransformerEncoderLayer"
AVG = "AveragePooling"
# the fused sublayers' group length limit of the JAX package's shape
# contract (``vaura_tpu/ops/encoder_fused.py::_MAX_ROWS``)
FUSED_MAX_GROUP = 512
# the seed of the trajectory block's orthoformer / performer draws
APPROX_SEED = 0


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
    pos_embed_type: str = "separate"  # separate | joint
    attn_layer: str = "divided"  # divided | joint | trajectory
    approx_attn_type: str = "none"  # none | nystrom | orthoformer | performer
    approx_attn_dim: int = 128  # landmarks / random features
    use_original_code: bool = True  # trajectory temporal values = points
    norm_eps: float = 1e-6
    # The unfused block's grouped attention always goes through
    # ``ops.divided_attention`` (the kernel on the card); the JAX package's
    # switch to a separate einsum path has no counterpart here.
    # Fused-sublayer blocks when not training: None and True take them,
    # False keeps the unfused block for inference too.
    fused_encoder_block: Optional[bool] = None
    quantize: bool = False  # the int8 encoder (inference)
    factorize_space_time: bool = True
    agg_space_module: str = TEL  # | AveragePooling
    agg_time_module: str = "Identity"  # | TransformerEncoderLayer | AveragePooling
    add_global_repr: bool = False
    agg_segments_module: str = TEL  # | AveragePooling
    max_segments: int = 16
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32  # storage of the matmul weights

    @property
    def grid_hw(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_spatial_patches(self) -> int:
        return self.grid_hw * self.grid_hw

    @property
    def num_patches(self) -> int:
        return self.num_spatial_patches * self.temporal_resolution

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


# MotionFormerConfig fields of the JAX package the port has no field for,
# each of which changes nothing here: a rate the JAX package never reads,
# and the switch for JAX's own grouped-attention kernel, which the port
# always takes
_JAX_ONLY_FIELDS = {
    "attn_drop_rate": ANY,
    "fused_divided_attention": ANY,
}


def MotionFormerSpec(
    extract_features: bool = True,
    ckpt_path: Optional[str] = None,
    factorize_space_time: bool = True,
    agg_space_module: str = TEL,
    agg_time_module: str = "torch.nn.Identity",
    add_global_repr: bool = False,
    agg_segments_module: Optional[str] = None,
    max_segments: Optional[int] = None,
    **kwargs,
) -> MotionFormerConfig:
    """``MotionFormerConfig`` from the reference wrapper's parameter names,
    as ``vaura_tpu.models.motionformer.MotionFormerSpec``. ``ckpt_path`` is
    read by ``models.factory.maybe_load_pretrained``."""
    kwargs = dict(
        kwargs, factorize_space_time=factorize_space_time,
        agg_space_module=agg_space_module,
        agg_time_module=("Identity" if "Identity" in agg_time_module
                         else agg_time_module),
        add_global_repr=add_global_repr,
        agg_segments_module=(TEL if agg_segments_module is None
                             else agg_segments_module),
        max_segments=16 if max_segments is None else max_segments)
    kwargs = drop_unported_fields(kwargs, _JAX_ONLY_FIELDS, "encoder")
    return MotionFormerConfig(**kwargs)


class Dense(nn.Module):
    """Weight ``[out, in]`` stored in ``param_dtype``, bias float32; both
    are cast to the compute dtype at use. A ``quantizable`` layer of an
    int8 encoder (``cfg.quantize``) holds ``kernel_q [out, in]`` int8 and
    ``scale [out]`` float32 buffers instead of the weight and computes
    ``ops.quantization.int8_dense``."""

    def __init__(self, i: int, o: int, cfg: MotionFormerConfig,
                 bias: bool = True, device=None, quantizable: bool = False):
        super().__init__()
        self.dtype = cfg.dtype
        self.quantized = quantizable and cfg.quantize
        if self.quantized:
            self.register_buffer("kernel_q", torch.zeros(
                o, i, dtype=torch.int8, device=device))
            self.register_buffer("scale", torch.ones(o, device=device))
        else:
            self.weight = nn.Parameter(torch.empty(o, i, dtype=cfg.param_dtype,
                                                   device=device))
        self.bias = (nn.Parameter(torch.zeros(o, device=device)) if bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if self.quantized:
            return int8_dense(x, self.kernel_q, self.scale,
                              self.bias).to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)

    def first_outputs(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """The first ``n`` outputs only (float weights)."""
        dt = self.dtype
        b = None if self.bias is None else self.bias[:n].to(dt)
        return F.linear(x.to(dt), self.weight[:n].to(dt), b)


class LayerNorm(nn.Module):
    """Float32 LayerNorm, output in the compute dtype."""

    def __init__(self, dim: int, eps: float, dtype, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.scale, self.bias, self.eps).to(self.dtype)


def softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                      ) -> torch.Tensor:
    """``[B, H, Nq, d]`` q (pre-scaled) over ``[B, H, Nk, d]`` k/v: float32
    scores and softmax, probabilities cast to the value dtype."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


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
        self.qkv = Dense(D, 3 * D, cfg, bias=cfg.qkv_bias, device=device,
                         quantizable=True)
        self.proj = Dense(D, D, cfg, device=device, quantizable=True)

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
        self.fc1 = Dense(D, D * cfg.mlp_ratio, cfg, device=device,
                         quantizable=True)
        self.fc2 = Dense(D * cfg.mlp_ratio, D, cfg, device=device,
                         quantizable=True)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = dropout(F.gelu(self.fc1(x)), self.drop_rate, train, generator)
        return dropout(self.fc2(h), self.drop_rate, train, generator)


class _Block(nn.Module):
    """What every block layout shares: ``forward_unfused(x [B, 1 + f*n, D],
    f, n, train, drop_path_rate, generator)``, the differentiable form
    (the only one of the joint and trajectory layouts), and stochastic depth
    on a residual branch (off when the configuration's rate is 0)."""

    def _drop_path(self, t: torch.Tensor, rate: float, train: bool,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
        return drop_path(t, rate, train and self.cfg.drop_path_rate != 0.0,
                         generator)


class DividedSpaceTimeBlock(_Block):
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
        dp = lambda t: self._drop_path(t, drop_path_rate, train, generator)
        x = x + self.timeattn(self.norm3(x), "time", f, n)
        x = x + dp(self.attn(self.norm1(x), "space", f, n))
        return x + dp(self.mlp(self.norm2(x), train, generator))


class JointSpaceTimeBlock(_Block):
    """Pre-norm ViT block with one attention over all ``1 + f*n`` tokens
    (``vaura_tpu/models/motionformer.py:475-513``)."""

    def __init__(self, cfg: MotionFormerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.embed_dim, cfg.dtype
        self.norm1 = LayerNorm(D, cfg.norm_eps, dt, device)
        self.attn_qkv = Dense(D, 3 * D, cfg, bias=cfg.qkv_bias, device=device)
        self.attn_proj = Dense(D, D, cfg, device=device)
        self.norm2 = LayerNorm(D, cfg.norm_eps, dt, device)
        self.mlp = Mlp(cfg, device)

    def forward_unfused(self, x: torch.Tensor, f: int, n: int, train: bool,
                        drop_path_rate: float,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        cfg = self.cfg
        B, N, D = x.shape
        H, hd = cfg.num_heads, cfg.head_dim
        dp = lambda t: self._drop_path(t, drop_path_rate, train, generator)
        q, k, v = self.attn_qkv(self.norm1(x)).chunk(3, dim=-1)
        heads = lambda t: t.reshape(B, N, H, hd).transpose(1, 2)
        out = softmax_attention(heads(q) * hd ** -0.5, heads(k), heads(v))
        x = x + dp(self.attn_proj(out.transpose(1, 2).reshape(B, N, D)))
        return x + dp(self.mlp(self.norm2(x), train, generator))


class TrajectoryBlock(_Block):
    """Pre-norm ViT block with trajectory attention
    (``vaura_tpu/models/motionformer.py:516-624``): the CLS token attends
    globally; every other token first forms one trajectory point per frame
    (``ops.trajectory_attention``, exact or approximated), then attends
    along its trajectory with its own frame's point as the query. With
    ``use_original_code`` the temporal values are the trajectory points and
    the value half of ``attn_proj_kv`` is never read, so only its key half
    (the first D outputs) is computed; the parameter keeps both."""

    def __init__(self, cfg: MotionFormerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, dt, qb = cfg.embed_dim, cfg.dtype, cfg.qkv_bias
        self.norm1 = LayerNorm(D, cfg.norm_eps, dt, device)
        self.attn_qkv = Dense(D, 3 * D, cfg, bias=qb, device=device)
        self.attn_proj_q = Dense(D, D, cfg, bias=qb, device=device)
        self.attn_proj_kv = Dense(D, 2 * D, cfg, bias=qb, device=device)
        self.attn_proj = Dense(D, D, cfg, device=device)
        self.norm2 = LayerNorm(D, cfg.norm_eps, dt, device)
        self.mlp = Mlp(cfg, device)

    def approx_draws(self, BH: int, N: int, device) -> dict:
        """The randomness of the spatial step's approximation:
        orthoformer's first landmarks, performer's features."""
        cfg = self.cfg
        if cfg.approx_attn_type == "orthoformer":
            return {"first": _approx_draw("first", BH, N, device)}
        if cfg.approx_attn_type == "performer":
            return {"proj": _approx_draw("proj", cfg.approx_attn_dim,
                                         cfg.head_dim, device)}
        return {}

    def _spatial(self, q, k, v, f: int) -> torch.Tensor:
        cfg = self.cfg
        kind = cfg.approx_attn_type
        if kind == "nystrom":
            return TA.nystrom_spatial_attn(
                q, k, v, landmarks=cfg.approx_attn_dim, num_frames=f)
        draws = self.approx_draws(q.shape[0], q.shape[1], q.device)
        if kind == "orthoformer":
            return TA.orthoformer(q, k, v, num_landmarks=cfg.approx_attn_dim,
                                  num_frames=f, **draws)
        if kind == "performer":
            return TA.performer_spatial_attn(
                q, k, v, num_frames=f, num_features=cfg.approx_attn_dim,
                **draws)
        return TA.trajectory_spatial_full(q, k, v, num_frames=f)

    def forward_unfused(self, x: torch.Tensor, f: int, n: int, train: bool,
                        drop_path_rate: float,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        cfg = self.cfg
        B, N1, D = x.shape
        N, H, hd = f * n, cfg.num_heads, cfg.head_dim
        scale = hd ** -0.5
        dp = lambda t: self._drop_path(t, drop_path_rate, train, generator)
        q, k, v = self.attn_qkv(self.norm1(x)).chunk(3, dim=-1)
        heads = lambda t: t.reshape(B, N1, H, hd).transpose(1, 2)
        q, k, v = heads(q), heads(k), heads(v)  # [B, H, N1, hd]

        # the CLS query over every key
        cls_out = softmax_attention(q[:, :, :1] * scale, k, v)
        cls_out = cls_out.transpose(1, 2).reshape(B, 1, D)

        # spatial step on the other tokens, heads folded: [B*H, N, f, hd]
        fold = lambda t: t[:, :, 1:].reshape(B * H, N, hd)
        traj_h = self._spatial(fold(q), fold(k), fold(v), f).reshape(
            B, H, N, f, hd)
        x_traj = traj_h.permute(0, 2, 3, 1, 4).reshape(B, N, f, D)

        # temporal step: token (fi, p) queries with its own frame's point
        x_diag = torch.diagonal(x_traj.reshape(B, f, n, f, D), dim1=1, dim2=3)
        x_diag = x_diag.permute(0, 3, 1, 2).reshape(B, N, D)
        q2 = self.attn_proj_q(x_diag).reshape(B, N, H, hd).transpose(1, 2)
        heads5 = lambda t: t.reshape(B, N, f, H, hd).permute(0, 3, 1, 2, 4)
        if cfg.use_original_code:
            k2, t_vals = self.attn_proj_kv.first_outputs(x_traj, D), traj_h
        else:
            k2, v2 = self.attn_proj_kv(x_traj).chunk(2, dim=-1)
            t_vals = heads5(v2)
        t_scores = torch.einsum("bhnd,bhnfd->bhnf", (q2 * scale).float(),
                                heads5(k2).float())
        t_probs = torch.softmax(t_scores, dim=-1).to(t_vals.dtype)
        out = torch.einsum("bhnf,bhnfd->bhnd", t_probs, t_vals)
        out = torch.cat([cls_out.to(out.dtype),
                         out.transpose(1, 2).reshape(B, N, D)], dim=1)
        out = dropout(self.attn_proj(out), cfg.drop_rate, train, generator)
        x = x + dp(out)
        return x + dp(self.mlp(self.norm2(x), train, generator))


@functools.lru_cache(maxsize=16)
def _approx_draw(kind: str, a: int, b: int, device) -> torch.Tensor:
    """One draw from a CPU generator seeded with ``APPROX_SEED`` (so the card
    and the CPU draw alike), moved to ``device``; kept, since every block
    and every call draws the same: ``first_landmarks(a rows, b tokens)`` or
    ``orthogonal_gaussian(a features, b dims)``."""
    gen = torch.Generator().manual_seed(APPROX_SEED)
    if kind == "first":
        return TA.first_landmarks(a, b, gen, device)
    return TA.orthogonal_gaussian(a, b, gen, device)


class SpatialAggregationLayer(nn.Module):
    """Pre-norm transformer encoder layer with a learned CLS token; returns
    the CLS output, aggregating ``[Bt, N, D]`` into ``[Bt, D]``. With
    ``add_pos_emb`` it adds learned positional embeddings over the CLS and
    ``N <= pos_max_len`` inputs (the temporal and global aggregation of the
    reference wrapper)."""

    def __init__(self, cfg: MotionFormerConfig, device=None,
                 add_pos_emb: bool = False, pos_max_len: int = 16):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.embed_dim, cfg.dtype
        self.pos_max_len = pos_max_len
        self.cls_token = nn.Parameter(torch.empty(1, 1, D, device=device))
        self.pos_emb = (nn.Parameter(torch.empty(1, 1 + pos_max_len, D,
                                                 device=device))
                        if add_pos_emb else None)
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
        if self.pos_emb is not None:
            if N > self.pos_max_len:
                raise ValueError(f"{N} inputs, at most {self.pos_max_len}")
            x = drop(x + self.pos_emb[:, :N + 1].to(x.dtype))
        q, k, v = self.in_proj(self.norm1(x)).chunk(3, dim=-1)
        heads = lambda t: t.reshape(Bt, N + 1, H, hd).transpose(1, 2)
        attn = softmax_attention(heads(q) * hd ** -0.5, heads(k), heads(v))
        x = x + drop(self.out_proj(attn.transpose(1, 2).reshape(Bt, N + 1, D)))
        h = self.linear2(drop(F.gelu(self.linear1(self.norm2(x)))))
        return (x + drop(h))[:, 0]


_BLOCKS = {"joint": JointSpaceTimeBlock, "trajectory": TrajectoryBlock}


class MotionFormer(nn.Module):
    """Space-time ViT feature extractor (see the module docstring)."""

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
        if cfg.pos_embed_type == "separate":
            self.temp_embed = nn.Parameter(torch.zeros(
                1, cfg.temporal_resolution, D, device=device))
        else:
            self.st_embed = nn.Parameter(torch.empty(
                1, cfg.num_patches + 1, D, device=device))
        block = _BLOCKS.get(cfg.attn_layer, DividedSpaceTimeBlock)
        self.blocks = nn.ModuleList(block(cfg, device)
                                    for _ in range(cfg.depth))
        self.norm = LayerNorm(D, cfg.norm_eps, dt, device)
        # the aggregation layers the configuration runs, as the JAX
        # package's parameter tree holds them
        fac = cfg.factorize_space_time
        if fac and cfg.agg_space_module == TEL:
            self.spatial_attn_agg = SpatialAggregationLayer(cfg, device)
        if fac and cfg.agg_time_module == TEL:
            self.temp_attn_agg = SpatialAggregationLayer(cfg, device)
        if (fac and cfg.add_global_repr and cfg.agg_time_module in (TEL, AVG)
                and cfg.agg_segments_module != AVG):
            self.global_attn_agg = SpatialAggregationLayer(
                cfg, device, add_pos_emb=True, pos_max_len=cfg.max_segments)

    def _fused(self, x: torch.Tensor, train: bool, t: int, hw: int) -> bool:
        cfg = self.cfg
        if (train or cfg.fused_encoder_block is False or cfg.quantize
                or not isinstance(self.blocks[0], DividedSpaceTimeBlock)):
            return False
        if not x.is_cuda:
            return True
        D, hd = cfg.embed_dim, cfg.head_dim
        return (D % 128 == 0 and 128 % hd == 0
                and (D * cfg.mlp_ratio) % D == 0
                and t <= FUSED_MAX_GROUP and hw <= FUSED_MAX_GROUP)

    def forward(self, frames: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                return_global: bool = False):
        """Features ``[B, S, t, D]`` (``[B, S, D]`` with temporal
        aggregation, ``[B, S, t*hw, D]`` unfactorised); with
        ``return_global`` the pair ``(features, global_repr)``, the second
        ``[B, D]`` or None, as the JAX package returns. ``train`` turns on
        dropout and stochastic depth (masks drawn from ``generator``) and
        selects the unfused, differentiable blocks. Without ``train`` the
        divided blocks take the fused sublayers; their CUDA kernels have no
        backward, so on the card that path refuses to record a graph."""
        cfg = self.cfg
        B, S, C, T, H, W = frames.shape
        t, hw, D = T // cfg.z_block_size, cfg.num_spatial_patches, cfg.embed_dim
        dt = cfg.dtype
        with span("encoder.embed"):
            x = frames.reshape(B * S, C, T, H, W).to(dt)
            pe = self.patch_embed_3d
            x = F.conv3d(x, pe.weight.to(dt), pe.bias.to(dt), stride=pe.stride)
            x = x.flatten(2).transpose(1, 2)  # [BS, t*hw, D]
            if cfg.pos_embed_type == "separate":
                pos = self.pos_embed
                total = torch.cat(
                    [pos[:, :1],
                     pos[:, 1:].repeat(1, cfg.temporal_resolution, 1)
                     + self.temp_embed.repeat_interleave(hw, dim=1)],
                    dim=1,
                )
            else:
                total = self.st_embed
            x = torch.cat([self.cls_token.to(x.dtype).expand(B * S, 1, D), x],
                          dim=1) + total.to(x.dtype)
            x = dropout(x, cfg.drop_rate, train, generator)

        with span("encoder.blocks"):
            if self._fused(x, train, t, hw):
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
        with span("encoder.pool"):
            x = self.norm(x_tok)
            done = (lambda f, g=None: (f, g)) if return_global else (lambda f: f)
            if not cfg.factorize_space_time:
                return done(x.reshape(B, S, t * hw, D))

            x = x.reshape(B * S, t, hw, D)
            if cfg.agg_space_module == TEL:  # per frame over its hw locations
                x = self.spatial_attn_agg(x.reshape(B * S * t, hw, D), train,
                                          generator).reshape(B * S, t, D)
            else:
                x = x.mean(dim=2)
            if cfg.agg_time_module == TEL:
                x = self.temp_attn_agg(x, train, generator)
            elif cfg.agg_time_module == AVG:
                x = x.mean(dim=1)
            feats = x.reshape(B, S, *x.shape[1:])
            if not return_global:
                return feats
            global_repr = None
            if cfg.add_global_repr and feats.ndim == 3:
                global_repr = (feats.mean(dim=1) if cfg.agg_segments_module == AVG
                               else self.global_attn_agg(feats, train, generator))
            return feats, global_repr
