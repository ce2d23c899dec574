"""Multi-codebook autoregressive sampler (Llama-style decoder): the
teacher-forced forward of training and the decode path of generation.

Counterpart of ``vaura_tpu/models/sampler.py``: per-codebook token
embeddings (DAC-factored and weight-normed, or a plain table), AVCLIP visual
features projected and fused by channel concatenation, interleaved RoPE,
RMSNorm + SwiGLU blocks, one fused LM head for all codebooks.

Compute runs in ``config.dtype`` (bf16 by default). The matmul weights are
stored in ``config.param_dtype`` (float32 by default, what the optimizer
updates) and cast to the compute dtype at each use, as the JAX package
does; a system that only generates may store them in the compute dtype
(``param_dtype=torch.bfloat16``), which rounds the same way once. Norms,
embeddings and the softmax stay float32.

Every stochastic operation of ``forward(train=True)`` (token, ``wo`` and
feed-forward dropout, attention dropout, stochastic depth, the CFG
``token_drop``) draws its mask from the explicit ``generator``; under a
mesh, this rank's rows and heads of the one-process draw
(``ops/dropout.py::batch_shard``).

The KV cache is one preallocated ``[L, B, S, H_kv, hd]`` buffer per key and
value: bf16, or int8 with float32 ``k_scale``/``v_scale [L, B, S, H_kv]``
(``quantize_cache``; ``ops/quantization.py::quantize_kv``), or int4 packed
two a byte into ``[L, B, S, H_kv, hd / 2]`` int8 with the same scales
(``cache_bits=4``; ``quantize_kv4``). ``int8_dots`` reads a quantized cache
with int8 x int8 attention products, whose probabilities are quantized per
group of cache rows: the groups' first rows are the cache dict's
``chunk_starts`` (an int32 tensor; ``init_cache`` and ``prefill`` make one
group, ``[0]``), which ``VauraSystem``'s decode loops set to the JAX
package's chunk buffers. A
layer never writes the cache: it reads the rows below the current one through
``ops.decode_attention`` and returns the current position's K/V, which
``decode_step`` commits in place after the step, quantized for an int8
cache (the JAX package's contract, ``sampler.py:228-238,864-883``; in place
here, where JAX returns an updated copy; ``decode_rows`` returns the rows
and commits nothing). ``prefill`` fills a fresh cache from a causal forward
over a prompt.

The decode step takes its position as a host ``int`` (the eager loops) or
as a 0-d int64 tensor on the device (the device-position form, which
``torch.export`` traces once for every step: ``utils/aot.py``): then nothing
indexes with a host ``int`` and decode attention is reached through the
registered operator ``torch.ops.vaura_torch.decode_attention``
(``kernels/ops.py``).

``quantize_weights`` stores the decoder blocks' and the LM head's matmul
weights as int8 with per-output-channel scales (``kernel_q``/``scale``,
``ops/quantization.py::quant_dense``), as the JAX package's ``PDense``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from vaura_tpu_torch.kernels.ops import decode_attention_op
from vaura_tpu_torch.ops.decode_attention import decode_attention
from vaura_tpu_torch.ops.dropout import (
    batch_shard,
    current_batch_shard,
    drop_path,
    dropout,
    uniform,
)
from vaura_tpu_torch.ops.quantization import (
    quant_dense,
    quantize_kv,
    quantize_kv4,
)
from vaura_tpu_torch.ops.rope import apply_rotary_emb, precompute_freqs_cis
from vaura_tpu_torch.parallel import tensor_parallel as tp_ops
from vaura_tpu_torch.utils import ANY, drop_unported_fields

# a decode position: a host int, or a 0-d int64 tensor on the device
Pos = Union[int, torch.Tensor]


_aten = torch.ops.aten
# the ops whose outputs a remat policy keeps for the backward pass: the
# block's dense layers reach ``mm``/``addmm`` (one matrix, no batch
# dimension), its attention products ``bmm``/``baddbmm``
REMAT_SAVED_OPS = {
    None: frozenset(),
    "dots": frozenset({_aten.mm.default, _aten.addmm.default,
                       _aten.bmm.default, _aten.baddbmm.default}),
    "dots_no_batch": frozenset({_aten.mm.default, _aten.addmm.default}),
}


def remat_context_fn(policy: Optional[str]):
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a remat policy:
    selective checkpointing that keeps the policy's ops' outputs."""
    saved = REMAT_SAVED_OPS[policy]
    if not saved:
        return noop_context_fn

    def policy_fn(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


def find_multiple(n: int, k: int) -> int:
    return n if n % k == 0 else n + k - (n % k)


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Decoder hyperparameters; the defaults are the flagship
    (``configs/modules/samplers/llama_9cbs.yaml``)."""

    num_layers: int = 24
    d_model: int = 1536
    d_codebook: int = 1024
    num_codebooks: int = 9
    nhead: int = 16
    n_kv_head: Optional[int] = None
    block_size_audio: int = 256
    block_size_video: int = 64
    dropout: float = 0.1
    class_dropout_prob: float = 0.1
    attn_dropout_p: float = 0.0
    drop_path_rate: float = 0.0
    layer_norm_eps: float = 1e-5
    rope_base: float = 10000.0
    multiple_of: int = 256
    ffn_dim_multiplier: Optional[float] = None
    cond_in_dim: int = 768
    cond_feature_channel_scaler: int = 3
    cond_token_num: int = 32
    codebook_dim: int = 8
    # recompute each block in the backward pass instead of keeping its
    # activations (torch.utils.checkpoint per block): memory and time
    # change, numbers do not. ``remat_policy`` keeps some outputs of the
    # block for the backward pass (``REMAT_SAVED_OPS``): None recomputes
    # everything, "dots" keeps every matmul's output, "dots_no_batch" those
    # of the products without a batch dimension (the dense layers, not the
    # attention products), as JAX's checkpoint policies of those names.
    remat: bool = False
    remat_policy: Optional[str] = None
    quantize_weights: bool = False  # int8 weight-only matmuls (inference)
    quantize_cache: bool = False  # int8 KV cache with per-(position, head) scales
    # the quantized cache's width: 8 (int8) or 4 (int4, two values a byte)
    cache_bits: int = 8
    # int8 x int8 attention products over a quantized cache (q and the
    # probabilities quantized on the fly; without quantize_cache no effect)
    int8_dots: bool = False
    # token embeddings: per codebook a [V+1, codebook_dim] table and a
    # weight-normed projection (True), or a [V+1, token_dim] table (False)
    dac_factored_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32  # storage of the matmul weights

    def __post_init__(self):
        if self.remat_policy not in REMAT_SAVED_OPS:
            raise ValueError(f"remat_policy {self.remat_policy!r}: one of "
                             f"{sorted(map(str, REMAT_SAVED_OPS))}")
        if self.cache_bits not in (8, 4):
            raise ValueError(f"cache_bits {self.cache_bits}: 8 or 4")

    @property
    def block_size(self) -> int:
        return max(self.block_size_audio, self.block_size_video)

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.nhead == 0
        return self.d_model // self.nhead

    @property
    def n_kv_heads(self) -> int:
        return self.n_kv_head if self.n_kv_head is not None else self.nhead

    @property
    def cond_dim(self) -> int:
        return self.d_model // self.cond_feature_channel_scaler

    @property
    def token_dim(self) -> int:
        return self.d_model - self.cond_dim

    @property
    def ffn_hidden_dim(self) -> int:
        hidden = int(2 * (4 * self.d_model) / 3)
        if self.ffn_dim_multiplier is not None:
            hidden = int(self.ffn_dim_multiplier * hidden)
        return find_multiple(hidden, self.multiple_of)

    @property
    def vocab_with_special(self) -> int:
        return self.d_codebook + 1

    @property
    def special_token_id(self) -> int:
        return self.d_codebook


# SamplerConfig fields of the JAX package the port has no field for: the
# value the port's behaviour equals, or ANY where the field changes nothing
# the port computes (an initialiser scale for weights that come from a seed
# or a checkpoint; the switch for JAX's own decode kernel, which the port
# always takes; a scan unroll factor; a flag the system decides)
_JAX_ONLY_FIELDS = {
    "initializer_range": ANY,
    "use_pallas_decode": ANY,
    "scan_unroll": ANY,
    "use_visual_conditioning": ANY,
}


def SamplerSpec(**kwargs) -> SamplerConfig:
    """``SamplerConfig`` from the reference YAML parameter set
    (``llama_9cbs.yaml``), as ``vaura_tpu.models.sampler.SamplerSpec``: the
    keys the reference itself ignores (``dim_feedforward`` and torch-API
    artifacts) are dropped, and so are the JAX-only fields that change
    nothing here (see ``_JAX_ONLY_FIELDS``)."""
    ignored = {
        "dim_feedforward",
        "activation",
        "batch_first",
        "norm_first",
        "positional_embedder",
        "use_delay_strategy",
    }
    clean = {k: v for k, v in kwargs.items() if k not in ignored}
    if "dropout" in clean:
        clean.setdefault("class_dropout_prob", 0.1)
    clean = drop_unported_fields(clean, _JAX_ONLY_FIELDS, "sampler")
    valid = {f.name for f in dataclasses.fields(SamplerConfig)}
    unknown = set(clean) - valid
    if unknown:
        raise TypeError(f"Unknown sampler config keys: {sorted(unknown)}")
    return SamplerConfig(**clean)


class PDense(nn.Module):
    """Bias-free dense: weight ``[out, in]`` stored in ``param_dtype``, cast
    to the compute dtype at use; with ``cfg.quantize_weights`` (and
    ``quantizable``) the int8 ``kernel_q [out, in]`` and float32 ``scale
    [out]`` buffers instead. ``merged``, when set (``use_weights``), is
    used in place of the weight: a LoRA-merged weight in the compute
    dtype, made once per entry call (``VauraSystem.lora_merged``).
    ``adapter``, when set (``use_adapters``), maps the weight the layer
    holds at the call to the weight it multiplies with (a LoRA merge made
    at each use: under FSDP2 after the block's all-gather)."""

    def __init__(self, i: int, o: int, cfg: SamplerConfig, device=None,
                 quantizable: bool = True):
        super().__init__()
        self.dtype = cfg.dtype
        self.quantized = quantizable and cfg.quantize_weights
        if self.quantized:
            self.register_buffer("kernel_q", torch.zeros(
                o, i, dtype=torch.int8, device=device))
            self.register_buffer("scale", torch.ones(o, device=device))
        else:
            self.weight = nn.Parameter(torch.empty(o, i, dtype=cfg.param_dtype,
                                                   device=device))
        self.merged: Optional[torch.Tensor] = None
        self.adapter: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.merged is not None:
            return F.linear(x.to(self.dtype), self.merged)
        if self.adapter is not None:
            return F.linear(x.to(self.dtype),
                            self.adapter(self.weight).to(self.dtype))
        if self.quantized:
            return quant_dense(x.to(self.dtype), self.kernel_q, self.scale)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


@contextlib.contextmanager
def use_weights(weights: Dict[PDense, torch.Tensor]):
    """Run the ``PDense`` layers of ``weights`` with the given weights (cast
    to each layer's compute dtype) in place of their own, until the block
    ends; the layers' previous state is restored then."""
    old = {m: m.merged for m in weights}
    for m, w in weights.items():
        m.merged = w.to(m.dtype)
    try:
        yield
    finally:
        for m, w in old.items():
            m.merged = w


@contextlib.contextmanager
def use_adapters(adapters: Dict[PDense, Callable[[torch.Tensor], torch.Tensor]]):
    """Run the ``PDense`` layers of ``adapters`` with the given ``adapter``
    until the block ends; the layers' previous state is restored then."""
    old = {m: m.adapter for m in adapters}
    for m, fn in adapters.items():
        m.adapter = fn
    try:
        yield
    finally:
        for m, fn in old.items():
            m.adapter = fn


class RMSNorm(nn.Module):
    """Root-mean-square norm in float32."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        norm = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps)
        return (norm * self.weight).to(x.dtype)


class FeedForward(nn.Module):
    """SwiGLU: ``w2(silu(w1 x) * w3 x)``. Under tensor parallelism
    (``tp``, set by ``parallel.shard_module``) ``w1``/``w3`` hold this
    rank's hidden rows and ``w2`` its hidden columns; the partial outputs
    are all-reduced."""

    def __init__(self, cfg: SamplerConfig, device=None):
        super().__init__()
        self.dropout = cfg.dropout
        self.w1 = PDense(cfg.d_model, cfg.ffn_hidden_dim, cfg, device)
        self.w3 = PDense(cfg.d_model, cfg.ffn_hidden_dim, cfg, device)
        self.w2 = PDense(cfg.ffn_hidden_dim, cfg.d_model, cfg, device)
        self.tp = None

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = tp_ops.enter(self.tp, x)
        out = tp_ops.reduce(self.tp, self.w2(F.silu(self.w1(x)) * self.w3(x)))
        return dropout(out, self.dropout, train, generator)


class Attention(nn.Module):
    """Fused-QKV attention with RoPE: ``forward`` is the full-sequence
    masked branch (training), ``decode`` one position against the cache.
    ``n_heads``/``n_kv`` are the heads this module computes: all of them,
    or under tensor parallelism (``tp``, set by ``parallel.shard_module``)
    this rank's, whose q, k and v rows ``wqkv`` holds; ``wo`` then holds
    their input columns and the partial outputs are all-reduced."""

    def __init__(self, cfg: SamplerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kv_dim = cfg.n_kv_heads * cfg.head_dim
        self.wqkv = PDense(cfg.d_model, cfg.d_model + 2 * kv_dim, cfg, device)
        self.wo = PDense(cfg.d_model, cfg.d_model, cfg, device)
        self.n_heads, self.n_kv = cfg.nhead, cfg.n_kv_heads
        self.tp = None

    def forward(self, x: torch.Tensor, freqs_cis: torch.Tensor,
                mask: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                probs_out: Optional[list] = None) -> torch.Tensor:
        """``x [B, S, d_model]``, ``mask [S, S]`` bool (True = attend).
        Float32 scores, ``-1e30`` at masked pairs, probabilities cast to the
        value dtype, dropout on the probabilities and on the output. A
        ``probs_out`` list receives the softmax probabilities averaged over
        heads, ``[B, S, S]`` float32 (before dropout; the JAX package's
        ``sow("intermediates", "attn_probs")``)."""
        return self.forward_kv(x, freqs_cis, mask, train, generator,
                               probs_out)[0]

    def forward_kv(self, x: torch.Tensor, freqs_cis: torch.Tensor,
                   mask: torch.Tensor, train: bool = False,
                   generator: Optional[torch.Generator] = None,
                   probs_out: Optional[list] = None
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """``forward`` that also returns every position's K/V ``[B, S, H_kv,
        hd]`` (after RoPE), what ``prefill`` puts into the cache."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, hd = self.n_heads, self.n_kv, cfg.head_dim
        x = tp_ops.enter(self.tp, x)
        q, k, v = self.wqkv(x).split([H * hd, Hkv * hd, Hkv * hd], dim=-1)
        q = apply_rotary_emb(q.reshape(B, S, H, hd), freqs_cis)
        k = apply_rotary_emb(k.reshape(B, S, Hkv, hd), freqs_cis)
        v = v.reshape(B, S, Hkv, hd)
        kv = (k, v)
        if H != Hkv:
            k = k.repeat_interleave(H // Hkv, dim=2)
            v = v.repeat_interleave(H // Hkv, dim=2)
        scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float())
        scores = scores * (1.0 / math.sqrt(hd))
        scores = torch.where(mask[None, None], scores,
                             scores.new_full((), -1e30))
        probs = torch.softmax(scores, dim=-1)
        if probs_out is not None:  # the mean over every head
            probs_out.append(probs.mean(1) if self.tp is None else
                             tp_ops.reduce(self.tp, probs.sum(1)) / cfg.nhead)
        # this rank's heads of a draw for all of them (ops/dropout.py)
        probs = dropout(probs, cfg.attn_dropout_p, train, generator,
                        None if self.tp is None else (self.tp.rank,
                                                      self.tp.size))
        out = torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v)
        out = tp_ops.reduce(self.tp,
                            self.wo(out.reshape(B, S, H * hd).to(cfg.dtype)))
        return dropout(out, cfg.dropout, train, generator), kv

    def decode(self, x: torch.Tensor, freqs_cis: torch.Tensor,
               cache_layer: Tuple[torch.Tensor, ...],
               row: Union[int, torch.Tensor],
               chunk_starts: Optional[torch.Tensor] = None,
               op: bool = False
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """``x [B, 1, d_model]`` whose RoPE row is ``freqs_cis``;
        ``cache_layer`` one layer's ``(k, v)`` ``[B, S, H_kv, hd]`` (and, for
        a quantized cache, ``(k_scale, v_scale) [B, S, H_kv]``), read below
        ``row`` only (an ``int`` or a one-element int32 tensor on ``x``'s
        device); ``chunk_starts`` the quantization groups of ``int8_dots``;
        ``op`` reaches decode attention through the registered operator (a
        tensor ``row``). Returns the output and this position's ``(k, v)
        [B, H_kv, hd]``."""
        cfg = self.cfg
        B = x.shape[0]
        H, Hkv, hd = self.n_heads, self.n_kv, cfg.head_dim
        q, k, v = self.wqkv(x).split([H * hd, Hkv * hd, Hkv * hd], dim=-1)
        q = apply_rotary_emb(q.reshape(B, 1, H, hd), freqs_cis)[:, 0]
        k = apply_rotary_emb(k.reshape(B, 1, Hkv, hd), freqs_cis)[:, 0]
        v = v.reshape(B, Hkv, hd).contiguous()
        k_cache, v_cache, *scales = cache_layer
        attend = decode_attention_op if op else decode_attention
        out = attend(
            q.contiguous(), k_cache, v_cache, k.contiguous(), v, row, *scales,
            cache_bits=cfg.cache_bits,
            int8_dots=cfg.int8_dots and cfg.quantize_cache,
            chunk_starts=chunk_starts)
        out = self.wo(out.reshape(B, 1, H * hd).to(cfg.dtype))
        return tp_ops.reduce(self.tp, out), (k, v)


class TransformerBlock(nn.Module):
    """Pre-norm residual block."""

    def __init__(self, cfg: SamplerConfig, device=None):
        super().__init__()
        self.drop_path_rate = cfg.drop_path_rate
        self.attention = Attention(cfg, device)
        self.feed_forward = FeedForward(cfg, device)
        self.attention_norm = RMSNorm(cfg.d_model, cfg.layer_norm_eps, device)
        self.ffn_norm = RMSNorm(cfg.d_model, cfg.layer_norm_eps, device)

    def forward(self, x: torch.Tensor, freqs_cis: torch.Tensor,
                mask: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                probs_out: Optional[list] = None) -> torch.Tensor:
        dp = lambda t: drop_path(t, self.drop_path_rate, train, generator)
        h = x + dp(self.attention(self.attention_norm(x), freqs_cis, mask,
                                  train, generator, probs_out))
        return h + dp(self.feed_forward(self.ffn_norm(h), train, generator))

    def prefill(self, x, freqs_cis, mask):
        a, kv = self.attention.forward_kv(self.attention_norm(x), freqs_cis,
                                          mask)
        h = x + a
        return h + self.feed_forward(self.ffn_norm(h)), kv

    def decode(self, x, freqs_cis, cache_layer, row, chunk_starts=None,
               op=False):
        a, kv = self.attention.decode(self.attention_norm(x), freqs_cis,
                                      cache_layer, row, chunk_starts, op)
        h = x + a
        return h + self.feed_forward(self.ffn_norm(h)), kv


class MultiCodebookEmbedding(nn.Module):
    """Sum of per-codebook token embeddings, all codebooks gathered from one
    flattened table. DAC-factored (``dac_factored_embeddings``, the
    default): per codebook a ``[V+1, codebook_dim]`` table, then a
    weight-normed 1x1 projection to ``token_dim``. Plain: per codebook a
    ``[V+1, token_dim]`` table (``emb [K*(V+1), token_dim]``)."""

    def __init__(self, cfg: SamplerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        K, V1, cd = cfg.num_codebooks, cfg.vocab_with_special, cfg.codebook_dim
        if not cfg.dac_factored_embeddings:
            self.emb = nn.Parameter(torch.empty(K * V1, cfg.token_dim,
                                                device=device))
            return
        self.emb = nn.Parameter(torch.empty(K * V1, cd, device=device))
        self.proj_v = nn.Parameter(torch.empty(K, cfg.token_dim, cd,
                                               device=device))
        self.proj_g = nn.Parameter(torch.ones(K, cfg.token_dim, 1,
                                              device=device))
        self.proj_b = nn.Parameter(torch.zeros(K, cfg.token_dim,
                                               device=device))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """``[B, K, S]`` token ids -> ``[B, S, token_dim]``."""
        cfg = self.cfg
        B, K, S = tokens.shape
        offsets = (torch.arange(K, device=tokens.device)
                   * cfg.vocab_with_special)[None, :, None]
        flat = (tokens.long() + offsets).reshape(-1)
        e = self.emb.index_select(0, flat).reshape(B, K, S, -1)
        if not cfg.dac_factored_embeddings:
            return e.sum(1).to(cfg.dtype)
        norm = torch.sqrt((self.proj_v ** 2).sum(-1, keepdim=True) + 1e-12)
        W = (self.proj_g * self.proj_v / norm).to(cfg.dtype).float()
        out = torch.einsum("bksc,ktc->bst", e.to(cfg.dtype).float(), W)
        return (out + self.proj_b.sum(0)).to(cfg.dtype)


class AVCLIPEmbedder(nn.Module):
    """Visual-feature projection (``fc2(gelu_tanh(fc1 x))``) and the
    learned null condition for classifier-free guidance."""

    def __init__(self, cfg: SamplerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        # plain denses in the JAX package too: int8 weights leave them be
        self.fc1 = PDense(cfg.cond_in_dim, cfg.cond_dim, cfg, device,
                          quantizable=False)
        self.fc2 = PDense(cfg.cond_dim, cfg.cond_dim, cfg, device,
                          quantizable=False)
        self.uncond_embedding = nn.Parameter(
            torch.empty(cfg.cond_token_num, cfg.cond_in_dim, device=device))

    def _uncond_rows(self, n_tokens: int) -> torch.Tensor:
        """The first ``n_tokens`` rows of the null condition, tiled
        cyclically when the conditioning is longer than the table."""
        u = self.uncond_embedding
        if n_tokens > u.shape[0]:
            u = u.repeat(-(-n_tokens // u.shape[0]), 1)
        return u[:n_tokens]

    def token_drop(self, feats: torch.Tensor,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """Replace whole samples (one draw per batch row) with the null
        condition with probability ``class_dropout_prob``."""
        drop = uniform((feats.shape[0],), feats.device,
                       generator) < self.cfg.class_dropout_prob
        uncond = self._uncond_rows(feats.shape[1]).to(feats.dtype)
        return torch.where(drop[:, None, None], uncond.expand_as(feats), feats)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.fc1(x.to(self.cfg.dtype)), approximate="tanh")
        return self.fc2(h)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if train and self.cfg.class_dropout_prob > 0.0:
            x = self.token_drop(x, generator)
        return self.project(x)

    def uncond(self, batch: int, n_tokens: int) -> torch.Tensor:
        u = self._uncond_rows(n_tokens)[None].to(self.cfg.dtype)
        return self.project(u.expand(batch, n_tokens, self.cfg.cond_in_dim))


def repeat_video_tokens(cond_emb: torch.Tensor, seq_len: int,
                        tokens_per_frame: int, empty_emb: torch.Tensor
                        ) -> torch.Tensor:
    """Repeat each video token ``tokens_per_frame`` times along the audio
    axis; positions past the last frame take ``empty_emb``."""
    B, Tv, D = cond_emb.shape
    frame = torch.arange(seq_len, device=cond_emb.device) // tokens_per_frame
    gathered = cond_emb.index_select(1, frame.clamp(0, Tv - 1))
    valid = (frame < Tv)[None, :, None]
    return torch.where(valid, gathered, empty_emb.to(cond_emb.dtype)[None, None])


def default_tokens_per_frame(seq_len: int, n_video_tokens: int,
                             num_codebooks: int,
                             pattern_name: str = "delayed") -> int:
    ta = (seq_len - num_codebooks if "delayed" in pattern_name.lower()
          else seq_len - 1)
    return math.ceil(ta / n_video_tokens)


class Sampler(nn.Module):
    """The autoregressive decoder: ``forward`` (teacher-forced, full
    sequence) and the decode entry points."""

    def __init__(self, cfg: SamplerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.tok_embeddings = MultiCodebookEmbedding(cfg, device)
        self.cls_embeddings = AVCLIPEmbedder(cfg, device)
        self.empty_video_emb = nn.Parameter(torch.empty(cfg.cond_dim,
                                                        device=device))
        self.layers = nn.ModuleList(
            TransformerBlock(cfg, device) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.d_model, cfg.layer_norm_eps, device)
        self.lm_head = PDense(cfg.d_model, cfg.num_codebooks * cfg.d_codebook,
                               cfg, device)
        freqs = precompute_freqs_cis(cfg.block_size, cfg.head_dim, cfg.rope_base)
        self.register_buffer("freqs_cis", torch.as_tensor(freqs, device=device),
                             persistent=False)
        # tensor parallelism over the mesh's model axis (parallel.
        # shard_module): lm_head then holds this rank's logit rows, which
        # are gathered whole before the loss and sampling
        self.tp = None

    @property
    def n_kv_local(self) -> int:
        """The KV heads of this rank's cache (all of them without tensor
        parallelism)."""
        return self.layers[0].attention.n_kv

    # ---------------------------------------------------------------- #
    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, S, _ = h.shape
        out = tp_ops.gather(self.tp, self.lm_head(
            tp_ops.enter(self.tp, self.norm(h))))
        out = out.reshape(B, S, cfg.num_codebooks, cfg.d_codebook)
        return out.permute(0, 2, 1, 3)  # [B, K, S, vocab]

    def embed_cond(self, cond_feats: torch.Tensor, train: bool = False,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """``[B, Tv, cond_in_dim]`` raw features -> ``[B, Tv, cond_dim]``
        (the CFG token drop applied when training)."""
        return self.cls_embeddings(cond_feats, train, generator)

    def forward(self, tokens: torch.Tensor, cond_feats: torch.Tensor,
                train: bool = False, tokens_per_frame: Optional[int] = None,
                attn_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                return_attn_probs: bool = False):
        """Teacher-forced causal forward: tokens ``[B, K, S]`` and raw visual
        features ``[B, Tv, cond_in_dim]`` -> logits ``[B, K, S, vocab]``.
        ``attn_mask [S, S]`` (bool, a subset of the causal mask) replaces
        the causal mask. ``return_attn_probs`` returns ``(logits, probs)``
        with every layer's softmax probabilities averaged over heads,
        ``probs [L, B, S, S]`` float32 (the JAX package's ``attn_probs``
        intermediates, stacked over layers by its ``nn.scan``); the blocks
        then run without recomputation."""
        cfg = self.cfg
        B, K, S = tokens.shape
        tok_emb = self.tok_embeddings(tokens)
        if tokens_per_frame is None:
            tokens_per_frame = default_tokens_per_frame(
                S, cond_feats.shape[1], cfg.num_codebooks)
        cond_emb = self.embed_cond(cond_feats, train, generator)
        cond_seq = self.build_cond_seq(cond_emb, S, tokens_per_frame)
        h = torch.cat([cond_seq, tok_emb], dim=-1)
        h = dropout(h, cfg.dropout, train, generator)
        freqs = self.freqs_cis[:S]
        if attn_mask is None:
            mask = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
        else:
            mask = torch.as_tensor(attn_mask, dtype=torch.bool, device=h.device)
        probs = [] if return_attn_probs else None
        remat = cfg.remat and torch.is_grad_enabled() and probs is None
        stochastic = train and bool(cfg.dropout or cfg.attn_dropout_p
                                    or cfg.drop_path_rate)
        shard = current_batch_shard()
        for layer in self.layers:
            if not remat:
                h = layer(h, freqs, mask, train, generator, probs)
                continue
            # the backward pass runs the block again and must draw the same
            # masks: each block gets a generator of its own, seeded from the
            # caller's and made anew for either run
            seed = (int(torch.randint(0, 2 ** 62, (1,), device=h.device,
                                      generator=generator))
                    if stochastic else None)

            # the LoRA adapters of this call, which the backward pass's
            # rerun must merge too: from the weights gathered again then,
            # so no merged weight lives from the forward to the backward
            adapters = {m: m.adapter for m in layer.modules()
                        if isinstance(m, PDense) and m.adapter is not None}

            def run(x, layer=layer, seed=seed, adapters=adapters):
                g = (None if seed is None else
                     torch.Generator(device=x.device).manual_seed(seed))
                with use_adapters(adapters), batch_shard(shard):
                    return layer(x, freqs, mask, train, g)

            h = checkpoint(run, h, use_reentrant=False,
                           preserve_rng_state=False,
                           context_fn=remat_context_fn(cfg.remat_policy))
        if probs is not None:
            return self._logits(h), torch.stack(probs)
        return self._logits(h)

    def uncond_cond_emb(self, batch: int, n_tokens: int) -> torch.Tensor:
        return self.cls_embeddings.uncond(batch, n_tokens)

    def build_cond_seq(self, cond_emb: torch.Tensor, seq_len: int,
                       tokens_per_frame: int) -> torch.Tensor:
        return repeat_video_tokens(cond_emb, seq_len, tokens_per_frame,
                                   self.empty_video_emb)

    def init_cache(self, batch: int, max_seq: int,
                   dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
        """A zero cache of ``max_seq`` rows: bf16 (or ``dtype``) ``k``/``v``,
        or with ``quantize_cache`` int8 ``k``/``v`` (``hd / 2`` bytes a row
        with ``cache_bits=4``) and float32 ``k_scale``/``v_scale``
        (``dtype`` is then not read); and the rows' ``positions`` (and,
        under ``int8_dots``, one quantization group: ``chunk_starts``)."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_seq, self.n_kv_local, cfg.head_dim)
        dev = self.freqs_cis.device
        if cfg.quantize_cache:
            packed = shape[:-1] + (cfg.head_dim // 2 if cfg.cache_bits == 4
                                   else cfg.head_dim,)
            return {"k": torch.zeros(packed, dtype=torch.int8, device=dev),
                    "v": torch.zeros(packed, dtype=torch.int8, device=dev),
                    "k_scale": torch.zeros(shape[:-1], device=dev),
                    "v_scale": torch.zeros(shape[:-1], device=dev),
                    **self._cache_rows(max_seq, dev)}
        dtype = dtype or cfg.dtype
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev),
                "positions": self._positions(max_seq, dev)}

    @staticmethod
    def _positions(max_seq: int, device) -> torch.Tensor:
        """``0 .. max_seq - 1`` as int32 on the cache's device, made once
        per cache: ``positions[row:row + 1]`` is the row as a device scalar
        for decode attention, a view that costs no launch."""
        return torch.arange(max_seq, dtype=torch.int32, device=device)

    def _cache_rows(self, max_seq: int, device) -> Dict[str, torch.Tensor]:
        """A quantized cache's ``positions`` and, under ``int8_dots``, its
        one quantization group (``chunk_starts`` ``[0]``), which the decode
        loops replace by the JAX package's chunks."""
        rows = {"positions": self._positions(max_seq, device)}
        if self.cfg.int8_dots:
            rows["chunk_starts"] = torch.zeros(1, dtype=torch.int32,
                                               device=device)
        return rows

    def _store(self, k: torch.Tensor, v: torch.Tensor) -> Dict[str, torch.Tensor]:
        """K/V as the cache stores them: quantized for an int8 or int4
        cache."""
        if self.cfg.quantize_cache:
            qfn = quantize_kv4 if self.cfg.cache_bits == 4 else quantize_kv
            kq, ks = qfn(k)
            vq, vs = qfn(v)
            return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        return {"k": k.to(self.cfg.dtype), "v": v.to(self.cfg.dtype)}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cond_seq: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Causal forward over the padded prompt ``tokens [B, K, S]`` with
        the per-position conditioning ``cond_seq [B, S, cond_dim]``: returns
        the logits ``[B, K, S, vocab]`` and a fresh cache of ``S`` rows
        holding every position's K/V (int8 with ``quantize_cache``), with
        its ``positions`` (and one ``chunk_starts`` group under
        ``int8_dots``). Positions past the prompt hold K/V of whatever
        the padding was; decode attention never reads a row at or past its
        own, and the decode steps rewrite them first (JAX
        ``sampler.py:773-804``)."""
        cfg = self.cfg
        S = tokens.shape[2]
        tok_emb = self.tok_embeddings(tokens)
        h = torch.cat([cond_seq.to(tok_emb.dtype), tok_emb], dim=-1)
        freqs = self.freqs_cis[:S]
        mask = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
        ks, vs = [], []
        for layer in self.layers:
            h, (k, v) = layer.prefill(h, freqs, mask)
            ks.append(k)
            vs.append(v)
        cache = self._store(torch.stack(ks), torch.stack(vs))
        cache.update(self._cache_rows(S, h.device) if cfg.quantize_cache
                     else {"positions": self._positions(S, h.device)})
        return self._logits(h), cache

    @torch.no_grad()
    def decode_step(self, tokens_t: torch.Tensor, cond_t: torch.Tensor,
                    cache: Dict[str, torch.Tensor], pos: Pos,
                    row: Optional[Pos] = None) -> torch.Tensor:
        """One step at position ``pos``: ``tokens_t [B, K, 1]``,
        ``cond_t [B, 1, cond_dim]``. Returns next-token logits
        ``[B, K, vocab]`` and commits this position's K/V into cache row
        ``row`` (default ``pos``) in place after all layers have read the
        rows below it: ``pos`` picks the RoPE row, ``row`` the cache row,
        which differ in the rolling cache of ``generate_long_kv``. Decode
        attention takes the row from device memory (a one-element view of
        the cache's ``positions``, added to a cache that lacks it); RoPE and
        the cache write index with the host ``int``. Under ``int8_dots`` the
        cache's ``chunk_starts`` are the probabilities' quantization
        groups. ``pos`` and ``row`` may instead be 0-d int64 tensors on the
        device (``decode_rows``), and the write is then an ``index_copy_``."""
        row = pos if row is None else row
        logits, rows = self.decode_rows(tokens_t, cond_t, cache, pos, row)
        self.commit_rows(cache, rows, row)
        return logits

    @torch.no_grad()
    def decode_rows(self, tokens_t: torch.Tensor, cond_t: torch.Tensor,
                    cache: Dict[str, torch.Tensor], pos: Pos,
                    row: Optional[Pos] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``decode_step`` without the write: ``(logits [B, K, vocab], this
        position's rows {name: [L, B, ...]})``, the rows as the cache stores
        them (quantized for an int8 or int4 cache), for ``commit_rows``.
        With a tensor ``pos`` (and ``row``) the RoPE row is an
        ``index_select``, the cache row an int32 copy of ``row`` and decode
        attention the registered operator: a graph traced once serves every
        position."""
        device_pos = isinstance(pos, torch.Tensor)
        if device_pos:
            row = pos if row is None else row
            row_t = row.reshape(1).to(torch.int32)
            freqs = self.freqs_cis.index_select(0, pos.reshape(1))
        else:
            pos = int(pos)
            row = pos if row is None else int(row)
            if "positions" not in cache:
                cache["positions"] = self._positions(cache["k"].shape[2],
                                                     cache["k"].device)
            row_t = cache["positions"][row:row + 1]
            freqs = self.freqs_cis[pos:pos + 1]
        tok_emb = self.tok_embeddings(tokens_t)
        h = torch.cat([cond_t.to(tok_emb.dtype), tok_emb], dim=-1)
        names = ("k", "v", "k_scale", "v_scale") if self.cfg.quantize_cache \
            else ("k", "v")
        ks, vs = [], []
        starts = cache.get("chunk_starts")
        for layer, *cache_layer in zip(self.layers, *(cache[n] for n in names)):
            h, (k, v) = layer.decode(h, freqs, tuple(cache_layer), row_t,
                                     starts, device_pos)
            ks.append(k)
            vs.append(v)
        return (self._logits(h)[:, :, 0, :],
                self._store(torch.stack(ks), torch.stack(vs)))

    @staticmethod
    def commit_rows(cache: Dict[str, torch.Tensor],
                    rows: Dict[str, torch.Tensor], row: Pos) -> None:
        """Write ``decode_rows``' rows into cache row ``row`` in place (an
        ``index_copy_`` for a tensor ``row``)."""
        for name, t in rows.items():
            if isinstance(row, torch.Tensor):
                cache[name].index_copy_(2, row.reshape(1), t.unsqueeze(2))
            else:
                cache[name][:, :, int(row)] = t
