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

A decode step's position is a 0-d int64 tensor on the device, so nothing
indexes with a host ``int``: the RoPE row is an ``index_select``, the cache
write an ``index_copy_``, and decode attention the registered operator
``torch.ops.vaura_torch.decode_attention`` (``kernels/ops.py``). One traced
step then serves every position, whether ``torch.export`` traces it
(``utils/aot.py``) or a CUDA graph records it (``VauraSystem``'s decode
loop). ``decode_step`` alone also takes a host ``int``.

The decode step's elementwise work runs as fused operators
(``ops/decode_block.py``, registered in ``kernels/ops.py``): each residual
add with the norm after it (``RMSNorm.add_norm``; ``decode_rows`` carries a
block's feed-forward output into the next block's norm, the last one into
``norm``), RoPE with the split of the fused q/k/v and, for the int8 cache,
the quantized rows (``Attention.decode``, into the buffers of
``Sampler._int8_rows``), and SwiGLU's product (``FeedForward.decode``).
Training, ``forward`` and ``prefill`` keep the modules' eager ops; on the
CPU the operators compute those ops' arithmetic.

``quantize_weights`` stores the decoder blocks' and the LM head's matmul
weights as int8 with per-output-channel scales (``kernel_q``/``scale``,
``ops/quantization.py::quant_dense``), as the JAX package's ``PDense``.

The DeepSeek-V3 block (``SamplerConfig``'s keys of its config.json, e.g.
``configs/modules/samplers/moonlight_9cbs.yaml``; the port's own, the JAX
package has none) replaces the Llama block: latent attention
(``LatentAttention``), whose cache is ``c [L, B, S, kv_lora_rank]`` and
``k_pe [L, B, S, qk_rope_head_dim]`` in the compute dtype, read by the
absorbed decode through ``ops/mla_decode_attention.py``; and, after the
first ``first_k_dense_replace`` dense layers, routed experts
(``MoEFeedForward``). It generates only: the int8 and int4 caches, int8
weights, LoRA, the mesh, the rolling cache, export and training raise
``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from vaura_tpu_torch.kernels.ops import (
    add_rmsnorm_op,
    decode_attention_op,
    rmsnorm_op,
    rope_qkv_store_op,
    swiglu_op,
)
from vaura_tpu_torch.ops.dropout import (
    batch_shard,
    current_batch_shard,
    drop_path,
    dropout,
    uniform,
)
from vaura_tpu_torch.ops.mla_decode_attention import mla_decode_attention
from vaura_tpu_torch.ops.quantization import (
    quant_dense,
    quantize_kv,
    quantize_kv4,
)
from vaura_tpu_torch.ops.rope import apply_rotary_emb, precompute_freqs_cis
from vaura_tpu_torch.parallel import tensor_parallel as tp_ops
from vaura_tpu_torch.utils import ANY, drop_unported_fields
from vaura_tpu_torch.utils.spans import span


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
    # The DeepSeek-V3 block (arXiv:2412.19437), under the names of its
    # config.json (``PORT_ONLY_FIELDS``; the defaults keep the Llama block).
    # Latent attention (``kv_lora_rank`` set): per head a query of
    # ``qk_nope_head_dim + qk_rope_head_dim``, keys and values from one
    # shared latent row of ``kv_lora_rank`` and a shared rope key of
    # ``qk_rope_head_dim``, values of ``v_head_dim``; RoPE over the rope
    # part alone. No query compression: ``q_lora_rank`` null only.
    kv_lora_rank: Optional[int] = None
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # Routed experts (``n_routed_experts`` set) from layer
    # ``first_k_dense_replace`` on; the layers before it are dense SwiGLU of
    # ``intermediate_size`` (which, when set, is every dense layer's width).
    # Sigmoid scores, the choice by score plus a correction bias (one group:
    # ``n_group`` = ``topk_group`` = 1), the chosen scores renormalised
    # (``norm_topk_prob``) and scaled by ``routed_scaling_factor``; the
    # shared experts as one SwiGLU of ``n_shared_experts`` experts' width.
    n_routed_experts: Optional[int] = None
    num_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_intermediate_size: int = 0
    first_k_dense_replace: int = 0
    intermediate_size: Optional[int] = None
    n_group: int = 1
    topk_group: int = 1
    scoring_func: str = "sigmoid"
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0

    def __post_init__(self):
        if self.remat_policy not in REMAT_SAVED_OPS:
            raise ValueError(f"remat_policy {self.remat_policy!r}: one of "
                             f"{sorted(map(str, REMAT_SAVED_OPS))}")
        if self.cache_bits not in (8, 4):
            raise ValueError(f"cache_bits {self.cache_bits}: 8 or 4")
        if self.q_lora_rank is not None:
            raise NotImplementedError(
                "q_lora_rank: the latent attention takes no query "
                "compression (null only)")
        if self.mla and min(self.qk_nope_head_dim, self.qk_rope_head_dim,
                            self.v_head_dim) <= 0:
            raise ValueError("latent attention needs qk_nope_head_dim, "
                             "qk_rope_head_dim and v_head_dim")
        if self.moe:
            if self.scoring_func != "sigmoid":
                raise NotImplementedError(
                    f"scoring_func {self.scoring_func!r}: sigmoid only")
            if (self.n_group, self.topk_group) != (1, 1):
                raise NotImplementedError(
                    "group-limited routing (n_group, topk_group other than 1)")
            if not 0 < self.num_experts_per_tok <= self.n_routed_experts:
                raise ValueError("num_experts_per_tok: 1 to n_routed_experts")
        if self.deepseek:
            for name in ("quantize_cache", "quantize_weights"):
                if getattr(self, name):
                    raise NotImplementedError(
                        f"{name} with the DeepSeek-V3 block: its latent "
                        "cache and expert weights are bf16 only")

    @property
    def mla(self) -> bool:
        """Multi-head latent attention in place of the fused-QKV one."""
        return self.kv_lora_rank is not None

    @property
    def moe(self) -> bool:
        """Routed experts from layer ``first_k_dense_replace`` on."""
        return self.n_routed_experts is not None

    @property
    def deepseek(self) -> bool:
        return self.mla or self.moe

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def rope_dim(self) -> int:
        """The channels RoPE rotates: the rope part of a latent-attention
        head, else the whole head."""
        return self.qk_rope_head_dim if self.mla else self.head_dim

    @property
    def moe_layers(self) -> int:
        return self.num_layers - self.first_k_dense_replace if self.moe else 0

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
        if self.intermediate_size is not None:
            return self.intermediate_size
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

# SamplerConfig fields the JAX package has no field for (it builds the Llama
# block only), with the default that keeps that block
PORT_ONLY_FIELDS = {
    f.name: f.default for f in dataclasses.fields(SamplerConfig)
    if f.name in ("kv_lora_rank", "q_lora_rank", "qk_nope_head_dim",
                  "qk_rope_head_dim", "v_head_dim", "n_routed_experts",
                  "num_experts_per_tok", "n_shared_experts",
                  "moe_intermediate_size", "first_k_dense_replace",
                  "intermediate_size", "n_group", "topk_group",
                  "scoring_func", "norm_topk_prob", "routed_scaling_factor")}


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

    def add_norm(self, x: torch.Tensor, a: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The decode path's residual add and norm as one fused operator
        (``ops/decode_block.py``): ``(h, n)`` with ``h = x + a`` (``x``
        itself without ``a``) and ``n`` this norm of ``h``."""
        if a is None:
            return x, rmsnorm_op(x, self.weight, self.eps)
        return add_rmsnorm_op(x, a, self.weight, self.eps)


class FeedForward(nn.Module):
    """SwiGLU: ``w2(silu(w1 x) * w3 x)``. Under tensor parallelism
    (``tp``, set by ``parallel.shard_module``) ``w1``/``w3`` hold this
    rank's hidden rows and ``w2`` its hidden columns; the partial outputs
    are all-reduced. ``hidden`` (default ``cfg.ffn_hidden_dim``) is the
    width of the shared experts of a routed-expert layer."""

    def __init__(self, cfg: SamplerConfig, device=None,
                 hidden: Optional[int] = None):
        super().__init__()
        hidden = hidden or cfg.ffn_hidden_dim
        self.dropout = cfg.dropout
        self.w1 = PDense(cfg.d_model, hidden, cfg, device)
        self.w3 = PDense(cfg.d_model, hidden, cfg, device)
        self.w2 = PDense(hidden, cfg.d_model, cfg, device)
        self.tp = None

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = tp_ops.enter(self.tp, x)
        out = tp_ops.reduce(self.tp, self.w2(F.silu(self.w1(x)) * self.w3(x)))
        return dropout(out, self.dropout, train, generator)

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        """``forward`` at a decode step: the product ``silu(w1 x) * w3 x`` as
        one fused operator (``ops/decode_block.py``), no dropout."""
        x = tp_ops.enter(self.tp, x)
        return tp_ops.reduce(self.tp, self.w2(swiglu_op(self.w1(x),
                                                        self.w3(x))))


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
               cache_layer: Tuple[torch.Tensor, ...], row: torch.Tensor,
               chunk_starts: Optional[torch.Tensor] = None,
               store: Optional[Tuple[Dict[str, torch.Tensor], int]] = None
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """``x [B, 1, d_model]`` whose RoPE row is ``freqs_cis [1, hd/2,
        2]``; ``cache_layer`` one layer's ``(k, v)`` ``[B, S, H_kv, hd]``
        (and, for a quantized cache, ``(k_scale, v_scale) [B, S, H_kv]``),
        read below ``row`` only (a one-element int32 tensor on ``x``'s
        device) by the registered decode-attention operator;
        ``chunk_starts`` the quantization groups of ``int8_dots``. RoPE and
        the split of q, k and v are one fused operator
        (``ops/decode_block.py``), which with ``store`` (the step's int8
        rows buffers and this layer's index, ``Sampler._int8_rows``) also
        writes this position's quantized k and v rows there. Returns the
        output and this position's ``(k, v) [B, H_kv, hd]``."""
        cfg = self.cfg
        B = x.shape[0]
        H, Hkv, hd = self.n_heads, self.n_kv, cfg.head_dim
        rows, layer = store if store is not None else ({}, 0)
        q, k, v = rope_qkv_store_op(
            self.wqkv(x), freqs_cis, H, Hkv, rows.get("k"), rows.get("v"),
            rows.get("k_scale"), rows.get("v_scale"), layer)
        k_cache, v_cache, *scales = cache_layer
        out = decode_attention_op(
            q, k_cache, v_cache, k, v, row, *scales,
            cache_bits=cfg.cache_bits,
            int8_dots=cfg.int8_dots and cfg.quantize_cache,
            chunk_starts=chunk_starts)
        out = self.wo(out.reshape(B, 1, H * hd).to(cfg.dtype))
        return tp_ops.reduce(self.tp, out), (k, v)


class LatentAttention(nn.Module):
    """DeepSeek-V3's multi-head latent attention without query compression
    (arXiv:2412.19437 §2.1.1; the names of its inference code): ``wq``
    gives each head's ``[q_nope; q_pe]``, ``wkv_a`` one latent row ``c``
    (normed by ``kv_norm``) and one rope key ``k_pe`` shared by every head,
    ``wkv_b`` each head's ``[k_nope; v]`` from ``c``; interleaved-pair RoPE
    on ``q_pe`` and ``k_pe`` alone; scores ``(q_nope . k_nope + q_pe .
    k_pe) / sqrt(qk_nope + qk_rope)``. ``forward`` is the full-sequence form
    (and ``forward_kv`` also returns every position's ``(c, k_pe)``, what
    ``prefill`` caches); ``decode`` the absorbed form over a cache of latent
    rows: ``q_nope`` through ``wkv_b``'s key half into the latent space,
    attention over ``[c; k_pe]`` (``ops/mla_decode_attention.py``), the
    latent output through ``wkv_b``'s value half and ``wo``."""

    def __init__(self, cfg: SamplerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        H, R, r = cfg.nhead, cfg.kv_lora_rank, cfg.qk_rope_head_dim
        self.wq = PDense(cfg.d_model, H * cfg.qk_head_dim, cfg, device)
        self.wkv_a = PDense(cfg.d_model, R + r, cfg, device)
        self.kv_norm = RMSNorm(R, cfg.layer_norm_eps, device)
        self.wkv_b = PDense(R, H * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                            cfg, device)
        self.wo = PDense(H * cfg.v_head_dim, cfg.d_model, cfg, device)
        self.scale = cfg.qk_head_dim ** -0.5

    def _query(self, x: torch.Tensor, freqs_cis: torch.Tensor):
        cfg = self.cfg
        B, S, _ = x.shape
        q = self.wq(x).reshape(B, S, cfg.nhead, cfg.qk_head_dim)
        q_nope, q_pe = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim],
                               dim=-1)
        return q_nope, apply_rotary_emb(q_pe, freqs_cis)

    def _latent(self, x: torch.Tensor, freqs_cis: torch.Tensor):
        """``(c [B, S, R] normed, k_pe [B, S, r] after RoPE)``."""
        c, k_pe = self.wkv_a(x).split(
            [self.cfg.kv_lora_rank, self.cfg.qk_rope_head_dim], dim=-1)
        return (self.kv_norm(c),
                apply_rotary_emb(k_pe.unsqueeze(2), freqs_cis)[:, :, 0])

    def forward(self, x, freqs_cis, mask, train=False, generator=None,
                probs_out=None):
        return self.forward_kv(x, freqs_cis, mask, train, generator,
                               probs_out)[0]

    def forward_kv(self, x: torch.Tensor, freqs_cis: torch.Tensor,
                   mask: torch.Tensor, train: bool = False,
                   generator: Optional[torch.Generator] = None,
                   probs_out: Optional[list] = None):
        """As ``Attention.forward_kv``; the rows it returns are ``(c [B, S,
        R], k_pe [B, S, r])``."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, dn, dv = cfg.nhead, cfg.qk_nope_head_dim, cfg.v_head_dim
        q_nope, q_pe = self._query(x, freqs_cis)
        c, k_pe = self._latent(x, freqs_cis)
        k_nope, v = self.wkv_b(c).reshape(B, S, H, dn + dv).split([dn, dv],
                                                                   dim=-1)
        scores = (torch.einsum("bshd,bthd->bhst", q_nope.float(),
                               k_nope.float())
                  + torch.einsum("bshd,btd->bhst", q_pe.float(),
                                 k_pe.float())) * self.scale
        scores = torch.where(mask[None, None], scores,
                             scores.new_full((), -1e30))
        probs = torch.softmax(scores, dim=-1)
        if probs_out is not None:
            probs_out.append(probs.mean(1))
        probs = dropout(probs, cfg.attn_dropout_p, train, generator)
        out = torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v)
        out = self.wo(out.reshape(B, S, H * dv).to(cfg.dtype))
        return dropout(out, cfg.dropout, train, generator), (c, k_pe)

    def decode(self, x: torch.Tensor, freqs_cis: torch.Tensor,
               cache_layer: Tuple[torch.Tensor, torch.Tensor],
               row: torch.Tensor, chunk_starts=None):
        """The absorbed form at one position: ``x [B, 1, d_model]``,
        ``cache_layer`` one layer's ``(c [B, S, R], k_pe [B, S, r])``, read
        below ``row`` (a one-element int32 tensor on the device). Returns
        the output and this position's ``(c [B, R], k_pe [B, r])``."""
        cfg = self.cfg
        B = x.shape[0]
        H, dn, dv = cfg.nhead, cfg.qk_nope_head_dim, cfg.v_head_dim
        q_nope, q_pe = self._query(x, freqs_cis)
        c, k_pe = self._latent(x, freqs_cis)
        w = self.wkv_b.weight.to(cfg.dtype).reshape(H, dn + dv,
                                                    cfg.kv_lora_rank)
        q_lat = torch.bmm(q_nope[:, 0].transpose(0, 1), w[:, :dn])
        q = torch.cat([q_lat.transpose(0, 1), q_pe[:, 0]], dim=-1)
        c, k_pe = c[:, 0].contiguous(), k_pe[:, 0].contiguous()
        with span("decode_step.attend"):
            o_lat = mla_decode_attention(q.contiguous(), *cache_layer, c,
                                         k_pe, row, self.scale)
        o = torch.bmm(o_lat.transpose(0, 1).to(cfg.dtype),
                      w[:, dn:].transpose(1, 2))  # [H, B, dv]
        return self.wo(o.transpose(0, 1).reshape(B, 1, H * dv)), (c, k_pe)


# ``Sampler.expert_choices``' entry for a choice a layer did not make
NO_EXPERT = 255


class Router(nn.Module):
    """The routed-expert layer's gate: ``weight [E, d_model]`` (stored as
    the matmul weights are, applied in float32) and the float32
    ``e_score_correction_bias [E]``, which only chooses."""

    def __init__(self, cfg: SamplerConfig, device=None):
        super().__init__()
        E = cfg.n_routed_experts
        self.weight = nn.Parameter(torch.empty(E, cfg.d_model,
                                               dtype=cfg.param_dtype,
                                               device=device))
        self.e_score_correction_bias = nn.Parameter(torch.zeros(E,
                                                                device=device))


class Experts(nn.Module):
    """The routed experts' SwiGLU weights stacked, each expert's ``[in,
    out]``: ``w1``, ``w3 [E, d_model, hidden]``, ``w2 [E, hidden,
    d_model]``."""

    def __init__(self, cfg: SamplerConfig, device=None):
        super().__init__()
        E, I, d = cfg.n_routed_experts, cfg.moe_intermediate_size, cfg.d_model
        make = lambda *shape: nn.Parameter(torch.empty(
            *shape, dtype=cfg.param_dtype, device=device))
        self.w1, self.w3, self.w2 = make(E, d, I), make(E, d, I), make(E, I, d)


def _grouped(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor
             ) -> torch.Tensor:
    """Rows ``x [N, K]`` sorted by expert, expert ``e`` owning rows up to
    ``ends[e]``, times each one's ``w[e] [K, N_out]``: one grouped product
    (``torch._grouped_mm``), ``[N, N_out]``."""
    return torch._grouped_mm(x, w.to(x.dtype), offs=ends)


class MoEFeedForward(nn.Module):
    """DeepSeek-V3's routed-expert layer (arXiv:2412.19437 §2.1.2):
    ``s = sigmoid(h gate^T)`` over the experts in float32, the choice
    ``topk(s + bias)``, weights ``s[choice]`` (renormalised, scaled),
    ``sum_j w_j E_j(h) + shared(h)``. Every shape is static and nothing
    reads to the host, so a decode step that holds it records as a CUDA
    graph: the routed rows are laid out by expert from a running count of
    each expert's tokens (no sort), each of ``w1``, ``w3`` and ``w2`` is one
    grouped product over them (each row's weight folded into its hidden
    activations before ``w2``), and the rows go back by a gather.
    ``routed_rows`` and ``routed_choice`` keep the last call's rows per
    expert (int32 ``[E]``) and choices (``[T, k]``), on the device."""

    def __init__(self, cfg: SamplerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.gate = Router(cfg, device)
        self.experts = Experts(cfg, device)
        self.shared = FeedForward(
            cfg, device, cfg.n_shared_experts * cfg.moe_intermediate_size)
        self.routed_rows: Optional[torch.Tensor] = None
        self.routed_choice: Optional[torch.Tensor] = None

    def route(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``x [T, d_model]`` -> ``(choice [T, k] int64, weights [T, k]
        float32)``."""
        cfg = self.cfg
        s = torch.sigmoid(F.linear(x.float(), self.gate.weight.float()))
        choice = (s + self.gate.e_score_correction_bias.float()).topk(
            cfg.num_experts_per_tok, dim=-1).indices
        w = s.gather(1, choice)
        if cfg.norm_topk_prob:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return choice, w * cfg.routed_scaling_factor

    def routed(self, x: torch.Tensor, choice: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
        """``sum_j w_j E_j(x)``, ``[T, d_model]`` in ``x``'s dtype."""
        T, k = choice.shape
        E = self.cfg.n_routed_experts
        # each expert's tokens, in token order: a running count over the
        # tokens ([E, T], one row an expert) gives each its place
        chosen = torch.zeros(E, T, dtype=torch.int32, device=x.device)
        chosen.scatter_(0, choice.t(), 1)
        running = chosen.cumsum(1, dtype=torch.int32)
        counts = running[:, -1]
        ends = counts.cumsum(0, dtype=torch.int32)
        slot = ((ends - counts)[choice]
                + running.gather(0, choice.t()).t() - 1).reshape(-1).long()
        src = torch.empty_like(slot).scatter_(
            0, slot, torch.arange(T * k, device=x.device))
        rows = x.index_select(0, src // k)
        ex = self.experts
        h = (F.silu(_grouped(rows, ex.w1, ends)) * _grouped(rows, ex.w3, ends)
             * w.reshape(-1)[src, None].to(x.dtype))
        y = _grouped(h, ex.w2, ends).index_select(0, slot)
        self.routed_rows, self.routed_choice = counts, choice
        return y.reshape(T, k, -1).sum(1)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x [..., d_model]``."""
        shape = x.shape
        x = x.reshape(-1, shape[-1]).to(self.cfg.dtype)
        choice, w = self.route(x)
        out = self.routed(x, choice, w) + self.shared(x)
        return dropout(out.reshape(shape), self.cfg.dropout, train, generator)

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        """``forward`` at a decode step: the shared experts through
        ``FeedForward.decode``, no dropout; spans ``decode_step.route`` and
        ``decode_step.experts`` name the routing and the expert products."""
        shape = x.shape
        x = x.reshape(-1, shape[-1]).to(self.cfg.dtype)
        with span("decode_step.route"):
            choice, w = self.route(x)
        with span("decode_step.experts"):
            out = self.routed(x, choice, w) + self.shared.decode(x)
        return out.reshape(shape)


class TransformerBlock(nn.Module):
    """Pre-norm residual block: fused-QKV attention and SwiGLU, or, for the
    DeepSeek-V3 block, latent attention and (from layer
    ``first_k_dense_replace`` on) routed experts."""

    def __init__(self, cfg: SamplerConfig, device=None, layer: int = 0):
        super().__init__()
        self.drop_path_rate = cfg.drop_path_rate
        self.attention = (LatentAttention if cfg.mla else Attention)(cfg,
                                                                     device)
        self.feed_forward = (
            MoEFeedForward(cfg, device)
            if cfg.moe and layer >= cfg.first_k_dense_replace
            else FeedForward(cfg, device))
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

    def decode(self, x: torch.Tensor, pending: Optional[torch.Tensor],
               freqs_cis: torch.Tensor, cache_layer: Tuple[torch.Tensor, ...],
               row: torch.Tensor, chunk_starts: Optional[torch.Tensor] = None,
               store: Optional[Tuple[Dict[str, torch.Tensor], int]] = None):
        """One decode step of the block on the residual stream ``x`` plus
        ``pending``, the previous block's feed-forward output (None before
        the first block): each residual add is fused into the norm after
        it (``RMSNorm.add_norm``). Returns ``(the stream after the
        attention residual, this block's feed-forward output, this
        position's rows)``; the caller adds the output in the next norm.
        ``store``: ``Attention.decode``'s."""
        h, n = self.attention_norm.add_norm(x, pending)
        kw = {} if store is None else {"store": store}
        a, kv = self.attention.decode(n, freqs_cis, cache_layer, row,
                                      chunk_starts, **kw)
        h, n = self.ffn_norm.add_norm(h, a)
        return h, self.feed_forward.decode(n), kv


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
            TransformerBlock(cfg, device, i) for i in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.d_model, cfg.layer_norm_eps, device)
        self.lm_head = PDense(cfg.d_model, cfg.num_codebooks * cfg.d_codebook,
                               cfg, device)
        freqs = precompute_freqs_cis(cfg.block_size, cfg.rope_dim, cfg.rope_base)
        self.register_buffer("freqs_cis", torch.as_tensor(freqs, device=device),
                             persistent=False)
        # tensor parallelism over the mesh's model axis (parallel.
        # shard_module): lm_head then holds this rank's logit rows, which
        # are gathered whole before the loss and sampling
        self.tp = None
        # the rows routed to each expert at each decode position, int32
        # ``[positions, moe_layers, n_routed_experts]`` on the device, when
        # set (``VauraSystem.generate_tokens``): each step of
        # ``decode_rows`` adds its counts at its position's row; and, when
        # set, each row's chosen experts, uint8 ``[positions, moe_layers,
        # rows, num_experts_per_tok]`` (``NO_EXPERT`` past a layer's own
        # choices), written at its position's row
        self.expert_load: Optional[torch.Tensor] = None
        self.expert_choices: Optional[torch.Tensor] = None

    @property
    def cache_names(self) -> Tuple[str, ...]:
        """The cache's tensors a layer reads: ``c``/``k_pe`` (latent
        attention), else ``k``/``v`` and, quantized, their scales."""
        if self.cfg.mla:
            return ("c", "k_pe")
        return (("k", "v", "k_scale", "v_scale") if self.cfg.quantize_cache
                else ("k", "v"))

    @property
    def n_kv_local(self) -> int:
        """The KV heads of this rank's cache (all of them without tensor
        parallelism)."""
        return self.layers[0].attention.n_kv

    # ---------------------------------------------------------------- #
    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        return self._head(self.norm(h))

    def _head(self, n: torch.Tensor) -> torch.Tensor:
        """The LM head on the normed stream ``n [B, S, d_model]``: logits
        ``[B, K, S, vocab]``."""
        cfg = self.cfg
        B, S, _ = n.shape
        out = tp_ops.gather(self.tp, self.lm_head(tp_ops.enter(self.tp, n)))
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
        if train and cfg.deepseek:
            raise NotImplementedError(
                "training the DeepSeek-V3 block: its expert-balance loss is "
                "not ported")
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
        (``dtype`` is then not read), or for latent attention bf16 (or
        ``dtype``) ``c``/``k_pe``; under ``int8_dots`` also one quantization
        group (``chunk_starts``)."""
        cfg = self.cfg
        dev = self.freqs_cis.device
        if cfg.mla:
            lat = (cfg.num_layers, batch, max_seq)
            dtype = dtype or cfg.dtype
            return {"c": torch.zeros(lat + (cfg.kv_lora_rank,), dtype=dtype,
                                     device=dev),
                    "k_pe": torch.zeros(lat + (cfg.qk_rope_head_dim,),
                                        dtype=dtype, device=dev)}
        shape = (cfg.num_layers, batch, max_seq, self.n_kv_local, cfg.head_dim)
        if cfg.quantize_cache:
            packed = shape[:-1] + (cfg.head_dim // 2 if cfg.cache_bits == 4
                                   else cfg.head_dim,)
            return {"k": torch.zeros(packed, dtype=torch.int8, device=dev),
                    "v": torch.zeros(packed, dtype=torch.int8, device=dev),
                    "k_scale": torch.zeros(shape[:-1], device=dev),
                    "v_scale": torch.zeros(shape[:-1], device=dev),
                    **self._one_group(dev)}
        dtype = dtype or cfg.dtype
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}

    def _one_group(self, device) -> Dict[str, torch.Tensor]:
        """Under ``int8_dots`` with a quantized cache, its one quantization
        group (``chunk_starts`` ``[0]``), which the decode loops replace by
        the JAX package's chunks; else nothing."""
        if not (self.cfg.int8_dots and self.cfg.quantize_cache):
            return {}
        return {"chunk_starts": torch.zeros(1, dtype=torch.int32,
                                            device=device)}

    def _store(self, k: torch.Tensor, v: torch.Tensor) -> Dict[str, torch.Tensor]:
        """K/V as the cache stores them: quantized for an int8 or int4
        cache; a latent cache's ``(c, k_pe)`` in the compute dtype."""
        if self.cfg.mla:
            return {"c": k.to(self.cfg.dtype), "k_pe": v.to(self.cfg.dtype)}
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
        holding every position's K/V (int8 with ``quantize_cache``; one
        ``chunk_starts`` group under ``int8_dots``). Positions past the
        prompt hold K/V of whatever the padding was; decode attention never
        reads a row at or past its own, and the decode steps rewrite them
        first (JAX ``sampler.py:773-804``)."""
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
        return self._logits(h), {**cache, **self._one_group(h.device)}

    @torch.no_grad()
    def decode_step(self, tokens_t: torch.Tensor, cond_t: torch.Tensor,
                    cache: Dict[str, torch.Tensor], pos: int,
                    row: Optional[int] = None) -> torch.Tensor:
        """One step at position ``pos``: ``tokens_t [B, K, 1]``,
        ``cond_t [B, 1, cond_dim]``. Returns next-token logits
        ``[B, K, vocab]`` and commits this position's K/V into cache row
        ``row`` (default ``pos``) in place after all layers have read the
        rows below it: ``pos`` picks the RoPE row, ``row`` the cache row,
        which differ in the rolling cache of ``generate_long_kv``. Under
        ``int8_dots`` the cache's ``chunk_starts`` are the probabilities'
        quantization groups. ``pos`` and ``row`` are host ``int``s (or 0-d
        int64 tensors), made 0-d int64 tensors on the cache's device for
        ``decode_rows`` and ``commit_rows``."""
        dev = cache[self.cache_names[0]].device
        pos = torch.as_tensor(pos, dtype=torch.int64, device=dev)
        row = pos if row is None else torch.as_tensor(row, dtype=torch.int64,
                                                      device=dev)
        logits, rows = self.decode_rows(tokens_t, cond_t, cache, pos, row)
        self.commit_rows(cache, rows, row)
        return logits

    @torch.no_grad()
    def decode_rows(self, tokens_t: torch.Tensor, cond_t: torch.Tensor,
                    cache: Dict[str, torch.Tensor], pos: torch.Tensor,
                    row: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``decode_step`` without the write, at ``pos`` (and cache row
        ``row``, default ``pos``), 0-d int64 tensors on the device: ``(logits
        [B, K, vocab], this position's rows {name: [L, B, ...]})``, the rows
        as the cache stores them (quantized for an int8 or int4 cache), for
        ``commit_rows``: for the int8 cache the buffers each layer's RoPE
        operator wrote, else ``_store`` of the stacked rows. The RoPE row is
        an ``index_select`` and decode attention reads the rows below an
        int32 copy of ``row``: a graph traced once serves every position."""
        row_t = (pos if row is None else row).reshape(1).to(torch.int32)
        freqs = self.freqs_cis.index_select(0, pos.reshape(1))
        tok_emb = self.tok_embeddings(tokens_t)
        h = torch.cat([cond_t.to(tok_emb.dtype), tok_emb], dim=-1)
        ks, vs = [], []
        starts = cache.get("chunk_starts")
        int8_rows = self._int8_rows(h.shape[0], h.device)
        pending = None
        for i, (layer, *cache_layer) in enumerate(zip(
                self.layers, *(cache[n] for n in self.cache_names))):
            h, pending, (k, v) = layer.decode(
                h, pending, freqs, tuple(cache_layer), row_t, starts,
                None if int8_rows is None else (int8_rows, i))
            if int8_rows is None:
                ks.append(k)
                vs.append(v)
        moe = [layer.feed_forward for layer in self.layers
               if isinstance(layer.feed_forward, MoEFeedForward)]
        if self.expert_load is not None:
            routed = torch.stack([ff.routed_rows for ff in moe])
            self.expert_load.index_add_(0, row_t, routed[None])
        if self.expert_choices is not None:
            k = self.expert_choices.shape[-1]
            chosen = torch.stack([F.pad(ff.routed_choice,
                                        (0, k - ff.routed_choice.shape[-1]),
                                        value=NO_EXPERT) for ff in moe])
            self.expert_choices.index_copy_(0, row_t.long(),
                                            chosen[None].to(torch.uint8))
        logits = self._head(self.norm.add_norm(h, pending)[1])[:, :, 0, :]
        if int8_rows is not None:
            return logits, int8_rows
        return logits, self._store(torch.stack(ks), torch.stack(vs))

    def _int8_rows(self, batch: int, device
                   ) -> Optional[Dict[str, torch.Tensor]]:
        """For the int8 cache of the Llama block, the buffers a decode
        step's ``rope_qkv_store`` calls write this position's quantized
        rows into, one layer each (``{"k", "v"}`` int8 ``[L, B, H_kv,
        hd]``, ``{"k_scale", "v_scale"}`` float32 ``[L, B, H_kv]``): the
        rows ``_store`` would make of the stacked k and v. None for every
        other cache, whose rows ``_store`` makes."""
        cfg = self.cfg
        if cfg.mla or not cfg.quantize_cache or cfg.cache_bits != 8:
            return None
        shape = (cfg.num_layers, batch, self.n_kv_local)
        return {"k": torch.empty(shape + (cfg.head_dim,), dtype=torch.int8,
                                 device=device),
                "v": torch.empty(shape + (cfg.head_dim,), dtype=torch.int8,
                                 device=device),
                "k_scale": torch.empty(shape, device=device),
                "v_scale": torch.empty(shape, device=device)}

    @staticmethod
    def commit_rows(cache: Dict[str, torch.Tensor],
                    rows: Dict[str, torch.Tensor], row: torch.Tensor) -> None:
        """Write ``decode_rows``' rows into cache row ``row`` (a 0-d int64
        tensor on the device) in place, by ``index_copy_``."""
        for name, t in rows.items():
            cache[name].index_copy_(2, row.reshape(1), t.unsqueeze(2))
