"""Multi-codebook autoregressive sampler (Llama-style decoder): the
teacher-forced forward of training and the decode path of generation.

Counterpart of ``vaura_tpu/models/sampler.py``: per-codebook token
embeddings (DAC-factored, weight-normed), AVCLIP visual features projected
and fused by channel concatenation, interleaved RoPE, RMSNorm + SwiGLU
blocks, one fused LM head for all codebooks.

Compute runs in ``config.dtype`` (bf16 by default). The matmul weights are
stored in ``config.param_dtype`` (float32 by default, what the optimizer
updates) and cast to the compute dtype at each use, as the JAX package
does; a system that only generates may store them in the compute dtype
(``param_dtype=torch.bfloat16``), which rounds the same way once. Norms,
embeddings and the softmax stay float32.

Every stochastic operation of ``forward(train=True)`` (token, ``wo`` and
feed-forward dropout, attention dropout, stochastic depth, the CFG
``token_drop``) draws its mask from the explicit ``generator``.

The KV cache is one preallocated ``[L, B, S, H_kv, hd]`` buffer per key and
value. A layer never writes it: it reads positions ``< pos`` through
``ops.decode_attention`` and returns the current position's K/V, which
``decode_step`` commits in place after the step (the JAX package's
contract, ``sampler.py:228-238``; in place here, where JAX returns an
updated copy).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from vaura_tpu_torch.ops.decode_attention import decode_attention
from vaura_tpu_torch.ops.dropout import drop_path, dropout
from vaura_tpu_torch.ops.rope import apply_rotary_emb, precompute_freqs_cis


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
    # change, numbers do not.
    remat: bool = False
    quantize_cache: bool = False  # int8 cache: not ported yet
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32  # storage of the matmul weights

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


class PDense(nn.Module):
    """Bias-free dense: weight ``[out, in]`` stored in ``param_dtype``, cast
    to the compute dtype at use."""

    def __init__(self, i: int, o: int, cfg: SamplerConfig, device=None):
        super().__init__()
        self.dtype = cfg.dtype
        self.weight = nn.Parameter(torch.empty(o, i, dtype=cfg.param_dtype,
                                               device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))



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
    """SwiGLU: ``w2(silu(w1 x) * w3 x)``."""

    def __init__(self, cfg: SamplerConfig, device=None):
        super().__init__()
        self.dropout = cfg.dropout
        self.w1 = PDense(cfg.d_model, cfg.ffn_hidden_dim, cfg, device)
        self.w3 = PDense(cfg.d_model, cfg.ffn_hidden_dim, cfg, device)
        self.w2 = PDense(cfg.ffn_hidden_dim, cfg.d_model, cfg, device)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = self.w2(F.silu(self.w1(x)) * self.w3(x))
        return dropout(out, self.dropout, train, generator)


class Attention(nn.Module):
    """Fused-QKV attention with RoPE: ``forward`` is the full-sequence
    masked branch (training), ``decode`` one position against the cache."""

    def __init__(self, cfg: SamplerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kv_dim = cfg.n_kv_heads * cfg.head_dim
        self.wqkv = PDense(cfg.d_model, cfg.d_model + 2 * kv_dim, cfg, device)
        self.wo = PDense(cfg.d_model, cfg.d_model, cfg, device)

    def forward(self, x: torch.Tensor, freqs_cis: torch.Tensor,
                mask: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x [B, S, d_model]``, ``mask [S, S]`` bool (True = attend).
        Float32 scores, ``-1e30`` at masked pairs, probabilities cast to the
        value dtype, dropout on the probabilities and on the output."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, hd = cfg.nhead, cfg.n_kv_heads, cfg.head_dim
        q, k, v = self.wqkv(x).split([H * hd, Hkv * hd, Hkv * hd], dim=-1)
        q = apply_rotary_emb(q.reshape(B, S, H, hd), freqs_cis)
        k = apply_rotary_emb(k.reshape(B, S, Hkv, hd), freqs_cis)
        v = v.reshape(B, S, Hkv, hd)
        if H != Hkv:
            k = k.repeat_interleave(H // Hkv, dim=2)
            v = v.repeat_interleave(H // Hkv, dim=2)
        scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float())
        scores = scores * (1.0 / math.sqrt(hd))
        scores = torch.where(mask[None, None], scores,
                             scores.new_full((), -1e30))
        probs = torch.softmax(scores, dim=-1)
        probs = dropout(probs, cfg.attn_dropout_p, train, generator)
        out = torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v)
        out = self.wo(out.reshape(B, S, H * hd).to(cfg.dtype))
        return dropout(out, cfg.dropout, train, generator)

    def decode(self, x: torch.Tensor, freqs_cis: torch.Tensor,
               k_cache: torch.Tensor, v_cache: torch.Tensor,
               pos: Union[int, torch.Tensor]
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """``x [B, 1, d_model]`` at position ``pos`` (an ``int`` or a
        one-element int32 tensor on ``x``'s device, whose RoPE row is
        ``freqs_cis``); ``k/v_cache`` one
        layer ``[B, S, H_kv, hd]``, read below ``pos`` only. Returns the
        output and this position's ``(k, v) [B, H_kv, hd]``."""
        cfg = self.cfg
        B = x.shape[0]
        H, Hkv, hd = cfg.nhead, cfg.n_kv_heads, cfg.head_dim
        q, k, v = self.wqkv(x).split([H * hd, Hkv * hd, Hkv * hd], dim=-1)
        q = apply_rotary_emb(q.reshape(B, 1, H, hd), freqs_cis)[:, 0]
        k = apply_rotary_emb(k.reshape(B, 1, Hkv, hd), freqs_cis)[:, 0]
        v = v.reshape(B, Hkv, hd).contiguous()
        out = decode_attention(q.contiguous(), k_cache, v_cache,
                               k.contiguous(), v, pos)
        return self.wo(out.reshape(B, 1, H * hd).to(cfg.dtype)), (k, v)


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
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dp = lambda t: drop_path(t, self.drop_path_rate, train, generator)
        h = x + dp(self.attention(self.attention_norm(x), freqs_cis, mask,
                                  train, generator))
        return h + dp(self.feed_forward(self.ffn_norm(h), train, generator))

    def decode(self, x, freqs_cis, k_cache, v_cache, pos):
        a, kv = self.attention.decode(self.attention_norm(x), freqs_cis,
                                      k_cache, v_cache, pos)
        h = x + a
        return h + self.feed_forward(self.ffn_norm(h)), kv


class MultiCodebookEmbedding(nn.Module):
    """Sum of per-codebook token embeddings, DAC-factored: per codebook a
    ``[V+1, codebook_dim]`` table, then a weight-normed 1x1 projection to
    ``token_dim``. (The JAX package's plain-table variant is not ported.)"""

    def __init__(self, cfg: SamplerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        K, V1, cd = cfg.num_codebooks, cfg.vocab_with_special, cfg.codebook_dim
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
        self.fc1 = PDense(cfg.cond_in_dim, cfg.cond_dim, cfg, device)
        self.fc2 = PDense(cfg.cond_dim, cfg.cond_dim, cfg, device)
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
        drop = torch.rand(feats.shape[0], device=feats.device,
                          generator=generator) < self.cfg.class_dropout_prob
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

    # ---------------------------------------------------------------- #
    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, S, _ = h.shape
        out = self.lm_head(self.norm(h)).reshape(B, S, cfg.num_codebooks,
                                                 cfg.d_codebook)
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
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced causal forward: tokens ``[B, K, S]`` and raw visual
        features ``[B, Tv, cond_in_dim]`` -> logits ``[B, K, S, vocab]``.
        ``attn_mask [S, S]`` (bool, a subset of the causal mask) replaces
        the causal mask."""
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
        remat = cfg.remat and torch.is_grad_enabled()
        stochastic = train and bool(cfg.dropout or cfg.attn_dropout_p
                                    or cfg.drop_path_rate)
        for layer in self.layers:
            if not remat:
                h = layer(h, freqs, mask, train, generator)
                continue
            # the backward pass runs the block again and must draw the same
            # masks: each block gets a generator of its own, seeded from the
            # caller's and made anew for either run
            seed = (int(torch.randint(0, 2 ** 62, (1,), device=h.device,
                                      generator=generator))
                    if stochastic else None)

            def run(x, layer=layer, seed=seed):
                g = (None if seed is None else
                     torch.Generator(device=x.device).manual_seed(seed))
                return layer(x, freqs, mask, train, g)

            h = checkpoint(run, h, use_reentrant=False,
                           preserve_rng_state=False)
        return self._logits(h)

    def uncond_cond_emb(self, batch: int, n_tokens: int) -> torch.Tensor:
        return self.cls_embeddings.uncond(batch, n_tokens)

    def build_cond_seq(self, cond_emb: torch.Tensor, seq_len: int,
                       tokens_per_frame: int) -> torch.Tensor:
        return repeat_video_tokens(cond_emb, seq_len, tokens_per_frame,
                                   self.empty_video_emb)

    def init_cache(self, batch: int, max_seq: int,
                   dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        if cfg.quantize_cache:
            raise NotImplementedError(
                "the int8 KV cache (ops/quantization.py) is not ported yet")
        shape = (cfg.num_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        dev = self.freqs_cis.device
        dtype = dtype or cfg.dtype
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev),
                "positions": self._positions(max_seq, dev)}

    @staticmethod
    def _positions(max_seq: int, device) -> torch.Tensor:
        """``0 .. max_seq - 1`` as int32 on the cache's device, made once
        per cache: ``positions[pos:pos + 1]`` is the position as a device
        scalar for decode attention, a view that costs no launch."""
        return torch.arange(max_seq, dtype=torch.int32, device=device)

    def prefill(self, *args, **kwargs):
        raise NotImplementedError("prefill for long prompts is not ported yet")

    @torch.no_grad()
    def decode_step(self, tokens_t: torch.Tensor, cond_t: torch.Tensor,
                    cache: Dict[str, torch.Tensor], pos: int) -> torch.Tensor:
        """One step at position ``pos``: ``tokens_t [B, K, 1]``,
        ``cond_t [B, 1, cond_dim]``. Returns next-token logits
        ``[B, K, vocab]`` and commits this position's K/V into ``cache`` in
        place after all layers have read it. Decode attention takes the
        position from device memory (a one-element view of the cache's
        ``positions``, added to a cache that lacks it); RoPE and the cache
        write index with the host ``int``."""
        pos = int(pos)
        if "positions" not in cache:
            cache["positions"] = self._positions(cache["k"].shape[2],
                                                 cache["k"].device)
        pos_t = cache["positions"][pos:pos + 1]
        tok_emb = self.tok_embeddings(tokens_t)
        h = torch.cat([cond_t.to(tok_emb.dtype), tok_emb], dim=-1)
        freqs = self.freqs_cis[pos:pos + 1]
        ks, vs = [], []
        for layer, k_l, v_l in zip(self.layers, cache["k"], cache["v"]):
            h, (k, v) = layer.decode(h, freqs, k_l, v_l, pos_t)
            ks.append(k)
            vs.append(v)
        cache["k"][:, :, pos] = torch.stack(ks).to(cache["k"].dtype)
        cache["v"][:, :, pos] = torch.stack(vs).to(cache["v"].dtype)
        return self._logits(h)[:, :, 0, :]
