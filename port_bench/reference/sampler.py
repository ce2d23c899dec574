"""Plain float32 reference of V-AURA's sampler: the Llama-style decoder over
codebook tokens and visual features, teacher-forced over a whole sequence.

It follows V-AURA's ``llama_9cbs.yaml`` model as published: per codebook a
``[V+1, codebook_dim]`` token table and a weight-normed projection to the
token width, the AVCLIP visual projection ``fc2(gelu_tanh(fc1 x))`` with a
learned null condition for classifier-free guidance, each visual row
repeated ``tokens_per_frame`` times along the sequence and concatenated on
the channel axis with the token embedding, RMSNorm pre-norm blocks with
fused q/k/v, interleaved-pair RoPE, causal softmax attention and a SwiGLU
feed-forward, one LM head for all codebooks. Everything is computed in
float32 from the given tensors (any storage dtype); nothing is cached, and
there is no decode path: a decode through a KV cache must agree with this
full forward at every position.

Parameter names and shapes are ``param_specs``'s: the benchmark makes the
weights from its seed by that table and hands the same tensors to the
program under test.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Spec = Tuple[str, Tuple[int, ...], str]  # name, shape, init


def widths(cfg: dict) -> dict:
    """The derived widths of a sampler configuration (the keys of
    ``llama_9cbs.yaml`` plus ``cond_in_dim``, ``codebook_dim`` and
    ``cond_token_num``)."""
    d, h = cfg["d_model"], cfg["nhead"]
    cond_dim = d // cfg["cond_feature_channel_scaler"]
    hidden = int(2 * (4 * d) / 3)
    mult = cfg.get("multiple_of", 256)
    hidden = hidden if hidden % mult == 0 else hidden + mult - hidden % mult
    return {"d": d, "heads": h, "kv_heads": cfg.get("n_kv_head") or h,
            "hd": d // h, "cond_dim": cond_dim, "token_dim": d - cond_dim,
            "hidden": hidden, "K": cfg["num_codebooks"],
            "V": cfg["d_codebook"], "cd": cfg.get("codebook_dim", 8),
            "cond_in": cfg.get("cond_in_dim", 768),
            "cond_tokens": cfg.get("cond_token_num", 32),
            "L": cfg["num_layers"], "eps": cfg.get("layer_norm_eps", 1e-5),
            "rope_base": cfg.get("rope_base", 10000.0)}


def param_specs(cfg: dict) -> List[Spec]:
    """Every parameter: ``(name, shape, init)``, init one of ``zeros``,
    ``ones``, ``emb`` (N(0, 0.02)) or ``fan_in`` (N(0, 1/fan_in), the
    fan-in every axis but the first); ``weights.init_std`` holds the
    rules."""
    w = widths(cfg)
    d, kv = w["d"], w["kv_heads"] * w["hd"]
    specs: List[Spec] = [
        ("tok_embeddings.emb", (w["K"] * (w["V"] + 1), w["cd"]), "emb"),
        ("tok_embeddings.proj_v", (w["K"], w["token_dim"], w["cd"]), "fan_in"),
        ("tok_embeddings.proj_g", (w["K"], w["token_dim"], 1), "ones"),
        ("tok_embeddings.proj_b", (w["K"], w["token_dim"]), "zeros"),
        ("cls_embeddings.fc1.weight", (w["cond_dim"], w["cond_in"]), "fan_in"),
        ("cls_embeddings.fc2.weight", (w["cond_dim"], w["cond_dim"]), "fan_in"),
        ("cls_embeddings.uncond_embedding", (w["cond_tokens"], w["cond_in"]),
         "emb"),
        ("empty_video_emb", (w["cond_dim"],), "emb"),
    ]
    for i in range(w["L"]):
        p = f"layers.{i}."
        specs += [
            (p + "attention.wqkv.weight", (d + 2 * kv, d), "fan_in"),
            (p + "attention.wo.weight", (d, d), "fan_in"),
            (p + "feed_forward.w1.weight", (w["hidden"], d), "fan_in"),
            (p + "feed_forward.w3.weight", (w["hidden"], d), "fan_in"),
            (p + "feed_forward.w2.weight", (d, w["hidden"]), "fan_in"),
            (p + "attention_norm.weight", (d,), "ones"),
            (p + "ffn_norm.weight", (d,), "ones"),
        ]
    specs += [("norm.weight", (d,), "ones"),
              ("lm_head.weight", (w["K"] * w["V"], d), "fan_in")]
    return specs


def _rms(x, weight, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * weight.float()


def _rope(x: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    """Rotate adjacent channel pairs ``(2i, 2i+1)`` of ``x [B, S, H, hd]``
    by ``pos * base^(-2i/hd)``."""
    hd = x.shape[-1]
    inv = 1.0 / base ** (torch.arange(0, hd, 2, device=x.device,
                                      dtype=torch.float32) / hd)
    ang = pos.float()[:, None] * inv[None]  # [S, hd/2]
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin],
                       dim=-1).flatten(-2)


def project_cond(sd: Dict[str, torch.Tensor], feats: torch.Tensor
                 ) -> torch.Tensor:
    """Visual features ``[B, Tv, cond_in]`` -> ``[B, Tv, cond_dim]``."""
    h = F.gelu(feats.float() @ sd["cls_embeddings.fc1.weight"].float().t(),
               approximate="tanh")
    return h @ sd["cls_embeddings.fc2.weight"].float().t()


def uncond_features(sd: Dict[str, torch.Tensor], batch: int, n: int
                    ) -> torch.Tensor:
    """The null condition's first ``n`` rows (tiled), ``[batch, n,
    cond_in]``."""
    u = sd["cls_embeddings.uncond_embedding"].float()
    u = u.repeat(-(-n // u.shape[0]), 1)[:n]
    return u[None].expand(batch, n, u.shape[1])


def cond_sequence(sd: Dict[str, torch.Tensor], cond_emb: torch.Tensor,
                  seq_len: int, tokens_per_frame: int) -> torch.Tensor:
    """Each visual row repeated ``tokens_per_frame`` times; the positions
    past the last row take ``empty_video_emb``."""
    B, Tv, D = cond_emb.shape
    frame = torch.arange(seq_len, device=cond_emb.device) // tokens_per_frame
    out = cond_emb[:, frame.clamp(max=Tv - 1)]
    empty = sd["empty_video_emb"].float()[None, None].expand(B, seq_len, D)
    return torch.where((frame < Tv)[None, :, None], out, empty)


def token_embedding(sd: Dict[str, torch.Tensor], cfg: dict,
                    tokens: torch.Tensor) -> torch.Tensor:
    """``[B, K, S]`` ids (the special id ``V`` included) -> ``[B, S,
    token_dim]``."""
    w = widths(cfg)
    K, V1 = w["K"], w["V"] + 1
    table = sd["tok_embeddings.emb"].float().reshape(K, V1, -1)
    v = sd["tok_embeddings.proj_v"].float()
    W = sd["tok_embeddings.proj_g"].float() * v / torch.sqrt(
        (v * v).sum(-1, keepdim=True) + 1e-12)  # [K, token_dim, cd]
    out = sd["tok_embeddings.proj_b"].float().sum(0)
    for k in range(K):
        out = out + table[k][tokens[:, k].long()] @ W[k].t()
    return out


def forward(sd: Dict[str, torch.Tensor], cfg: dict, tokens: torch.Tensor,
            cond_seq: torch.Tensor, dropout_fn=None, matmul=None
            ) -> torch.Tensor:
    """Causal forward: tokens ``[B, K, S]`` and the per-position condition
    ``cond_seq [B, S, cond_dim]`` -> logits ``[B, K, S, V]``, float32.
    ``dropout_fn(x, where, layer)``, when given, is applied where the
    recipe trains with dropout: ``"input"`` (layer None), then each layer's
    ``"attn_out"`` and ``"ffn_out"``. ``matmul(x, w)`` (default ``x @
    w.t()`` in float32) computes every product with a weight."""
    w = widths(cfg)
    drop = dropout_fn or (lambda x, where, layer: x)
    mm = matmul or (lambda x, w: x @ w.float().t())
    B, K, S = tokens.shape
    H, Hkv, hd = w["heads"], w["kv_heads"], w["hd"]
    h = torch.cat([cond_seq.float(), token_embedding(sd, cfg, tokens)], -1)
    h = drop(h, "input", None)
    pos = torch.arange(S, device=h.device)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    for i in range(w["L"]):
        p = f"layers.{i}."
        x = _rms(h, sd[p + "attention_norm.weight"], w["eps"])
        qkv = mm(x, sd[p + "attention.wqkv.weight"])
        q, k, v = qkv.split([H * hd, Hkv * hd, Hkv * hd], dim=-1)
        q = _rope(q.reshape(B, S, H, hd), pos, w["rope_base"])
        k = _rope(k.reshape(B, S, Hkv, hd), pos, w["rope_base"])
        v = v.reshape(B, S, Hkv, hd)
        if H != Hkv:
            k = k.repeat_interleave(H // Hkv, dim=2)
            v = v.repeat_interleave(H // Hkv, dim=2)
        scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
        scores = scores.masked_fill(~causal, float("-inf"))
        att = torch.einsum("bhst,bthd->bshd", scores.softmax(-1), v)
        att = mm(att.reshape(B, S, H * hd), sd[p + "attention.wo.weight"])
        h = h + drop(att, "attn_out", i)
        x = _rms(h, sd[p + "ffn_norm.weight"], w["eps"])
        ff = (F.silu(mm(x, sd[p + "feed_forward.w1.weight"]))
              * mm(x, sd[p + "feed_forward.w3.weight"]))
        h = h + drop(mm(ff, sd[p + "feed_forward.w2.weight"]), "ffn_out", i)
    h = _rms(h, sd["norm.weight"], w["eps"])
    logits = mm(h, sd["lm_head.weight"])
    return logits.reshape(B, S, K, w["V"]).permute(0, 2, 1, 3)


def guided_logits(sd: Dict[str, torch.Tensor], cfg: dict, seq: torch.Tensor,
                  feats: torch.Tensor, tokens_per_frame: int,
                  cfg_scale: float) -> torch.Tensor:
    """The CFG-blended logits of every step of a generated sequence: ``seq
    [B, K, S]`` (the pattern sequence, step 0 the special token), visual
    features ``[B, Tv, cond_in]``. Step ``s``'s logits predict ``seq[:, :,
    s + 1]``; returns ``[B, K, S - 1, V]``, ``uncond + (cond - uncond) *
    cfg_scale``."""
    B, _, S = seq.shape
    inp = seq[:, :, :S - 1]
    cond = cond_sequence(sd, project_cond(sd, feats), S - 1, tokens_per_frame)
    logits = forward(sd, cfg, inp, cond)
    if cfg_scale <= 1.0:
        return logits
    null = project_cond(sd, uncond_features(sd, B, feats.shape[1]))
    uncond = forward(sd, cfg, inp, cond_sequence(sd, null, S - 1,
                                                 tokens_per_frame))
    return uncond + (logits - uncond) * cfg_scale


def gumbel_draws(generator: torch.Generator, batch: int, K: int, V: int,
                 steps: int, rows: torch.Tensor) -> torch.Tensor:
    """The Gumbel noise that a call's tokens were drawn with: at each step
    one uniform ``[batch, K, V]`` draw from the call's generator, for the
    whole batch whatever rows are compared, and ``-log(-log u)`` with ``u``
    clamped at float32's least normal number (Gumbel-max sampling, as the
    program draws it). Returns the ``rows``' noise, ``[len(rows), K,
    steps, V]``."""
    out = torch.empty(len(rows), K, steps, V, device=rows.device)
    for s in range(steps):
        u = torch.rand((batch, K, V), generator=generator, device=rows.device)
        out[:, :, s] = u.index_select(0, rows)
    out.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(out))


def served_gap(blended: torch.Tensor, seq: torch.Tensor, valid: torch.Tensor,
               top_k: int, temp: float = 1.0,
               gumbel: torch.Tensor = None) -> torch.Tensor:
    """Per generated slot, how far the served token lies below the token
    that the reference draws: ``blended [B, K, S-1, V]`` from
    ``guided_logits``, ``seq [B, K, S]`` the served sequence, ``valid [K,
    S]`` the slots the pattern generates, and ``gumbel`` (``[B, K, S-1,
    V]``, ``gumbel_draws``; None for greedy decoding) the noise it was
    drawn with. The reference's score of a token is ``blended / temp``
    plus its noise, over the ``top_k`` best (0: every token); the gap is
    the best score less the served token's, plus how far the served
    token's ``blended / temp`` lies below the ``top_k``-th best (0 inside
    the top-k). Returns the gaps of the valid slots, flattened."""
    V = blended.shape[-1]
    served = seq[:, :, 1:].long().clamp(0, V - 1)[..., None]
    mask = valid[:, 1:].to(blended.device)
    z = blended / temp
    k = V if top_k <= 0 else min(int(top_k), V)
    least = z.topk(k, dim=-1).values[..., -1:]
    score = z if gumbel is None else z + gumbel
    best = torch.where(z >= least, score, float("-inf")).max(-1).values
    gap = ((best - score.gather(-1, served)[..., 0]).clamp_min(0.0)
           + (least - z.gather(-1, served))[..., 0].clamp_min(0.0))
    return gap[:, mask]


def delayed_sequence(codes: torch.Tensor, special: int) -> Tuple[torch.Tensor,
                                                               torch.Tensor]:
    """The delayed pattern (codebook ``q`` delayed by ``q`` steps after one
    BOS step): codes ``[B, K, T]`` -> ``(seq [B, K, T + K], valid [K, T +
    K])``, ``seq[:, q, s] = codes[:, q, s - 1 - q]`` where that timestep
    exists and ``special`` elsewhere."""
    B, K, T = codes.shape
    S = T + K
    s = torch.arange(S, device=codes.device)
    t = s[None, :] - 1 - torch.arange(K, device=codes.device)[:, None]
    valid = (t >= 0) & (t < T)
    idx = t.clamp(0, T - 1)[None].expand(B, K, S)
    seq = torch.where(valid[None], codes.gather(2, idx),
                      torch.full_like(idx, special))
    return seq, valid


def blocks(n: int, size: int):
    """``range`` slices of ``n`` rows in blocks of ``size``."""
    return [slice(i, min(i + size, n)) for i in range(0, n, size)]

