"""Plain float32 reference of V-AURA's sampler with a DeepSeek-V3 decoder:
Moonlight-16B-A3B's block (https://huggingface.co/moonshotai/Moonlight-16B-A3B,
``model_type`` ``deepseek_v3``; arXiv:2412.19437 §2.1) in place of the
Llama block, teacher-forced over a whole sequence.

V-AURA's embeddings, visual conditioning and LM head are the Llama
reference's (``sampler.py``: ``token_embedding``, ``project_cond``,
``uncond_features``, ``cond_sequence``, ``_rms``, ``_rope``; called, not
copied). Each layer ``i``, with ``h`` its RMS-normed input:

- latent attention, no query compression: ``q = wq h`` (per head
  ``[q_nope; q_pe]``), ``[c; k_pe] = wkv_a h``, ``c = RMSNorm(c)``,
  ``[k_nope; v] = wkv_b c`` per head; interleaved-pair RoPE (base
  ``rope_base``) on ``q_pe`` and the one ``k_pe`` every head shares; scores
  ``(q_nope . k_nope + q_pe . k_pe) / sqrt(qk_nope + qk_rope)``, causal
  softmax, ``wo`` over the heads' ``p v``;
- layers below ``first_k_dense_replace``: SwiGLU of ``intermediate_size``;
- the others: ``s = sigmoid(h gate^T)``, experts ``topk(s + bias,
  num_experts_per_tok)``, weights ``s`` of the chosen renormalised
  (``norm_topk_prob``) and times ``routed_scaling_factor``; output ``sum_j
  w_j E_j(h) + S(h)``, each ``E_j`` a SwiGLU of ``moe_intermediate_size``
  and ``S`` the shared experts as one SwiGLU ``n_shared_experts`` times as
  wide. A loop over the experts, each taking the rows routed to it.

Routing ties. With random weights the router's scores lie close together:
rounding alone (the program's bf16 against this float32) picks another
expert for some tokens, and one such choice changes everything after it
(on the card at published widths, 4% of the tokens' expert sets differ
after the first routed layer and 80% after the last; the logits then differ
by 31% relative, against 1.9% when the choices agree). So the comparison
may hand ``forward`` the program's choices (``routes``): each routed layer
then takes the program's experts wherever the program chose as many
distinct experts as configured, weighs them from its own scores, and
reports how far they lie below its own top-k (``route_gap``: the k-th best
of its ``s + bias`` less the least of theirs, 0 for a top-k, 1 where the
program's choice is not ``k`` distinct experts, which it does not follow).
A wrong router then shows in ``route_gap``, wrong arithmetic in the logits.

Everything is float32 from the given tensors (any storage dtype), each
weight cast when it is used, so on the card one layer's weights at a time
are held in float32 beside the program's bf16 ones. No cache, no batching
of experts, no decode path: a decode through the latent cache must agree
with this full forward at every position. The caller sets
``allow_tf32`` False for matmul and cuDNN (``check.exact_matmuls``).

Departures from the published model: the 163,840-entry text vocabulary
(its embedding and head) is replaced by V-AURA's nine 1,024-code tables and
its head over the nine codebooks, and the visual condition is concatenated
on the channel axis as in V-AURA; the weights are drawn from a seed
(``param_specs``), the correction bias too (N(0, 0.02)); no multi-token
prediction layer (``num_nextn_predict_layers`` 0 in the source too).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from port_bench.reference import sampler as S

Spec = S.Spec


def widths(cfg: dict) -> dict:
    """The derived widths of a DeepSeek-V3 sampler configuration: the Llama
    reference's (embeddings, conditioning, head) and the block's own."""
    w = S.widths(cfg)
    w.update(R=cfg["kv_lora_rank"], dn=cfg["qk_nope_head_dim"],
             dr=cfg["qk_rope_head_dim"], dv=cfg["v_head_dim"],
             E=cfg["n_routed_experts"], k=cfg["num_experts_per_tok"],
             shared=cfg["n_shared_experts"] * cfg["moe_intermediate_size"],
             I=cfg["moe_intermediate_size"], dense=cfg["intermediate_size"],
             first_moe=cfg["first_k_dense_replace"],
             norm_topk=cfg.get("norm_topk_prob", True),
             route_scale=cfg.get("routed_scaling_factor", 1.0))
    return w


def param_specs(cfg: dict) -> List[Spec]:
    """Every parameter ``(name, shape, init)`` (``weights.init_std``'s rules:
    ``fan_in`` for a ``[out, in]`` weight, ``axis1`` for the stacked experts
    ``[E, in, out]``, whose fan-in is their second axis; ``emb`` for the
    correction bias)."""
    w = widths(cfg)
    d, H = w["d"], w["heads"]
    # the embeddings, the conditioning and the head: the Llama reference's
    specs = S.param_specs({**cfg, "num_layers": 0})
    for i in range(w["L"]):
        p = f"layers.{i}."
        specs += [
            (p + "attention.wq.weight", (H * (w["dn"] + w["dr"]), d), "fan_in"),
            (p + "attention.wkv_a.weight", (w["R"] + w["dr"], d), "fan_in"),
            (p + "attention.kv_norm.weight", (w["R"],), "ones"),
            (p + "attention.wkv_b.weight", (H * (w["dn"] + w["dv"]), w["R"]),
             "fan_in"),
            (p + "attention.wo.weight", (d, H * w["dv"]), "fan_in"),
            (p + "attention_norm.weight", (d,), "ones"),
            (p + "ffn_norm.weight", (d,), "ones"),
        ]
        f = p + "feed_forward."
        if i < w["first_moe"]:
            specs += [(f + "w1.weight", (w["dense"], d), "fan_in"),
                      (f + "w3.weight", (w["dense"], d), "fan_in"),
                      (f + "w2.weight", (d, w["dense"]), "fan_in")]
            continue
        E, I = w["E"], w["I"]
        specs += [
            (f + "gate.weight", (E, d), "fan_in"),
            (f + "gate.e_score_correction_bias", (E,), "emb"),
            (f + "experts.w1", (E, d, I), "axis1"),
            (f + "experts.w3", (E, d, I), "axis1"),
            (f + "experts.w2", (E, I, d), "axis1"),
            (f + "shared.w1.weight", (w["shared"], d), "fan_in"),
            (f + "shared.w3.weight", (w["shared"], d), "fan_in"),
            (f + "shared.w2.weight", (d, w["shared"]), "fan_in"),
        ]
    return specs


def _mm(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return x @ weight.float().t()


def _swiglu(sd, pre: str, x: torch.Tensor) -> torch.Tensor:
    return _mm(F.silu(_mm(x, sd[pre + "w1.weight"])) * _mm(x, sd[pre + "w3.weight"]),
               sd[pre + "w2.weight"])


def attention(sd: Dict[str, torch.Tensor], pre: str, w: dict, x: torch.Tensor
              ) -> torch.Tensor:
    """Causal latent attention over ``x [B, T, d]`` (normed)."""
    B, T, _ = x.shape
    H, dn, dr, dv, R = w["heads"], w["dn"], w["dr"], w["dv"], w["R"]
    pos = torch.arange(T, device=x.device)
    q = _mm(x, sd[pre + "wq.weight"]).reshape(B, T, H, dn + dr)
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    q_pe = S._rope(q_pe, pos, w["rope_base"])
    c, k_pe = _mm(x, sd[pre + "wkv_a.weight"]).split([R, dr], dim=-1)
    c = S._rms(c, sd[pre + "kv_norm.weight"], w["eps"])
    k_pe = S._rope(k_pe[:, :, None], pos, w["rope_base"])[:, :, 0]
    k_nope, v = _mm(c, sd[pre + "wkv_b.weight"]).reshape(B, T, H, dn + dv).split(
        [dn, dv], dim=-1)
    scores = (torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
              + torch.einsum("bshd,btd->bhst", q_pe, k_pe)) / math.sqrt(dn + dr)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.einsum("bhst,bthd->bshd", scores.softmax(-1), v)
    return _mm(out.reshape(B, T, H * dv), sd[pre + "wo.weight"])


def route(sd: Dict[str, torch.Tensor], pre: str, w: dict, x: torch.Tensor):
    """``x [N, d]`` -> ``(choice [N, k], weights [N, k])``: the experts of
    the ``k`` best ``s + bias`` and their weights from ``s`` alone."""
    s = torch.sigmoid(_mm(x, sd[pre + "gate.weight"]))
    choice = (s + sd[pre + "gate.e_score_correction_bias"].float()).topk(
        w["k"], dim=-1).indices
    weights = s.gather(1, choice)
    if w["norm_topk"]:
        weights = weights / weights.sum(-1, keepdim=True)
    return choice, weights * w["route_scale"]


NO_EXPERT = 255  # an entry of the program's choices where it chose none


def route_gap(biased: torch.Tensor, follow: torch.Tensor, k: int
              ) -> torch.Tensor:
    """Per token, how far the chosen experts ``follow [N, k']`` lie below the
    ``k``-th best of ``biased [N, E]`` (``s + bias``): 0 for a top-k, 1
    where ``follow`` is not ``k`` distinct experts."""
    E = biased.shape[-1]
    kth = biased.topk(k, dim=-1).values[:, -1]
    if follow.shape[-1] != k:
        return torch.ones_like(kth)
    f = follow.long()
    ok = (f < E).all(-1)
    srt = f.sort(-1).values
    ok &= (srt[:, 1:] != srt[:, :-1]).all(-1)
    low = biased.gather(1, f.clamp(max=E - 1)).min(-1).values
    return torch.where(ok, (kth - low).clamp_min(0.0), torch.ones_like(kth))


def experts(sd: Dict[str, torch.Tensor], pre: str, w: dict, x: torch.Tensor,
            choice: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``sum_j w_j E_j(x)``: expert by expert, over the rows routed to it."""
    out = torch.zeros_like(x)
    for e in range(w["E"]):
        rows, slot = (choice == e).nonzero(as_tuple=True)
        if len(rows) == 0:
            continue
        xe = x[rows]
        y = (F.silu(xe @ sd[pre + "experts.w1"][e].float())
             * (xe @ sd[pre + "experts.w3"][e].float())) @ sd[pre + "experts.w2"][e].float()
        out.index_add_(0, rows, y * weights[rows, slot][:, None])
    return out


def moe(sd: Dict[str, torch.Tensor], pre: str, w: dict, x: torch.Tensor,
        follow: torch.Tensor = None, gaps: list = None) -> torch.Tensor:
    """The routed-expert layer over ``x [..., d]`` (normed); with
    ``follow`` (the program's choices, ``[..., k']``) its choices wherever
    ``route_gap`` is under 1, each token's gap appended to ``gaps``."""
    flat = x.reshape(-1, x.shape[-1])
    choice, weights = route(sd, pre, w, flat)
    if follow is not None:
        follow = follow.reshape(flat.shape[0], -1).to(flat.device)
        s = torch.sigmoid(_mm(flat, sd[pre + "gate.weight"]))
        biased = s + sd[pre + "gate.e_score_correction_bias"].float()
        gap = route_gap(biased, follow, w["k"])
        if gaps is not None:
            gaps.append(gap)
        if follow.shape[-1] == w["k"]:
            choice = torch.where((gap < 1.0)[:, None], follow.long(), choice)
        weights = s.gather(1, choice)
        if w["norm_topk"]:
            weights = weights / weights.sum(-1, keepdim=True)
        weights = weights * w["route_scale"]
    out = experts(sd, pre, w, flat, choice, weights) + _swiglu(sd, pre + "shared.", flat)
    return out.reshape(x.shape)


def forward(sd: Dict[str, torch.Tensor], cfg: dict, tokens: torch.Tensor,
            cond_seq: torch.Tensor, routes: torch.Tensor = None,
            gaps: list = None) -> torch.Tensor:
    """Causal forward: tokens ``[B, K, S]`` and the per-position condition
    ``cond_seq [B, S, cond_dim]`` -> logits ``[B, K, S, V]``, float32.
    ``routes``, when given, are the program's choices at these rows and
    positions, ``[S', routed layers, B, k']`` (its decode's record: row
    ``p`` the step that read position ``p``; ``S' >= S``), which the
    routed layers follow (``moe``), each token's ``route_gap`` appended to
    ``gaps``."""
    w = widths(cfg)
    B, K, T = tokens.shape
    h = torch.cat([cond_seq.float(), S.token_embedding(sd, cfg, tokens)], -1)
    for i in range(w["L"]):
        p = f"layers.{i}."
        h = h + attention(sd, p + "attention.", w,
                          S._rms(h, sd[p + "attention_norm.weight"], w["eps"]))
        x = S._rms(h, sd[p + "ffn_norm.weight"], w["eps"])
        f = p + "feed_forward."
        if i < w["first_moe"]:
            h = h + _swiglu(sd, f, x)
            continue
        follow = (None if routes is None else
                  routes[:T, i - w["first_moe"]].transpose(0, 1))
        h = h + moe(sd, f, w, x, follow, gaps)
    h = S._rms(h, sd["norm.weight"], w["eps"])
    logits = _mm(h, sd["lm_head.weight"])
    return logits.reshape(B, T, K, w["V"]).permute(0, 2, 1, 3)


def guided_logits(sd: Dict[str, torch.Tensor], cfg: dict, seq: torch.Tensor,
                  feats: torch.Tensor, tokens_per_frame: int,
                  cfg_scale: float, routes=None, gaps: list = None
                  ) -> torch.Tensor:
    """``sampler.guided_logits`` with this decoder: the CFG-blended logits
    of every step of a generated sequence ``seq [B, K, S]`` (step ``s``'s
    predict ``seq[:, :, s + 1]``) from visual features ``[B, Tv,
    cond_in]``; ``[B, K, S - 1, V]``. ``routes``: the program's choices
    of the rows with the condition and of their null-condition rows
    (``forward``'s, a pair), followed; ``gaps`` as ``forward``'s."""
    B, _, T = seq.shape
    inp = seq[:, :, :T - 1]
    cond_r, null_r = routes if routes is not None else (None, None)
    cond = S.cond_sequence(sd, S.project_cond(sd, feats), T - 1, tokens_per_frame)
    logits = forward(sd, cfg, inp, cond, cond_r, gaps)
    if cfg_scale <= 1.0:
        return logits
    null = S.project_cond(sd, S.uncond_features(sd, B, feats.shape[1]))
    uncond = forward(sd, cfg, inp, S.cond_sequence(sd, null, T - 1,
                                                   tokens_per_frame),
                     null_r, gaps)
    return uncond + (logits - uncond) * cfg_scale
