"""Plain float32 reference of the VGGSound recipe's training step
(``9cb-viscond-avclip-channel_concat-llama.yaml``): the frozen MotionFormer
features and the frozen codec's codes, the sampler teacher-forced over the
delayed pattern with the recipe's dropout, the per-codebook cross entropy,
its gradients, value clipping and AdamW.

* The pattern: codebook ``q`` delayed ``q`` steps after one BOS step, built
  over the codes without their last timestep; step ``s`` of codebook ``q``
  predicts timestep ``s - q``. The loss is the mean over codebooks of each
  codebook's mean cross entropy over every row and timestep.
* Dropout (rate ``dropout`` on the embedded input and on each layer's
  attention and feed-forward outputs; whole rows of the visual condition
  replaced by the null condition with ``class_dropout_prob``) draws its
  masks from the step's generator in the order the recipe's model draws
  them: the condition's rows, the input, then each layer's two masks, each
  layer (with ``remat``) from a generator seeded by one draw of the step's.
  The masks are a function of the step's seed; the reference makes them
  itself.
* AdamW: gradients clipped by value, bias-corrected moments, epsilon
  outside the square root, decoupled weight decay on the matrices, the
  learning rate of the recipe's schedule at the optimizer's step count
  (linear warmup from 0, then cosine). The null condition's table is
  frozen.

``fp8_matmul`` gives ``calibrate.py``'s fp8 reading: the same step with
every product of the sampler taken over e4m3-rounded operands (per-tensor
scales), one step of precision below the recipe's bf16.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference import sampler as S

FROZEN = ("cls_embeddings.uncond_embedding",)


def lr_at(sched: dict, base_lr: float, count: int) -> float:
    """The recipe's cosine schedule at step ``count``."""
    w, total = sched["warmup_steps"], sched["total_steps"]
    floor = sched.get("lr_min_ratio", 0.0)
    if count < w:
        return base_lr * count / max(w, 1)
    frac = min((count - w) / max(total - w, 1), 1.0)
    return base_lr * (floor + 0.5 * (1 - floor) * (1 + math.cos(math.pi * frac)))


def draw_masks(cfg: dict, batch: int, seq: int, gen: torch.Generator,
               device) -> Tuple[torch.Tensor, Dict, float]:
    """``(null_rows [B] bool, keep masks {(where, layer): [B, S, d] bool},
    keep probability)`` of one step, drawn from ``gen``."""
    rate = cfg.get("dropout", 0.1)
    keep = 1.0 - rate
    d = cfg["d_model"]
    null_rows = torch.rand((batch,), generator=gen, device=device) < cfg.get(
        "class_dropout_prob", 0.1)
    masks = {("input", None): torch.rand((batch, seq, d), generator=gen,
                                         device=device) < keep}
    for i in range(cfg["num_layers"]):
        g = gen
        if cfg.get("remat", False):
            seed = int(torch.randint(0, 2 ** 62, (1,), device=device,
                                     generator=gen))
            g = torch.Generator(device=device).manual_seed(seed)
        for where in ("attn_out", "ffn_out"):
            masks[(where, i)] = torch.rand((batch, seq, d), generator=g,
                                           device=device) < keep
    return null_rows, masks, keep


def fp8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.t()`` over operands rounded to float8 e4m3 with per-tensor
    scales; the gradient passes the rounding unchanged."""
    def q(t):
        t = t.float()
        s = t.detach().abs().amax().clamp_min(1e-12) / 448.0
        r = (t / s).to(torch.float8_e4m3fn).float() * s
        return t + (r - t).detach()
    return q(x) @ q(w).t()


def loss_and_grads(params: Dict[str, torch.Tensor], cfg: dict,
                   feats: torch.Tensor, codes: torch.Tensor,
                   null_rows: torch.Tensor, masks: Dict, keep: float,
                   block: int = 4, matmul=None
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The step's loss and the gradient of every leaf of ``params`` (float32
    leaves), over the batch in blocks of ``block`` rows."""
    w = S.widths(cfg)
    B, K, Ta = codes.shape
    V = w["V"]
    codes_in = codes.clone()
    codes_in[..., -1] = V
    seq, _ = S.delayed_sequence(codes_in, V)
    Sq = seq.shape[-1]
    tpf = math.ceil((Sq - K) / feats.shape[1])
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total = 0.0
    for sl in S.blocks(B, block):
        f = feats[sl].float()
        null = S.uncond_features(leaves, f.shape[0], f.shape[1])
        f = torch.where(null_rows[sl][:, None, None], null, f)
        cond = S.cond_sequence(leaves, S.project_cond(leaves, f), Sq, tpf)
        drop = lambda x, where, layer, sl=sl: (
            x * masks[(where, layer)][sl].float() / keep)
        logits = S.forward(leaves, cfg, seq[sl], cond, drop, matmul)
        loss = 0.0
        for q in range(K):
            lq = logits[:, q, q:q + Ta].reshape(-1, V)
            loss = loss + F.cross_entropy(lq, codes[sl, q].reshape(-1).long(),
                                          reduction="sum") / (B * Ta)
        loss = loss / K
        loss.backward()
        total += loss.item()
    grads = {k: v.grad for k, v in leaves.items()}
    return total, grads


class AdamW:
    """The recipe's optimizer over float32 leaves (updated in place)."""

    def __init__(self, params: Dict[str, torch.Tensor], opt: dict):
        self.p, self.opt, self.count = params, opt, 0
        self.live = [k for k in params if k not in FROZEN]
        self.m = {k: torch.zeros_like(params[k]) for k in self.live}
        self.v = {k: torch.zeros_like(params[k]) for k in self.live}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Apply one step; returns the clipped gradients."""
        o = self.opt
        b1, b2 = o["betas"]
        clip, wd = o["gradient_clip_val"], o["weight_decay"]
        lr = lr_at(o["schedule"], o["learning_rate"], self.count)
        self.count += 1
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        clipped = {}
        for k in self.live:
            g = grads[k].clamp(-clip, clip)
            clipped[k] = g
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (self.m[k] / bc1) / ((self.v[k] / bc2).sqrt() + 1e-8)
            if self.p[k].ndim >= 2:
                upd = upd + wd * self.p[k]
            self.p[k].sub_(lr * upd)
        return clipped


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   floor_share: float = 1e-3) -> float:
    """The worst leaf's ``|prog - ref| / max(ref, median ref)`` over the
    leaves of ``ref`` whose reference norm is at least ``floor_share`` of
    the median leaf's (leaves moved by round-off alone left out). A leaf
    missing from ``prog`` reads 1."""
    vals = sorted(ref.values())
    med = vals[len(vals) // 2] if vals else 0.0
    return max((abs(prog.get(k, 0.0) - r) / max(r, med, 1e-30)
                for k, r in ref.items()
                if r >= floor_share * med), default=0.0)
