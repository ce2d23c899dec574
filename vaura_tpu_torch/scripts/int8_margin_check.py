"""Quantized generation at TRAINED logit margins.

Counterpart of ``scripts/int8_margin_check.py``. Random weights have logit
margins near zero, so any perturbation flips the argmax and says nothing
about serving quality. The proxy of a trained model is the sampler overfit
on one fixed batch (``scripts/quant_proxy.py``: the flagship 24 x 1536 by
default, ``--mid`` 6 x 512, ``--tiny`` 2 x 192 for a logic check only),
whose margins on its training distribution are real. From the SAME trained
weights it measures the quantized arm (int8 weights and the int8 cache;
``--cache-only``: bf16 weights over the quantized cache; ``--cache-bits
4``: the int4 cache; ``--int8-dots``: int8 x int8 attention products)
against bf16:

  * teacher-forced argmax agreement on the training batch (the cache is
    not used there: with ``--cache-only`` both arms compute the same)
  * greedy token agreement over whole rollouts at CFG 1 and 6 (the serving
    default; CFG subtracts two quantized passes)
  * the mean first step where a rollout diverges, per CFG
  * mean |logit delta| / std(logits)

Prints one JSON object with the JAX script's keys, after a ``#`` line per
stage. Runs on CUDA unless ``--platform cpu``, and raises without CUDA
otherwise::

    python -m vaura_tpu_torch.scripts.int8_margin_check [--mid] [--steps 150]
        [--batch 8] [--cache-bits 4] [--int8-dots] [--cache-only]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from vaura_tpu_torch.scripts.quant_proxy import (
    overfit,
    proxy_config,
    proxy_device,
    use_arm,
)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--tokens", type=int, default=221)
    ap.add_argument("--platform", type=str, default=None)
    ap.add_argument("--gen-batch", type=int, default=8)
    ap.add_argument("--tiny", action="store_true",
                    help="2L x 192d logic check (margins NOT representative)")
    ap.add_argument("--mid", action="store_true", help="6L x 512d proxy")
    ap.add_argument("--cache-bits", type=int, choices=[8, 4], default=8,
                    help="quantized KV-cache width of the quantized arm")
    ap.add_argument("--int8-dots", action="store_true",
                    help="int8 x int8 attention products in the quantized arm")
    ap.add_argument("--cache-only", action="store_true",
                    help="quantized arm = bf16 weights + quantized KV cache")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = proxy_device(args.platform)
    sampler_cfg = proxy_config(args.tiny, args.mid)
    if args.tiny:
        args.tokens = min(args.tokens, 48)
    system, trained, run = overfit(sampler_cfg, device, steps=args.steps,
                                   batch=args.batch, lr=args.lr,
                                   tokens=args.tokens)
    print(f"# overfit: loss {run['loss0']:.3f} -> {run['loss']:.3f} "
          f"({args.steps} steps, {run['seconds']:.0f}s)", flush=True)
    codes, vis = run["codes"], run["vis"]

    def arm(quantize: bool) -> None:
        use_arm(system, sampler_cfg, trained,
                quantize_weights=quantize and not args.cache_only,
                quantize_cache=quantize, cache_bits=args.cache_bits,
                int8_dots=args.int8_dots and quantize)

    @torch.no_grad()
    def tf_logits():
        _, aux = system.train_forward(None, None, None, train=False,
                                      vis_feats=vis, codes=codes)
        return aux["logits"].float().cpu().numpy(), aux["mask"].cpu().numpy()

    def rollout(cfg_scale: float) -> np.ndarray:
        return system.generate(
            vis_feats=vis[: args.gen_batch], seed=1,
            max_new_tokens=args.tokens, tokens_per_frame=7,
            use_sampling=False, cfg_scale=cfg_scale,
            decode_to_audio=False)["codes"].cpu().numpy()

    t0 = time.time()
    arm(False)
    lf, mask = tf_logits()
    rolls_f = {cs: rollout(cs) for cs in (1.0, 6.0)}
    arm(True)
    lq, _ = tf_logits()
    rolls_q = {cs: rollout(cs) for cs in (1.0, 6.0)}
    print(f"# teacher-forced and rollouts ({time.time() - t0:.0f}s)",
          flush=True)
    mask = mask.astype(bool)
    tf_agree = float((lf.argmax(-1)[mask] == lq.argmax(-1)[mask]).mean())
    delta = float(np.abs(lq - lf)[mask].mean() / (lf[mask].std() + 1e-9))
    gen_agree, first_div = {}, {}
    for cs in (1.0, 6.0):
        cf, cq = rolls_f[cs], rolls_q[cs]
        gen_agree[f"cfg{cs:g}"] = float((cf == cq).mean())
        # per sample, the first step where any codebook disagrees (greedy
        # rollouts part for good after one flip)
        mism = (cf != cq).any(axis=1)  # [B, T]
        T = mism.shape[1]
        firsts = np.where(mism.any(axis=1), mism.argmax(axis=1), T)
        first_div[f"cfg{cs:g}"] = float(firsts.mean())
    result = {
        "overfit_loss": round(run["loss"], 4),
        "teacher_forced_argmax_agreement": round(tf_agree, 4),
        "greedy_token_agreement_cfg1": round(gen_agree["cfg1"], 4),
        "greedy_token_agreement_cfg6": round(gen_agree["cfg6"], 4),
        "greedy_mean_first_divergence_step_cfg1": first_div["cfg1"],
        "greedy_mean_first_divergence_step_cfg6": first_div["cfg6"],
        "mean_abs_logit_delta_over_std": round(delta, 5),
        "steps": args.steps, "batch": args.batch, "tokens": args.tokens,
        "cache_bits": args.cache_bits, "int8_dots": args.int8_dots,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
