"""Distribution-level quantization quality: a FAD table of sampled
rollouts.

Counterpart of ``scripts/quant_quality_fad.py``. ``int8_margin_check.py``
measures greedy token agreement, a worst case; serving samples (temp 1.0,
top-k 128, CFG 6), where a flipped argmax need not change the distribution
of the audio. For each quantization arm, sampled rollouts from the SAME
trained weights (the overfit proxy of ``scripts/quant_proxy.py``; the
flagship by default, ``--mid`` 6 x 512, ``--tiny`` 2 x 192) and the SAME
sampling seeds go through one shared codec (seeded weights rounded to bf16)
and are compared with the bf16 arm by the melstats FAD embedder
(``ops/fad.py``), beside a seed-split noise floor (bf16 against bf16 on
disjoint seeds).

Arms: bf16 (the reference), int8 cache with bf16 weights, int8 weights and
cache, int8 + ``int8_dots``, the int4 cache (with int8 weights). Per arm:
``fad`` against bf16, ``kld_melband`` (paired KL between per-clip
normalized mel-band energies) and ``token_agreement`` (context only).

Prints one JSON object with the JAX script's keys, after a ``#`` line per
stage. Runs on CUDA unless ``--platform cpu``, and raises without CUDA
otherwise::

    python -m vaura_tpu_torch.scripts.quant_quality_fad [--mid] [--steps 150]
        [--clips 64]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from vaura_tpu_torch.ops.fad import (
    MelStatsEmbedder,
    frechet_audio_distance,
    paired_kl_divergence_from_probs,
)
from vaura_tpu_torch.scripts.quant_proxy import (
    overfit,
    proxy_config,
    proxy_device,
    use_arm,
)
from vaura_tpu_torch.utils import seeded_init_

ARMS = {  # use_arm's arguments of each quantized arm
    "int8_cache": dict(quantize_cache=True),
    "int8": dict(quantize_weights=True, quantize_cache=True),
    "int8_dots": dict(quantize_weights=True, quantize_cache=True,
                      int8_dots=True),
    "int4_kv": dict(quantize_weights=True, quantize_cache=True, cache_bits=4),
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8,
                    help="overfit training batch")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--tokens", type=int, default=221)
    ap.add_argument("--clips", type=int, default=64,
                    help="sampled clips per arm (gen batch per seed)")
    ap.add_argument("--gen-batch", type=int, default=16)
    ap.add_argument("--platform", type=str, default=None)
    ap.add_argument("--mid", action="store_true", help="6L x 512d proxy")
    ap.add_argument("--tiny", action="store_true",
                    help="2L x 192d logic check (NOT representative)")
    ap.add_argument("--temp", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=128)
    ap.add_argument("--cfg-scale", type=float, default=6.0)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = proxy_device(args.platform)
    sampler_cfg = proxy_config(args.tiny, args.mid)
    if args.tiny:
        args.tokens = min(args.tokens, 48)
        args.clips = min(args.clips, 2 * args.gen_batch)
    system, trained, run = overfit(sampler_cfg, device, steps=args.steps,
                                   batch=args.batch, lr=args.lr,
                                   tokens=args.tokens)
    print(f"# overfit: loss -> {run['loss']:.4f} ({args.steps} steps, "
          f"{run['seconds']:.0f}s)", flush=True)
    # one shared codec decodes every arm's codes: seeded weights rounded to
    # bf16, as the JAX script's bf16 codec
    seeded_init_(system.dac, torch.Generator(device).manual_seed(7))
    for p in system.dac.parameters():
        p.copy_(p.to(torch.bfloat16).float())
    system.dac.requires_grad_(False)

    vis = run["vis"]
    n_seeds = -(-args.clips // args.gen_batch)
    seeds = list(range(100, 100 + n_seeds))
    floor_seeds = list(range(500, 500 + n_seeds))
    reps = -(-args.gen_batch // vis.shape[0])
    vis_gen = vis.repeat(reps, 1, 1)[: args.gen_batch]
    embedder = MelStatsEmbedder()
    sr = system.dac.cfg.sample_rate

    def run_arm(seed_list):
        wavs, toks = [], []
        for s in seed_list:
            out = system.generate(
                vis_feats=vis_gen, seed=s, max_new_tokens=args.tokens,
                tokens_per_frame=7, use_sampling=True, temp=args.temp,
                top_k=args.top_k, cfg_scale=args.cfg_scale,
                decode_to_audio=True)
            wavs.append(out["audio"].float().cpu().numpy())
            toks.append(out["codes"].cpu().numpy())
        wav = np.concatenate(wavs)[: args.clips]
        tok = np.concatenate(toks)[: args.clips]
        emb = np.stack([embedder(w.reshape(-1), sr) for w in wav])
        # per clip, the mel-band energy distribution (the first n_mels dims
        # of the embedding are log-mel means)
        return emb, np.exp(emb[:, : embedder.n_mels]), tok

    t0 = time.time()
    use_arm(system, sampler_cfg, trained)
    emb_ref, mel_ref, tok_ref = run_arm(seeds)
    emb_floor, _, _ = run_arm(floor_seeds)
    noise_floor = frechet_audio_distance(emb_ref, emb_floor)
    print(f"# bf16 + floor rollouts done ({time.time() - t0:.0f}s)",
          flush=True)
    results = {}
    for name, kw in ARMS.items():
        use_arm(system, sampler_cfg, trained, **kw)
        emb, mel, tok = run_arm(seeds)
        results[name] = {
            "fad": round(frechet_audio_distance(emb_ref, emb), 4),
            "kld_melband": round(
                paired_kl_divergence_from_probs(mel_ref, mel), 5),
            "token_agreement": round(float((tok == tok_ref).mean()), 4),
        }
        print(f"# {name} done ({time.time() - t0:.0f}s)", flush=True)
    result = {
        "overfit_loss": round(run["loss"], 4),
        "fad_noise_floor_bf16_seed_split": round(noise_floor, 4),
        "arms": results,
        "clips": int(args.clips),
        "sampling": {"temp": args.temp, "top_k": args.top_k,
                     "cfg_scale": args.cfg_scale},
        "scale": "tiny" if args.tiny else "mid" if args.mid else "flagship",
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
