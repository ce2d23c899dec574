"""Where one forward of each encoder variant spends its time on the card.

    python3 -m vaura_tpu_torch.profile_encoder [VARIANT ...] [--batch 2] [--out chiprun_out]

VARIANT is one of ``VARIANTS`` (all by default): the flagship ViT-B/16
(``flagship.py``, seeded bf16 weights) as the divided encoder of the fused
sublayers, the trajectory encoder exact and with each approximation, the
joint encoder and the int8 encoder (the divided one's weights quantized).
For each, on frames ``[batch, 4, 3, 16, 224, 224]``: one warm-up forward,
three timed between CUDA events, then one under ``torch.profiler`` (the
CUDA activity) with the program's spans recorded (``utils.spans``: the
encoder's ``encoder.embed``, ``encoder.blocks`` and ``encoder.pool``), and
per span the host time, the device time of the work issued inside it, the
busy share, the launches and the kernels that take the most device time,
and the peak memory. Writes ``profile_encoder.json`` into ``--out``. Needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os

VARIANTS = {
    "divided": {},
    "trajectory": {"attn_layer": "trajectory"},
    "nystrom": {"attn_layer": "trajectory", "approx_attn_type": "nystrom"},
    "orthoformer": {"attn_layer": "trajectory",
                    "approx_attn_type": "orthoformer"},
    "performer": {"attn_layer": "trajectory", "approx_attn_type": "performer"},
    "joint": {"attn_layer": "joint", "pos_embed_type": "joint"},
    "int8": {"quantize": True},
}


def main() -> int:
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from vaura_tpu_torch.flagship import random_frames
    from vaura_tpu_torch.models.motionformer import MotionFormer, MotionFormerConfig
    from vaura_tpu_torch.ops.quantization import quantize_encoder_params
    from vaura_tpu_torch.profile_generate import (
        nvidia_smi,
        print_spans,
        span_report,
    )
    from vaura_tpu_torch.utils import seeded_init_
    from vaura_tpu_torch.utils.spans import recording

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", help=", ".join(VARIANTS))
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    unknown = sorted(set(args.variants) - set(VARIANTS))
    if unknown:
        ap.error(f"unknown variants {unknown}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_encoder needs a CUDA card")

    gen = torch.Generator(device="cuda").manual_seed(0)
    frames = random_frames(args.batch, gen, "cuda")
    base = dataclasses.replace(MotionFormerConfig(), param_dtype=torch.bfloat16)
    report = {"device": torch.cuda.get_device_name(0),
              "nvidia_smi": nvidia_smi(), "batch": args.batch, "variants": {}}
    for name in args.variants or VARIANTS:
        kw = VARIANTS[name]
        enc = MotionFormer(dataclasses.replace(base, **kw), "cuda")
        if kw.get("quantize"):  # the divided encoder's seeded weights
            src = MotionFormer(base, "cuda")
            seeded_init_(src, gen)
            enc.load_state_dict(quantize_encoder_params(src.state_dict()))
            del src
        else:
            seeded_init_(enc, gen)
        enc.requires_grad_(False)
        with torch.no_grad():
            enc(frames)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = []
            for _ in range(3):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                enc(frames)
                b.record()
                b.synchronize()
                ms.append(a.elapsed_time(b))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                    recording() as records:
                enc(frames)
                torch.cuda.synchronize()
        report["variants"][name] = {"forward_ms": ms, "peak_mem_gib": peak,
                                    "spans": span_report(prof, records)}
        print(f"[{name}] forward ms {', '.join(f'{t:.1f}' for t in ms)}; "
              f"peak {peak:.2f} GiB")
        print_spans(report["variants"][name]["spans"])
        del enc
        torch.cuda.empty_cache()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_encoder.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"{report['device']} ({report['nvidia_smi']}), batch {args.batch}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
