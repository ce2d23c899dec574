"""Where the time of one flagship generation goes on the card.

    python3 -m vaura_tpu_torch.profile_generate [--batch 2] [--out chiprun_out]

Runs the flagship path (``flagship.py``: frames -> codes -> audio, CFG 6.0,
top-k 128, 221 tokens) once to warm up and once timed with CUDA events per
stage, then once more under ``torch.profiler`` and reports, per stage, the
wall time, the device time summed over kernels, the device busy share and
the launches, plus the kernels that take the most device time. Writes
``profile_generate.json`` into ``--out``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return smi.stdout.strip()


def stage_report(events, stages) -> dict:
    """Per ``record_function`` range named in ``stages``: its profiled wall
    time, the device time summed over the kernels started inside it, the
    device busy share, the launches and the kernels that take most time."""
    # the longest range of each name: autograd's worker threads repeat the
    # name of the range they were started under
    ranges = {}
    for e in events:
        if e.name in stages:
            a, b = e.time_range.start, e.time_range.end
            if e.name not in ranges or b - a > ranges[e.name][1] - ranges[e.name][0]:
                ranges[e.name] = (a, b)
    # device-side events, without the stages' own annotation ranges
    kernels = [e for e in events
               if e.device_type.name == "CUDA" and e.name not in stages]
    out = {}
    for name, (a, b) in ranges.items():
        inside = [k for k in kernels if a <= k.time_range.start < b]
        busy_us = sum(k.time_range.end - k.time_range.start for k in inside)
        by_name = {}
        for k in inside:
            d = by_name.setdefault(k.name, [0, 0.0])
            d[0] += 1
            d[1] += k.time_range.end - k.time_range.start
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
        out[name] = {
            "profiled_wall_ms": (b - a) / 1e3,
            "device_busy_ms": busy_us / 1e3,
            "busy_share": busy_us / max(b - a, 1),
            "launches": len(inside),
            "top_kernels": [{"name": n[:90], "launches": c, "ms": t / 1e3}
                            for n, (c, t) in top],
        }
    return out


def print_stages(stages: dict) -> None:
    for name, st in stages.items():
        print(f"[{name}] profiled wall {st['profiled_wall_ms']:.1f} ms, device "
              f"busy {st['device_busy_ms']:.1f} ms ({100 * st['busy_share']:.1f}%),"
              f" {st['launches']} launches")
        for k in st["top_kernels"][:6]:
            print(f"    {k['ms']:9.2f} ms {k['launches']:6d}x  {k['name']}")


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from vaura_tpu_torch.flagship import GENERATE_KW, flagship_system, random_frames

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_generate needs a CUDA card")

    gen = torch.Generator(device="cuda").manual_seed(0)
    system = flagship_system("cuda", gen)
    frames = random_frames(args.batch, gen, "cuda")
    system.generate(frames, seed=0, **GENERATE_KW)  # build kernels, warm up
    torch.cuda.synchronize()
    t0 = time.time()
    timed = system.generate(frames, seed=0, **GENERATE_KW)
    wall_s = time.time() - t0
    stage_ms = timed["stage_ms"]

    # the same call split by stage, under the profiler
    stages = ("encoder", "decode_loop", "dac")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("encoder"):
            feats = system.visual_features(frames)
            torch.cuda.synchronize()
        with record_function("decode_loop"):
            out = system.generate(vis_feats=feats, seed=0, decode_to_audio=False,
                                  **GENERATE_KW)
            torch.cuda.synchronize()
        with record_function("dac"):
            system.decode_audio(out["codes"])
            torch.cuda.synchronize()

    report = {"device": torch.cuda.get_device_name(0), "batch": args.batch,
              "nvidia_smi": nvidia_smi(), "wall_s": wall_s,
              "stage_ms": stage_ms, "stages": stage_report(prof.events(), stages)}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_generate.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"{report['device']} ({report['nvidia_smi']}), batch {args.batch}: "
          f"wall {wall_s:.3f} s, stages (ms) {stage_ms}")
    print_stages(report["stages"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
