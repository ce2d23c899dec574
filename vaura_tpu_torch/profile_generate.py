"""Where the time of one flagship generation goes on the card.

    python3 -m vaura_tpu_torch.profile_generate [--batch 2] [--out chiprun_out]
        [--quantize-cache] [--cache-bits {8,4}] [--int8-dots]
        [--quantize-weights] [--long {reprefill,stream_kv}]
        [--sampler configs/modules/samplers/moonlight_9cbs.yaml]

Runs the flagship path (``flagship.py``: frames -> codes -> audio, CFG 6.0,
top-k 128, 221 tokens; the encoder and the codec in slices of 32 clips, as
the benchmark's cells) once to warm up and once timed with CUDA events per
stage, then once more under ``torch.profiler`` (the CUDA activity) with
the program's spans recorded (``utils.spans``), and reports per span name
(the stages, ``encoder.*``, ``decode_setup``, ``decode_step`` and its
forward and sampling, ``decode_revert``, ``dac.slice``) the host time, the
device time of the work issued inside the spans, the device busy share and
the launches, plus the kernels that take the most device time. On one card
the decode loop replays its step from a CUDA graph (``VauraSystem.
_device_loop``): the report gives the share of the call's steps replayed,
and a decode step's host and device ms as a replay (``decode_step.replay``)
against the eager step's forward (``decode_step.forward``), from the same
call profiled once more with the eager loop.
``--quantize-cache`` runs it with the int8 KV cache (the JAX package's
serving default), ``--cache-bits 4`` with the int4 cache, ``--int8-dots``
with the int8 x int8 attention products (both imply a quantized cache),
``--quantize-weights`` with int8 sampler weights. ``--long``
runs ``flagship.py``'s long-horizon configuration instead (``bench.py``'s
long-mode defaults: 10.24 s from 16 segments of frames, ``generate_long`` at
a 0.64 s stride or ``generate_long_kv`` with a window of 4 x 56 steps).
``--sampler`` takes the sampler of a sampler yaml in place of the
flagship's (the DeepSeek-V3 block of ``moonlight_9cbs.yaml``: its eager
loop's spans add ``decode_step.attend`` (the latent attention kernel),
``decode_step.route`` and ``decode_step.experts``). Writes
``profile_generate[_<mode>].json`` into ``--out``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return smi.stdout.strip()


def _union_ns(iv: np.ndarray) -> int:
    """Nanoseconds that the ``[n, 2]`` intervals cover."""
    if len(iv) == 0:
        return 0
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    starts = iv[:, 0].copy()
    starts[1:] = np.maximum(starts[1:], ends[:-1])
    return int(np.clip(iv[:, 1] - starts, 0, None).sum())


def span_report(prof, records) -> dict:
    """Per span name of ``records`` (``utils.spans``, recorded over the
    profiled call): how many, their host milliseconds, the device
    milliseconds of the work issued inside them (the union of the intervals
    of the kernels and copies whose runtime call starts inside one, matched
    by correlation id), that over the host time, the launches and the
    kernels that take the most device time. Reads the profiler's raw events
    (a long generation records millions; ``prof.events()`` would build a
    Python object tree of them all)."""
    issued = {}  # correlation id -> the host start of its runtime call
    dev, names, corr = [], [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CUDA":
            dev.append((e.start_ns(), e.end_ns()))
            names.append(e.name())
            corr.append(e.correlation_id())
        else:
            c, t = e.correlation_id(), e.start_ns()
            if t < issued.get(c, t + 1):
                issued[c] = t
    dev = np.asarray(dev, dtype=np.int64).reshape(-1, 2)
    names = np.asarray(names, dtype=object)
    at = np.asarray([issued.get(c, -1) for c in corr], dtype=np.int64)
    by_name = {}
    for name, _, a, b in records:
        by_name.setdefault(name, []).append((a, b))
    out = {}
    for name, iv in sorted(by_name.items(), key=lambda kv: kv[1][0][0]):
        iv = np.asarray(sorted(iv), dtype=np.int64)
        i = np.searchsorted(iv[:, 0], at, side="right") - 1
        inside = (at >= 0) & (i >= 0) & (at < iv[np.maximum(i, 0), 1])
        host_ns = int((iv[:, 1] - iv[:, 0]).sum())
        busy_ns = _union_ns(dev[inside])
        by_kernel = {}
        for kname, (k0, k1) in zip(names[inside], dev[inside]):
            d = by_kernel.setdefault(kname, [0, 0])
            d[0] += 1
            d[1] += int(k1 - k0)
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:12]
        out[name] = {
            "count": len(iv),
            "host_ms": host_ns / 1e6,
            "device_busy_ms": busy_ns / 1e6,
            "busy_share": busy_ns / max(host_ns, 1),
            "launches": int(inside.sum()),
            "top_kernels": [{"name": n[:90], "launches": c, "ms": t / 1e6}
                            for n, (c, t) in top],
        }
    return out


def print_spans(spans: dict) -> None:
    for name, st in spans.items():
        print(f"[{name}] x{st['count']}: host {st['host_ms']:.1f} ms, device "
              f"busy {st['device_busy_ms']:.1f} ms ({100 * st['busy_share']:.1f}%),"
              f" {st['launches']} launches")
        for k in st["top_kernels"][:6]:
            print(f"    {k['ms']:9.2f} ms {k['launches']:6d}x  {k['name']}")


def replay_report(graphed: dict, eager: dict, replayed: int,
                  eager_steps: int) -> dict:
    """The share of a call's decode steps replayed from the graph, and a
    step's host and device ms in ``decode_step.replay`` (``graphed``, a
    ``span_report`` of the graph loop) and ``decode_step.forward``
    (``eager``, of the eager loop); None where a span is missing."""
    def per_step(spans, name):
        st = spans.get(name)
        if not st:
            return None
        return {"host_ms": st["host_ms"] / st["count"],
                "device_ms": st["device_busy_ms"] / st["count"],
                "launches": st["launches"] / st["count"]}

    total = replayed + eager_steps
    return {"replayed_steps": replayed, "eager_steps": eager_steps,
            "replayed_share": replayed / total if total else None,
            "decode_step.replay": per_step(graphed, "decode_step.replay"),
            "decode_step.forward": per_step(eager, "decode_step.forward")}


def print_replay(rep: dict) -> None:
    share = rep["replayed_share"]
    print(f"decode steps replayed: {rep['replayed_steps']} of "
          f"{rep['replayed_steps'] + rep['eager_steps']}"
          + (f" ({100 * share:.2f}%)" if share is not None else ""))
    for name in ("decode_step.replay", "decode_step.forward"):
        st = rep[name]
        if st:
            print(f"  {name} a step: host {st['host_ms']:.3f} ms, device "
                  f"{st['device_ms']:.3f} ms, {st['launches']:.1f} launches")


def sampler_fields(path: str) -> dict:
    """The sampler configuration of a sampler yaml (``{target, params}``) as
    ``SamplerConfig`` fields, its dtypes left to the caller."""
    import dataclasses
    from pathlib import Path

    from vaura_tpu_torch.config import instantiate_from_config, load_config

    spec = instantiate_from_config(load_config(Path(path), Path.cwd()))
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)
            if not f.name.endswith("dtype")}


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vaura_tpu_torch.flagship import (
        GENERATE_KW,
        LONG_KV_KW,
        LONG_SAMPLER,
        LONG_SEGMENTS,
        LONG_STRIDE_TOKENS,
        LONG_TOKENS,
        TOKENS_PER_SECOND,
        flagship_system,
        random_frames,
    )
    from vaura_tpu_torch.models import vaura as V
    from vaura_tpu_torch.utils.spans import recording

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--quantize-cache", action="store_true")
    ap.add_argument("--cache-bits", type=int, choices=[8, 4], default=8)
    ap.add_argument("--int8-dots", action="store_true")
    ap.add_argument("--quantize-weights", action="store_true")
    ap.add_argument("--long", choices=["reprefill", "stream_kv"])
    ap.add_argument("--sampler", help="a sampler yaml in place of the "
                    "flagship's sampler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_generate needs a CUDA card")

    quantize_cache = (args.quantize_cache or args.cache_bits == 4
                      or args.int8_dots)
    overrides = {"quantize_cache": quantize_cache,
                 "quantize_weights": args.quantize_weights,
                 "cache_bits": args.cache_bits, "int8_dots": args.int8_dots}
    if args.long:
        overrides.update(LONG_SAMPLER)
    if args.sampler:  # its fields, under the flags' own
        overrides = {**sampler_fields(args.sampler), **overrides}
    gen = torch.Generator(device="cuda").manual_seed(0)
    system = flagship_system("cuda", gen, sampler_overrides=overrides)
    if args.long:
        frames = random_frames(args.batch, gen, "cuda", segments=LONG_SEGMENTS)
        kw = {k: GENERATE_KW[k] for k in ("cfg_scale", "top_k",
                                          "tokens_per_frame")}
        kw["total_tokens"] = LONG_TOKENS
        if args.long == "reprefill":
            kw["stride_tokens"] = LONG_STRIDE_TOKENS
            fn = system.generate_long
        else:
            kw.update(LONG_KV_KW)
            fn = system.generate_long_kv

        def run():
            return fn(frames, seed=0, **kw)
    else:
        frames = random_frames(args.batch, gen, "cuda")

        def run():  # the benchmark's slices: 32 clips an encoder and codec call
            return system.generate(frames, seed=0, encoder_chunk_size=32,
                                   dac_chunk_size=32, **GENERATE_KW)

    run()  # build kernels, warm up
    torch.cuda.synchronize()
    t0 = time.time()
    timed = run()
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    stage_ms = timed["stage_ms"]
    codes_shape = list(timed["codes"].shape)
    audio_s = args.batch * codes_shape[-1] / TOKENS_PER_SECOND

    def profiled():
        """The call under the profiler, split by the program's spans, with
        the decode steps it replayed and ran eagerly."""
        steps = V.replayed_steps, V.eager_steps
        with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                recording() as records:
            run()
            torch.cuda.synchronize()
        return (span_report(prof, records), V.replayed_steps - steps[0],
                V.eager_steps - steps[1])

    spans, replayed, eager_steps = profiled()
    # the same call with the eager loop: no loop has this many steps
    min_steps, V.GRAPH_MIN_STEPS = V.GRAPH_MIN_STEPS, 1 << 30
    try:
        eager_spans = profiled()[0]
    finally:
        V.GRAPH_MIN_STEPS = min_steps

    mode = (f"int{args.cache_bits}_cache" if quantize_cache else "") + (
        "_int8_dots" if args.int8_dots else "") + (
        "_int8_weights" if args.quantize_weights else "")
    if args.long:
        mode = f"{mode}_long_{args.long}"
    if args.sampler:
        mode = f"{mode}_{os.path.splitext(os.path.basename(args.sampler))[0]}"
    mode = mode.strip("_")
    report = {"device": torch.cuda.get_device_name(0), "batch": args.batch,
              "nvidia_smi": nvidia_smi(), "mode": mode or "bf16",
              "codes_shape": codes_shape, "audio_seconds": audio_s,
              "wall_s": wall_s, "audio_s_per_s": audio_s / wall_s,
              "stage_ms": stage_ms, "spans": spans,
              "eager_loop_spans": eager_spans,
              "replay": replay_report(spans, eager_spans, replayed,
                                      eager_steps)}
    os.makedirs(args.out, exist_ok=True)
    name = f"profile_generate_{mode}.json" if mode else "profile_generate.json"
    with open(os.path.join(args.out, name), "w") as f:
        json.dump(report, f, indent=1)
    print(f"{report['device']} ({report['nvidia_smi']}), {report['mode']}, "
          f"batch {args.batch}, codes {codes_shape}: wall {wall_s:.3f} s "
          f"({report['audio_s_per_s']:.3f} audio-s/s), stages (ms) {stage_ms}")
    print_spans(report["spans"])
    print_replay(report["replay"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
