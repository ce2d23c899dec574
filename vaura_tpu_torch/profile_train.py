"""Where the time of one flagship training step goes on the card.

    python3 -m vaura_tpu_torch.profile_train [--batch 2] [--remat] [--out chiprun_out]

Builds the flagship training configuration (``flagship.py``: float32
parameters, bf16 compute, unfrozen encoder, audio through the DAC encoder),
takes two steps to warm up, times three with CUDA events (forward, backward,
optimizer), then takes one more under ``torch.profiler`` (the CUDA
activity) with the program's spans recorded (``utils.spans``) and reports
per span name (the three stages, ``train.codec_encode``,
``train.encoder`` and the encoder's parts, ``train.sampler``,
``train.loss``, ``train.backward``, ``train.optimizer``) the host time, the
device time of the work issued inside the spans, the device busy share,
the launches and the kernels that take the most device time, and the peak
memory. Writes ``profile_train.json`` into ``--out``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vaura_tpu_torch.flagship import (
        flagship_system,
        flagship_train_state,
        random_train_batch,
    )
    from vaura_tpu_torch.profile_generate import (
        nvidia_smi,
        print_spans,
        span_report,
    )
    from vaura_tpu_torch.train.steps import make_train_step
    from vaura_tpu_torch.utils import StageClock
    from vaura_tpu_torch.utils.spans import recording

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--remat", action="store_true",
                    help="recompute the sampler's blocks in the backward pass")
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")

    gen = torch.Generator(device="cuda").manual_seed(0)
    system = flagship_system("cuda", gen, training=True,
                             sampler_overrides={"remat": args.remat})
    state = flagship_train_state(system)
    batch = random_train_batch(args.batch, gen, "cuda")
    train_step = make_train_step(system)
    for _ in range(2):
        state, _ = train_step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = []
    for _ in range(3):
        clock = StageClock(system.device)
        clock.mark("start")
        state, metrics = train_step(state, batch, gen, clock=clock)
        timed.append({**clock.ms(), "loss": float(metrics["loss"])})
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            recording() as records:
        clock = StageClock(system.device)
        clock.mark("start")
        state, _ = train_step(state, batch, gen, clock=clock)
        torch.cuda.synchronize()

    report = {"device": torch.cuda.get_device_name(0), "batch": args.batch,
              "remat": args.remat, "nvidia_smi": nvidia_smi(),
              "step_ms": timed, "peak_mem_gib": peak_gib,
              "spans": span_report(prof, records)}
    os.makedirs(args.out, exist_ok=True)
    name = "profile_train_remat.json" if args.remat else "profile_train.json"
    with open(os.path.join(args.out, name), "w") as f:
        json.dump(report, f, indent=1)
    print(f"{report['device']} ({report['nvidia_smi']}), batch {args.batch}, "
          f"remat {args.remat}: peak memory {peak_gib:.2f} GiB; steps (ms):")
    for t in timed:
        print("    " + ", ".join(f"{k} {v:.1f}" for k, v in t.items()
                                 if k != "loss") + f", loss {t['loss']:.5f}")
    print_spans(report["spans"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
