"""Readings behind the limits of ``correct``, on the card (the benchmark's
own runs never run this)::

    python3 -m port_bench.calibrate --workload <cell> --seeds 12
        [--controls int8_weights,int4_cache,bf16_codec] [--out DIR]

For each seed, one call or step at the cell's own load, compared with the
reference as a run compares (``calibration_run`` of the cell's traffic
kind). First the program as the configuration states it, on ``--seeds``
seeds; then each control or planted fault the kind names (``CONTROLS``,
``FAULTS``, ``fp8_reference``), on ``--control-seeds`` seeds. One JSON
line a reading goes to ``DIR/calibrate_<cell>.jsonl``; the largest sound
reading and the smallest control reading of each number are printed
last.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import time
from pathlib import Path

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--controls", default="")
    ap.add_argument("--first-seed", type=int, default=3_000_000_019)
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from port_bench.run import load_cell, set_cache_dirs

    root = Path.cwd()
    set_cache_dirs(root)
    cell = load_cell(root, args.workload)
    kind = importlib.import_module(f"port_bench.traffic.{cell['mix']['kind']}")
    device = torch.device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"calibrate_{args.workload}.jsonl"
    seeds = [args.first_seed + 7919 * i
             for i in range(max(args.seeds, args.control_seeds))]
    plan = [("program", s) for s in seeds[:args.seeds]]
    for name in filter(None, args.controls.split(",")):
        plan += [(name, s) for s in seeds[:args.control_seeds]]
    rows = []
    with path.open("a") as f:
        for variant, seed in plan:
            t = time.perf_counter()
            readings = kind.calibration_run(cell, variant, seed, device)
            line = {"cell": args.workload, "variant": variant, "seed": seed,
                    "readings": readings, "seconds": time.perf_counter() - t}
            rows.append(line)
            f.write(json.dumps(line) + "\n")
            f.flush()
            print(json.dumps(line), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    names = sorted({k for r in rows for k in r["readings"]})
    for variant in dict.fromkeys(r["variant"] for r in rows):
        vals = {k: [r["readings"].get(k) for r in rows if r["variant"] == variant]
                for k in names}
        agg = max if variant == "program" else min
        print(variant, {k: agg(v for v in vs if v is not None)
                        for k, vs in vals.items() if any(v is not None for v in vs)},
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
