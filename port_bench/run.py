"""One run of one cell: parse the command line, find the cell's files by
name, check for the cards, run the cell's traffic kind, read its metrics,
and print the result line last on standard output with each compared
number beside its limit (also as the last lines of standard error).

Exit codes: 0 a result was printed; 2 a bad command line or a missing
file; 3 no card, or fewer than the cell asks for; 4 a module of JAX or of
the JAX package was loaded; 5 a metric read a number that is not finite,
or its reader found the record at fault. A metric whose reader finds
nothing to read is left out of the line and named on standard error.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

# top-level module names that the benchmark's process may never hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "vaura_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result; ``code`` is the exit code."""

    def __init__(self, msg: str, code: int):
        super().__init__(msg)
        self.code = code


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m port_bench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return ap.parse_args(argv)


def load_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise BenchError(f"missing {path}", 2) from None


def load_cell(root: Path, name: str) -> dict:
    """The cell's file with its configuration and traffic mix read in:
    ``{"name", "config", "traffic", "chips", "why", "limits",
    "config_data", "mix"}``."""
    data = root / "port_bench"
    cell = load_json(data / "workloads" / f"{name}.json")
    cell["name"] = name
    cell["config_data"] = load_json(data / "configs" / f"{cell['config']}.json")
    cell["mix"] = load_json(data / "traffic" / f"{cell['traffic']}.json")
    return cell


def cell_metrics(bench: dict, cell: str, trace: int) -> List[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones without a
    trace, the per-layer ones with one. A metric with a ``workloads`` list
    is reported in those cells; a per-layer metric without one wherever its
    ``moves`` is reported."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moves = {m["name"] for m in e2e}

    def reports(m):
        return (cell in m["workloads"]) if "workloads" in m else (
            m["moves"] in moves)

    return [m for m in bench["per_layer"] if reports(m)]


def load_reader(root: Path, name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, or, where that
    is missing, the reader that its kinds share, ``metrics/<the name up to
    its first dot>.py`` (``peak_mem_gib.py`` for ``peak_mem_gib.gen`` and
    ``peak_mem_gib.train``)."""
    metrics = root / "port_bench" / "metrics"
    path = metrics / f"{name}.py"
    if not path.exists():
        path = metrics / f"{name.split('.', 1)[0]}.py"
    if not path.exists():
        raise BenchError(f"no reader {metrics / name}.py for metric {name}", 2)
    spec = importlib.util.spec_from_file_location(
        "port_bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the modules
    loaded), compared whole (``vaura_tpu_torch`` is not ``vaura_tpu``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules if names is None
                                              else names)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its CUDA kernels into ``vaura_tpu_torch/_build/``)."""
    cache = root / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def device_info(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: int, *,
             t0: Optional[float] = None, device: Optional[str] = None,
             patch=None) -> dict:
    """Run cell ``name`` once and return ``{"result": the result line's
    dict, "checks": [(name, value, limit)], "record": the run's
    record}``. ``device`` other than None skips the look for cards (tests:
    ``"cpu"``); ``patch``, when given, plants a fault in the program after it
    is built (tests): the traffic kind's ``patch(system)`` (generation) or
    ``patch(system, step) -> step`` (training)."""
    t0 = time.perf_counter() if t0 is None else t0
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json")
    cell = load_cell(root, name)
    metrics = cell_metrics(bench, name, trace)
    readers = {m["name"]: load_reader(root, m["name"]) for m in metrics}
    set_cache_dirs(root)
    import torch

    chips = int(cell["chips"])
    if device is None:
        if not torch.cuda.is_available():
            raise BenchError("torch.cuda.is_available() is false", 3)
        if torch.cuda.device_count() < chips:
            raise BenchError(f"{torch.cuda.device_count()} cards, the cell "
                             f"asks for {chips}", 3)
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device(device)
    kind = importlib.import_module(f"port_bench.traffic.{cell['mix']['kind']}")
    record = kind.run(cell, seed=seed, seconds=seconds, trace=bool(trace),
                      device=dev, t0=t0, patch=patch)
    found = forbidden_modules()
    if found:
        raise BenchError("modules of JAX or of the JAX package were loaded: "
                         + ", ".join(found), 4)
    values = {}
    for m in metrics:
        try:
            v = readers[m["name"]](record)
        except (ValueError, ZeroDivisionError) as e:
            raise BenchError(f"metric {m['name']}: {e}", 5) from None
        if v is None:  # left out of the line, and named
            print(f"port_bench: metric {m['name']} found nothing to read",
                  file=sys.stderr)
            continue
        if not math.isfinite(v):
            raise BenchError(f"metric {m['name']} read {v}", 5)
        values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks = record["checks"]
    device_out = record.get("device") or {}
    device_out = {**device_info(dev, chips), **device_out}
    result = {"correct": bool(record["correct"]),
              "attempted": int(record["attempted"]),
              "failed": int(record["failed"]),
              "metrics": values, "device": device_out}
    if trace and record.get("breakdown"):
        result["breakdown"] = record["breakdown"]
    result["checks"] = {c: {"value": v, "limit": lim} for c, v, lim in checks}
    return {"result": result, "checks": checks, "record": record}


def main(argv: List[str], t0: Optional[float] = None) -> int:
    args = parse(argv)
    try:
        out = run_cell(Path.cwd(), args.workload, args.seed, args.seconds,
                       args.trace, t0=t0)
    except BenchError as e:
        print(f"port_bench: {e}", file=sys.stderr, flush=True)
        return e.code
    calls = out["record"]["calls"]
    print(f"window: {len(calls)} calls or steps of "
          + " ".join(f"{c['t1'] - c['t0']:.3f}" for c in calls) + " s",
          file=sys.stderr)
    compared = {c[0] for c in out["checks"]}
    for name, value in sorted(out["record"]["readings"].items()):
        if name not in compared:
            print(f"reading {name}: {value!r} (not compared)", file=sys.stderr)
    for name, value, limit in out["checks"]:
        ok = "ok" if value <= limit else "FAILED"
        print(f"check {name}: {value!r} limit {limit!r} {ok}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0
