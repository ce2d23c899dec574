"""Serving burst benchmark: one command starts the port's server, bursts it
and stops it.

Counterpart of ``scripts/burst_bench.py``. Starts the port's server
(``python -m vaura_tpu_torch config=... action=serve``) as a subprocess, the
only process that touches the card, waits for ``/healthz``, sends one
warm-up request, runs the client's burst load test against it
(``vaura_tpu_torch.scripts.client.loadtest``), prints ONE JSON line with
the p50/p95/req-s table and the card's name and power limit, and stops the
server with SIGINT (it drains and exits). The serving bar: p95 <= 2x p50
under a 256-request burst at B=32 bf16::

    python -m vaura_tpu_torch.scripts.burst_bench --config \\
        configs/generate_vgg.yaml --batch 32 --requests 256 \\
        --concurrency 64 [--quantize cache] [--extra trainer.platform=cpu]

The client side is plain HTTP: features are random ``[tv, cond_dim]`` read
off the server's own ``/healthz`` contract, so no dataset is needed. The
server's log goes to ``burst_serve_<port>.log`` in the temporary directory
(``$TMPDIR``, else ``/tmp``).
"""

from __future__ import annotations

import argparse
import json
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from vaura_tpu_torch.scripts.client import generate, health, loadtest

REPO_ROOT = Path(__file__).resolve().parents[2]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--port", type=int, default=8807)
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--concurrency", type=int, default=64)
    ap.add_argument("--quantize", default=None,
                    help="serve quantize mode (e.g. 'cache'); default bf16")
    ap.add_argument("--duration", type=float, default=2.56)
    ap.add_argument("--warmup-timeout", type=float, default=2400.0,
                    help="seconds to wait for the server to come up")
    ap.add_argument("--extra", nargs="*", default=[],
                    help="extra key=value overrides of the serve action")
    return ap


def server_command(args) -> list:
    """The command line that starts the port's server."""
    return [
        sys.executable, "-m", "vaura_tpu_torch",
        f"config={args.config}", "action=serve",
        f"port={args.port}", f"batch={args.batch}",
        f"duration={args.duration}",
        "quantize=" + (args.quantize or "false"),
        *args.extra,
    ]


def device_label(info: dict) -> str:
    """What the server runs on (its ``/healthz`` ``device``): the card's
    name and power limit as nvidia-smi prints them, or ``"cpu"``."""
    if info.get("device") != "cuda":
        return "cpu"
    from vaura_tpu_torch.profile_generate import nvidia_smi

    return nvidia_smi().splitlines()[0]


def measure(url: str, args, t_health: float = 0.0) -> dict:
    """Against a healthy server at ``url``: one warm-up request (the first
    batch may still pay for a build or a cache fill), then the burst of
    ``args.requests`` at ``args.concurrency``. Returns the JSON line's
    fields: ``mode, batch, requests, concurrency, health_after_s,
    first_request_s, audio_sec_per_s``, the load test's keys and
    ``device``."""
    info = health(url, timeout=5.0)
    tv = int(info.get("max_feature_rows", 32))
    cond_dim = int(info.get("cond_dim", 768))
    feats = np.random.default_rng(0).standard_normal(
        (tv, cond_dim)).astype(np.float32)
    t0 = time.time()
    generate(url, feats, timeout=1800.0)
    t_warm = time.time() - t0

    stats = loadtest(url, feats, n_requests=args.requests,
                     concurrency=args.concurrency)
    dur = float(info.get("duration_s", args.duration))
    return {
        "mode": args.quantize or "bf16",
        "batch": args.batch,
        "requests": args.requests,
        "concurrency": args.concurrency,
        "health_after_s": round(t_health, 1),
        "first_request_s": round(t_warm, 2),
        "audio_sec_per_s": round(stats["req_per_s"] * dur, 2),
        **stats,
        "device": device_label(info),
    }


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    url = f"http://127.0.0.1:{args.port}"
    cmd = server_command(args)
    print("launching:", " ".join(cmd), file=sys.stderr, flush=True)
    log_path = Path(tempfile.gettempdir()) / f"burst_serve_{args.port}.log"
    with open(log_path, "wb") as log:
        srv = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                               cwd=REPO_ROOT)
        try:
            t0 = time.time()
            up = False
            while time.time() - t0 < args.warmup_timeout:
                if srv.poll() is not None:
                    raise RuntimeError(
                        f"server exited rc={srv.returncode}; see {log_path}")
                try:
                    health(url, timeout=5.0)
                    up = True
                    break
                except OSError:
                    time.sleep(1.0)
            if not up:
                raise RuntimeError(f"server not healthy after "
                                   f"{args.warmup_timeout:.0f}s; see {log_path}")
            out = measure(url, args, time.time() - t0)
            print(json.dumps(out), flush=True)
            return out
        finally:
            if srv.poll() is None:
                srv.send_signal(signal.SIGINT)
                try:
                    srv.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    srv.kill()
                    srv.wait()


if __name__ == "__main__":
    main()
