"""Client for the port's generation server (``vaura_tpu_torch/scripts/serve.py``,
``python -m vaura_tpu_torch config=... action=serve``).

Counterpart of ``scripts/client.py``, function for function; the wire format
is the JAX package's, so either client drives either server. Library
functions (standard library and numpy only) plus a CLI::

    # short clip: features [Tv, cond_dim] .npy -> WAV
    python -m vaura_tpu_torch.scripts.client feats.npy --out out.wav

    # short clip from a video file (server runs the visual encoder)
    python -m vaura_tpu_torch.scripts.client clip.mp4 --out out.wav

    # token output instead of audio
    python -m vaura_tpu_torch.scripts.client feats.npy --codes --out codes.npy

    # long-horizon STREAMING: per-segment features [S, t, cond_dim];
    # WAV bytes are written to --out as chunks arrive (first-sound
    # latency is printed)
    python -m vaura_tpu_torch.scripts.client segments.npy --long --out out.wav

    # hot-swap the server's weights (path as seen by the server)
    python -m vaura_tpu_torch.scripts.client --reload /ckpts/e3-s1000-0.512

    # burst load test: 256 requests, 64 in flight
    python -m vaura_tpu_torch.scripts.client feats.npy --loadtest 256
"""

from __future__ import annotations

import base64
import io
import json
import time
import urllib.request
from typing import Iterator

import numpy as np


def _npy_request(url: str, arr: np.ndarray) -> urllib.request.Request:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr, np.float32))
    return urllib.request.Request(
        url, data=buf.getvalue(),
        headers={"Content-Type": "application/octet-stream"},
    )


def health(base_url: str, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(base_url + "/healthz", timeout=timeout) as r:
        return json.load(r)


def generate(
    base_url: str,
    features: np.ndarray,
    *,
    want: str = "audio",
    timeout: float = 600.0,
) -> bytes | np.ndarray:
    """``features``: [Tv, cond_dim]. Returns WAV bytes (``want='audio'``)
    or an int code array [K, S] (``want='codes'``)."""
    path = "/generate" + ("?raw=codes" if want == "codes" else "")
    req = _npy_request(base_url + path, features)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = r.read()
    if want == "codes":
        return np.asarray(json.loads(body)["codes"])
    return body


def generate_from_video(
    base_url: str, video_bytes: bytes, *, timeout: float = 600.0
) -> bytes:
    """mp4 bytes -> WAV bytes (the server runs the visual encoder)."""
    req = urllib.request.Request(
        base_url + "/generate",
        data=json.dumps(
            {"video_b64": base64.b64encode(video_bytes).decode()}
        ).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def reload_weights(
    base_url: str, ckpt_path: str | None = None, *, timeout: float = 600.0
) -> dict:
    """Hot-swap the server's weights (POST /reload). ``ckpt_path`` is a
    path visible to the SERVER; None re-loads its startup checkpoint."""
    body: dict = {}
    if ckpt_path:
        body["ckpt_path"] = str(ckpt_path)
    req = urllib.request.Request(
        base_url + "/reload", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def generate_long_stream(
    base_url: str,
    features_segments: np.ndarray,
    *,
    timeout: float = 3600.0,
) -> Iterator[bytes]:
    """``features_segments``: [S_total, t, cond_dim]. Yields the raw WAV
    byte stream as it arrives: first the 44-byte RIFF header, then PCM
    increments per decoded chunk (close-delimited; concatenate everything
    for a playable unknown-length WAV)."""
    req = _npy_request(base_url + "/generate_long", features_segments)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        while True:
            chunk = r.read1(1 << 16)
            if not chunk:
                return
            yield chunk


def loadtest(
    base_url: str,
    features: np.ndarray,
    *,
    n_requests: int = 256,
    concurrency: int = 64,
    want: str = "audio",
) -> dict:
    """Burst load test: keep ``concurrency`` requests in flight until
    ``n_requests`` have completed; returns throughput + latency
    percentiles (p50/p95 under a 256-request burst is the serving bar;
    ``scripts/burst_bench.py`` runs it against a server it starts)."""
    import threading

    latencies: list = []
    errors = [0]
    lock = threading.Lock()
    idx = [0]
    t_start = time.time()

    def worker():
        while True:
            with lock:
                if idx[0] >= n_requests:
                    return
                idx[0] += 1
            t0 = time.time()
            try:
                generate(base_url, features, want=want)
                dt = time.time() - t0
                with lock:
                    latencies.append(dt)
            except Exception:
                with lock:
                    errors[0] += 1

    threads = [
        threading.Thread(target=worker) for _ in range(concurrency)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.time() - t_start
    lat = np.sort(np.asarray(latencies)) if latencies else np.zeros(1)

    def pct(p: float) -> float:
        return float(lat[min(len(lat) - 1, int(p * len(lat)))])

    return {
        "requests": len(latencies),
        "errors": errors[0],
        "wall_s": round(wall, 2),
        "req_per_s": round(len(latencies) / wall, 2),
        "p50_s": round(pct(0.50), 2),
        "p90_s": round(pct(0.90), 2),
        "p95_s": round(pct(0.95), 2),
        "p99_s": round(pct(0.99), 2),
        "mean_s": round(float(lat.mean()), 2),
    }


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", nargs="?", help=".npy features ([Tv, D] "
                    "short / [S, t, D] --long) or a video file")
    ap.add_argument("--url", default="http://127.0.0.1:8800")
    ap.add_argument("--out", help="output path (required unless --reload)")
    ap.add_argument("--codes", action="store_true",
                    help="fetch token codes (.npy out) instead of audio")
    ap.add_argument("--long", action="store_true",
                    help="streaming long-horizon generation")
    ap.add_argument("--reload", nargs="?", const="", default=None,
                    metavar="CKPT",
                    help="hot-swap the server's weights from CKPT (server-"
                    "visible path; omit the value to re-load its startup "
                    "checkpoint), then exit")
    ap.add_argument("--loadtest", type=int, default=0, metavar="N",
                    help="burst load test: N total requests of the input "
                    "features; prints req/s + latency percentiles JSON")
    ap.add_argument("--concurrency", type=int, default=64,
                    help="in-flight requests during --loadtest")
    args = ap.parse_args()

    t0 = time.time()
    if args.reload is not None:
        print(json.dumps(reload_weights(args.url, args.reload or None)))
        return
    if args.loadtest:
        if not args.input:
            ap.error("input features .npy required for --loadtest")
        stats = loadtest(
            args.url, np.load(args.input),
            n_requests=args.loadtest, concurrency=args.concurrency,
            want="codes" if args.codes else "audio",
        )
        print(json.dumps(stats))
        return
    if not args.input or not args.out:
        ap.error("input and --out are required unless --reload")
    if args.long:
        first = None
        n = 0
        with open(args.out, "wb") as f:
            for chunk in generate_long_stream(
                args.url, np.load(args.input)
            ):
                if first is None:
                    first = time.time() - t0
                f.write(chunk)
                f.flush()
                n += len(chunk)
        print(f"first bytes at {first:.2f}s; {n} bytes total "
              f"({time.time() - t0:.2f}s) -> {args.out}")
    elif args.input.endswith(".npy"):
        if args.codes:
            codes = generate(args.url, np.load(args.input), want="codes")
            np.save(args.out, codes)
            print(f"codes {codes.shape} ({time.time() - t0:.2f}s) "
                  f"-> {args.out}")
        else:
            wav = generate(args.url, np.load(args.input))
            with open(args.out, "wb") as f:
                f.write(wav)
            print(f"{len(wav)} WAV bytes ({time.time() - t0:.2f}s) "
                  f"-> {args.out}")
    else:
        with open(args.input, "rb") as f:
            wav = generate_from_video(args.url, f.read())
        with open(args.out, "wb") as f:
            f.write(wav)
        print(f"{len(wav)} WAV bytes ({time.time() - t0:.2f}s) "
              f"-> {args.out}")


if __name__ == "__main__":
    main()
