"""The benchmark's files cut to a size the CPU runs in seconds, for the
tests. The cells' limits are kept as they are, but for the training
step's gradient and update gaps: at these widths bf16 rounding alone
reads a few 1e-3 (1e-4 at the cell's widths), so they take
``TINY_LIMITS``, which a planted fault still fails by far (half a batch
left out reads about 0.09)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
DATA = ("configs", "workloads", "traffic", "metrics")

TINY_SAMPLER = dict(num_layers=2, d_model=96, d_codebook=32, nhead=2,
                    num_codebooks=3, cond_in_dim=64, block_size_audio=64,
                    block_size_video=16)
TINY_ENCODER = dict(embed_dim=64, depth=1, num_heads=2, img_size=32,
                    temporal_resolution=2)
TINY_CODEC = dict(encoder_dim=4, decoder_dim=32, n_codebooks=3, codebook_size=32)
TINY_LIMITS = {"grad_norm_gap": 0.03, "update_norm_gap": 0.02}


def tiny_config(c: dict) -> dict:
    c = json.loads(json.dumps(c))
    c["sampler"].update(TINY_SAMPLER)
    c["encoder"].update(TINY_ENCODER)
    c["codec"].update(TINY_CODEC)
    c["pattern"] = {"n_q": TINY_SAMPLER["num_codebooks"]}
    if "generate" in c:
        c["generate"].update(max_new_tokens=12, top_k=8, tokens_per_frame=2)
    c["expect"] = {}
    return c


def tiny_mix(m: dict) -> dict:
    m = dict(m)
    if m["kind"] == "generate":
        m.update(batch=4, check_rows=2, dac_chunk=2, warmup_tokens=4)
        if m["input"] == "frames":
            m.update(frames=[2, 3, 4, 32, 32], encoder_chunk=2)
        else:
            m.update(feature_rows=6)
    else:
        m.update(batch=4, frames=[2, 3, 4, 32, 32], audio_samples=512 * 12 - 100,
                 codec_frames=12, block=2)
    return m


def make_tiny_tree(dst: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and the benchmark's data files under
    ``dst``, cut to the tiny sizes."""
    (dst / "port_bench").mkdir(parents=True)
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    for d in DATA:
        shutil.copytree(REPO / "port_bench" / d, dst / "port_bench" / d)
    for f in (dst / "port_bench" / "configs").glob("*.json"):
        f.write_text(json.dumps(tiny_config(json.loads(f.read_text()))))
    for f in (dst / "port_bench" / "workloads").glob("*.json"):
        w = json.loads(f.read_text())
        w["limits"].update({k: v for k, v in TINY_LIMITS.items()
                            if k in w["limits"]})
        f.write_text(json.dumps(w))
    for f in (dst / "port_bench" / "traffic").glob("*.json"):
        f.write_text(json.dumps(tiny_mix(json.loads(f.read_text()))))
    return dst


def cells() -> list:
    return [w["name"] for w in
            json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
