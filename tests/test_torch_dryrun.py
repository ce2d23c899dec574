"""``vaura_tpu_torch.dryrun.dryrun_multichip(8)``: the mid-size system of
``__graft_entry__.py`` takes one sharded training step and generates 24
tokens down to audio in 8 gloo processes on the CPU, at JAX's factoring of
8 ranks (2 x 2 x 2). Held against JAX's record ``MULTICHIP_r05.json``: the
mesh, the shapes of the codes and the audio, and the first loss within 0.05
of ln(1025) (the zero-initialised LM head: uniform logits)."""

import json
import math
from pathlib import Path

import torch

from vaura_tpu_torch.dryrun import dryrun_multichip, factor

REPO = Path(__file__).resolve().parents[1]


def test_factoring_is_jaxs():
    assert factor(8) == (2, 2, 2)
    assert factor(4) == (1, 2, 2)
    assert factor(2) == (1, 2, 1)
    assert factor(1) == (1, 1, 1)


def test_dryrun_multichip_8_matches_the_jax_record():
    record = json.loads((REPO / "MULTICHIP_r05.json").read_text())
    assert "mesh={'data': 2, 'fsdp': 2, 'model': 2}" in record["tail"]
    r = dryrun_multichip(8, timeout=170)
    assert tuple(r["mesh"]) == (2, 2, 2)
    assert abs(r["loss"] - math.log(1025)) < 0.05
    assert "loss=6.9315" in record["tail"] and abs(r["loss"] - 6.9315) < 1e-3
    assert tuple(r["codes"].shape) == (4, 9, 24)
    assert tuple(r["audio"].shape) == (4, 1, 12288)
    assert "codes (4, 9, 24), audio (4, 1, 12288)" in record["tail"]
    assert int(r["codes"].min()) >= 0 and int(r["codes"].max()) <= 1024
    assert bool(torch.isfinite(r["audio"]).all())
    assert round(r["trainable_params"] / 1e6, 1) == 18.5
