"""Experiment directory layout + checkpoint resolution.

The functions of ``vaura_tpu/utils/experiment.py`` that the generate action,
the server and the checkpoint manager use: an experiment directory holds
``checkpoints/`` and an ``<experiment_name>/hparams.yaml`` snapshot; a
checkpoint is named by its epoch, step and val-loss, and the best one is
picked by the val-loss in its name (``utils/utils.py:30-45`` of the
reference). ``save_hparams`` writes JSON text, which YAML readers read.
``init_log_directory`` makes a run directory of the train and test actions:
``<log_dir>/<YY-MM-DDTHH-MM-SS>/`` holding ``checkpoints/`` and
``<experiment_name>/``.
"""

from __future__ import annotations

import random
import re
import time
from datetime import datetime
from pathlib import Path
from typing import Optional

from vaura_tpu_torch.config.yaml_subset import dump, load_file

# the whole val loss: the JAX package's pattern (``[0-9.]+?`` before an
# optional dot) reads only its integer part, so checkpoints of 6.930 and
# 6.931 tie there and the first listed wins
CKPT_NAME_RE = re.compile(
    r"epoch=(?P<epoch>\d+)-step=(?P<step>\d+)-val_loss=(?P<val>\d+(?:\.\d+)?)"
)


def timestamp_dirname(jitter: bool = True) -> str:
    """YY-MM-DDTHH-MM-SS with a small collision-avoiding jitter
    (reference ``train_utils.py:113-116``)."""
    if jitter:
        time.sleep(random.random() * 2)
    return datetime.now().strftime("%y-%m-%dT%H-%M-%S")


def init_log_directory(
    log_dir: str | Path, experiment_name: str, run_name: Optional[str] = None
) -> dict:
    """Create ``<log_dir>/<run_name>/{checkpoints,<experiment_name>}``
    (``run_name`` from ``timestamp_dirname()`` unless given) and return
    ``{"root", "checkpoints", "experiment", "run_name"}``."""
    run_name = run_name or timestamp_dirname()
    root = Path(log_dir) / run_name
    ckpt_dir = root / "checkpoints"
    exp_dir = root / experiment_name
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    exp_dir.mkdir(parents=True, exist_ok=True)
    return {
        "root": root,
        "checkpoints": ckpt_dir,
        "experiment": exp_dir,
        "run_name": run_name,
    }


def save_hparams(exp_dir: str | Path, cfg: dict) -> Path:
    """Snapshot the resolved config next to the run (the reference saves
    Lightning hparams.yaml, ``vaura_model.py:50``)."""
    path = Path(exp_dir) / "hparams.yaml"
    path.write_text(dump(cfg), encoding="utf-8")
    return path


def load_hparams(path: str | Path) -> dict:
    return load_file(path)


def checkpoint_name(epoch: int, step: int, val_loss: float) -> str:
    return f"epoch={epoch}-step={step}-val_loss={val_loss:.3f}"


def resolve_best_checkpoint(ckpt_dir: str | Path) -> Optional[Path]:
    """Pick the checkpoint with the lowest val_loss encoded in its name
    (reference ``utils/utils.py:30-45``); falls back to ``last``."""
    ckpt_dir = Path(ckpt_dir)
    best, best_val = None, float("inf")
    for p in ckpt_dir.iterdir() if ckpt_dir.exists() else []:
        m = CKPT_NAME_RE.search(p.name)
        if m:
            val = float(m.group("val"))
            if val < best_val:
                best, best_val = p, val
    if best is None:
        last = ckpt_dir / "last"
        if last.exists():
            return last
    return best


def resolve_experiment_paths(experiment_path: str | Path) -> dict:
    """Locate checkpoints dir + hparams.yaml under an experiment dir
    (reference ``scripts/generate.py:43-128``)."""
    root = Path(experiment_path)
    ckpt_dir = root / "checkpoints"
    hparams = None
    for cand in sorted(root.glob("*/hparams.yaml")):
        hparams = cand
        break
    if (root / "hparams.yaml").exists():
        hparams = root / "hparams.yaml"
    return {"root": root, "checkpoints": ckpt_dir, "hparams": hparams}
