"""Precompute the DAC codec tokens of a dataset split (one offline pass).

Counterpart of ``scripts/precompute_codes.py``. The codec is frozen, yet a
training step that takes audio encodes it again every step. This tool runs
the DAC encoder on the card over a datamodule split once and writes
``<clip stem>.codes.npy`` (``[K, T]`` int16) next to each clip (or into
``--out``); a dataset pointed at them with ``codes_dir`` hands training the
``codes`` batch key (``train_forward(codes=...)``). Where the dataset draws
crops from a seed (``video_len``), a manifest ``codes_meta.<split>.json``
records what the codes are aligned with, which the dataset verifies when it
loads them::

    python -m vaura_tpu_torch.scripts.precompute_codes CONFIG.yaml \\
        --split train [--out codes_dir] [--batch 64] [--platform cpu]

Runs on CUDA unless ``--platform cpu``; without CUDA it raises.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


def codes_manifest(dataset, split: str) -> Optional[str]:
    """The manifest of a dataset whose crops depend on its seed and video
    length (one that has ``video_len``), else None."""
    if dataset is None or not hasattr(dataset, "video_len"):
        return None
    return json.dumps({
        "seed": int(getattr(dataset, "seed", 0)),
        "video_len": float(dataset.video_len),
        "split": split,
        "deterministic_train_crops": bool(
            getattr(dataset, "deterministic_train_crops", False)),
    })


@torch.no_grad()
def encode_split(system, loader, out: Optional[Path], *,
                 limit: Optional[int] = None) -> tuple:
    """Encode every batch of ``loader`` with ``system.encode_audio`` and
    write each clip's codes as ``<stem>.codes.npy`` into ``out`` (or beside
    the clip), stopping after the batch that reaches ``limit`` clips.
    Clip-partitioned audio ``[B, n, 1, T]`` is encoded as ``[B, 1, n*T]``.
    Returns ``(files written, the directories written to)``."""
    out_dirs = set()
    n = 0
    for batch in loader:
        audio = np.asarray(batch["audio"], np.float32)
        if audio.ndim == 4:  # clip-partitioned [B, n, 1, T] -> [B, 1, n*T]
            audio = audio.transpose(0, 2, 1, 3).reshape(audio.shape[0], 1, -1)
        codes = system.encode_audio(torch.from_numpy(audio))
        codes = codes.cpu().numpy().astype(np.int16)  # [B, K, T]
        for i, fp in enumerate(batch["meta"]["filepath"]):
            out_dir = out or Path(fp).parent
            np.save(out_dir / f"{Path(fp).stem}.codes.npy", codes[i])
            out_dirs.add(out_dir)
            n += 1
        if limit is not None and n >= limit:
            break
    return n, out_dirs


def main(argv=None) -> tuple:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config", type=Path)
    ap.add_argument("--split", default="train",
                    choices=["train", "validation", "test"])
    ap.add_argument("--out", type=Path, default=None,
                    help="output dir (default: alongside each clip)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--platform", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--limit", type=int, default=None)
    args = ap.parse_args(argv)

    from vaura_tpu_torch.data import get_datamodule_from_type
    from vaura_tpu_torch.main import get_config
    from vaura_tpu_torch.models.factory import build_system, maybe_load_pretrained
    from vaura_tpu_torch.utils import resolve_device, seeded_init_

    device = resolve_device("cpu" if args.platform == "cpu" else None)
    cfg = get_config([f"config={args.config}"])
    dl_cfg = dict(cfg["dataloader"])
    dl_cfg["batch_size"] = args.batch
    # the codes are being made: the dataset must neither filter on nor load
    # codes that do not exist yet
    dl_cfg.pop("codes_dir", None)
    if args.split == "train":
        # train crops are drawn anew every epoch; codes of one draw would not
        # match later epochs' frames and audio. Training with codes_dir sets
        # the same flag (the dataset enforces it).
        dl_cfg["deterministic_train_crops"] = True
        logger.info("train split: forcing deterministic_train_crops=true so "
                    "the precomputed codes align with training crops")
    system = build_system(cfg["model"], device=device)
    seeded_init_(system, torch.Generator(device=device).manual_seed(0))
    maybe_load_pretrained(system, cfg["model"])

    datamodule = get_datamodule_from_type(dl_cfg["dataset_type"], dl_cfg)
    datamodule.setup(args.split)
    loader = {
        "train": datamodule.train_dataloader,
        "validation": datamodule.val_dataloader,
        "test": datamodule.test_dataloader,
    }[args.split]()
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
    manifest = codes_manifest(
        getattr(datamodule, "datasets", {}).get(args.split), args.split)
    n, out_dirs = encode_split(system, loader, args.out, limit=args.limit)
    if manifest is not None:
        for d in out_dirs:
            (d / f"codes_meta.{args.split}.json").write_text(
                manifest, encoding="utf-8")
    logger.info("wrote %d code files (+%d manifests)", n,
                len(out_dirs) if manifest else 0)
    return n, out_dirs


if __name__ == "__main__":
    main()
