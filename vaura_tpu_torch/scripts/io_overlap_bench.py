"""Loader -> device overlap of flagship training fed from MP4s.

Counterpart of ``scripts/io_overlap_bench.py``. Synthesizes real MP4s
(native libav mux), feeds flagship training (B=12, remat; features in, the
audio through the frozen DAC encoder) from the native-decode
``VggSoundDataset`` and the threaded ``DataLoader``, and compares:

  * sync     — ``batch_to_device`` on the critical path
  * prefetch — ``prefetch_to_device(size=2)``, the ``Trainer``'s prefetch
               (``train/loop.py``, ``prefetch_batches=2``): the copy of
               batch N+1 is issued before step N's result is read

Also reports the synthetic-batch (no I/O) step time as the floor. Prints
the JAX tool's JSON keys, and ``device`` (the card's name and power limit,
or ``cpu``).

Runs on the card unless ``--device cpu``; ``--tiny`` is the 2 layers x 192
logic smoke. The MP4s are written and decoded by the native media library
(libav). The card's machine has none: there the script raises
``MediaError`` at its first MP4 and does not fall back to synthetic frames,
which would measure a loader that does no decoding.

Usage::

    python -m vaura_tpu_torch.scripts.io_overlap_bench [--steps 12]
        [--batch 12] [--clips 24] [--workers 4] [--device cpu] [--tiny]
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

AUDIO_SAMPLES = 112896  # 2.56 s at 44.1 kHz, a whole number of codec hops


def _make_dataset(root: Path, n_clips: int, hw: int = 224):
    import csv

    from vaura_tpu_torch.data import media

    data_dir = root / "videos"
    data_dir.mkdir()
    sr = 44100
    rng = np.random.default_rng(0)
    names = [f"vid{i}_0_10000" for i in range(n_clips)]
    for name in names:
        n = 72  # 2.88 s at 25 fps (headroom: fps-resampled decode may
        # return a few frames fewer than nominal)
        frames = rng.integers(0, 255, size=(n, hw, hw, 3), dtype=np.uint8)
        audio = (rng.standard_normal(int(2.88 * sr)) * 0.1).astype(np.float32)
        media.write_video(data_dir / f"{name}.mp4", frames, fps=25.0,
                          audio=audio, audio_sample_rate=sr)
    split_dir = root / "splits" / "vggsound"
    split_dir.mkdir(parents=True)
    (split_dir / "vggsound_train.txt").write_text("\n".join(names) + "\n")
    meta = root / "meta.csv"
    with open(meta, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "start", "label"])
        for name in names:
            w.writerow([name.rsplit("_", 2)[0], 0, "class_0"])

    from vaura_tpu_torch.data.vggsound import VggSoundDataset

    return VggSoundDataset(
        split="train",
        split_dir_path=split_dir,
        data_path=data_dir,
        meta_path=meta,
        video_length=2.56,
        sample_rate_audio=sr,
        sample_rate_video=25.0,
        frames_per_clip=16,
        num_clips=4,
        run_additional_checks=False,
        seed=0,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--clips", type=int, default=24)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true",
                    help="2L x 192d logic smoke (CPU)")
    args = ap.parse_args(argv)

    from vaura_tpu_torch.bench import device_label
    from vaura_tpu_torch.data.core import DataLoader
    from vaura_tpu_torch.flagship import flagship_system
    from vaura_tpu_torch.train.state import TrainState, make_optimizer
    from vaura_tpu_torch.train.steps import (
        batch_to_device,
        make_train_step,
        prefetch_to_device,
        split_params,
    )
    from vaura_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    overrides = {"remat": True}
    if args.tiny:
        overrides.update(num_layers=2, d_model=192, nhead=4)
    system = flagship_system(
        device, torch.Generator(device).manual_seed(0), training=True,
        encoder=False, sampler_overrides=overrides)
    trainable, _ = split_params(system)  # the sampler; the codec is frozen
    holder = {"state": TrainState.create(trainable, make_optimizer(1e-4))}
    step = make_train_step(system)
    cond_dim = system.sampler_config.cond_in_dim
    rngv = np.random.default_rng(1)

    def to_train_batch(batch):
        # frames decoded but unused (encoder frozen and benched separately);
        # audio drives the real on-the-fly DAC encode path
        audio = np.asarray(batch["audio"], np.float32)
        if audio.ndim == 4:
            audio = audio.transpose(0, 2, 1, 3).reshape(audio.shape[0], 1, -1)
        return {
            "audio": audio[:, :, :AUDIO_SAMPLES],
            "vis_feats": rngv.standard_normal(
                (audio.shape[0], 32, cond_dim)).astype(np.float32),
        }

    def run_step(batch, seed):
        holder["state"], metrics = step(
            holder["state"], batch,
            torch.Generator(device).manual_seed(seed))
        return metrics["loss"]

    with tempfile.TemporaryDirectory() as td:
        ds = _make_dataset(Path(td), args.clips)
        loader = DataLoader(
            ds, args.batch, shuffle=True, seed=0, num_workers=args.workers,
            drop_last=True,
        )

        # warm-up (the kernels build) + synthetic floor
        synth = batch_to_device(to_train_batch({
            "audio": np.random.default_rng(2).standard_normal(
                (args.batch, 1, AUDIO_SAMPLES)).astype(np.float32) * 0.1,
        }), device)
        float(run_step(synth, 1))
        t0 = time.perf_counter()
        for i in range(4):
            loss = run_step(synth, 2 + i)
        float(loss)
        floor_ms = (time.perf_counter() - t0) / 4 * 1e3

        def run_epochs(mode: str) -> float:
            done = 0
            t0 = None
            epoch = 0
            while done < args.steps:
                loader.set_epoch(epoch)
                it = map(to_train_batch, iter(loader))
                if mode == "prefetch":
                    it = prefetch_to_device(it, size=2, device=device)
                else:
                    it = (batch_to_device(b, device) for b in it)
                for batch in it:
                    loss = run_step(batch, 10 + done)
                    if t0 is None:  # skip first (buffer fill)
                        float(loss)
                        t0 = time.perf_counter()
                        continue
                    done += 1
                    if done >= args.steps:
                        break
                epoch += 1
            float(loss)
            return (time.perf_counter() - t0) / args.steps * 1e3

        sync_ms = run_epochs("sync")
        prefetch_ms = run_epochs("prefetch")

    result = {
        "synthetic_floor_ms_per_step": round(floor_ms, 1),
        "real_loader_sync_ms_per_step": round(sync_ms, 1),
        "real_loader_prefetch_ms_per_step": round(prefetch_ms, 1),
        "overlap_gain_pct": round((sync_ms - prefetch_ms) / sync_ms * 100, 1),
        "batch": args.batch, "workers": args.workers,
        "device": device_label(device),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
