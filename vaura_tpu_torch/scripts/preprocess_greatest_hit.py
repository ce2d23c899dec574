"""Greatest Hits preprocessor: cut the long source videos into short clips
around annotated hit times.

Counterpart of ``scripts/preprocess_greatest_hit.py`` (reference
``scripts/preprocess_greatest_hit.py``), over
``vaura_tpu_torch/data/media.py``: the same tactics, arguments, defaults and
file names; a host tool that touches no device. It needs the native media
library (libav), which the card's machine lacks: there the first probe
raises ``MediaError``.

Tactics (reference ``:25``):
  * ``annotations`` — one clip per annotated hit time (centered on it)
  * ``random``      — N random clips per video
  * ``dummy``       — uniformly spaced clips

Annotations are the dataset's ``*_times.txt`` files (``<time> <material>
<motion>`` per line). Output clips are re-encoded to the V-AURA media
contract.

Usage::

    python -m vaura_tpu_torch.scripts.preprocess_greatest_hit IN_DIR OUT_DIR
        [--tactic annotations|random|dummy] [--clip-duration 2.56]
        [--clips-per-video 10] [--fps 25] [--min-side 256]
        [--sample-rate 44100] [--seed 666]
"""

from __future__ import annotations

import argparse
import logging
import random
from pathlib import Path

logger = logging.getLogger(__name__)


def read_hit_times(times_file: Path):
    hits = []
    with open(times_file, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            try:
                t = float(parts[0])
            except ValueError:
                continue
            material = parts[1] if len(parts) > 1 else "unknown"
            motion = parts[2] if len(parts) > 2 else "unknown"
            hits.append((t, material, motion))
    return hits


def cut_clip(src: Path, dst: Path, start: float, duration: float,
             fps: float, min_side: int, sample_rate: int) -> None:
    from vaura_tpu_torch.data import media

    frames, audio, info = media.read_video(
        src, start=start, duration=duration, fps=fps,
        min_side=min_side, sample_rate=sample_rate,
    )
    if frames is None:
        raise RuntimeError(f"no video in {src}")
    media.write_video(
        dst, frames, fps=fps,
        audio=audio[0] if audio is not None else None,
        audio_sample_rate=sample_rate,
    )


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input_dir", type=Path, help="dir of *_denoised.mp4 + *_times.txt")
    ap.add_argument("output_dir", type=Path)
    ap.add_argument("--tactic", choices=["annotations", "random", "dummy"],
                    default="annotations")
    ap.add_argument("--clip-duration", type=float, default=2.56)
    ap.add_argument("--clips-per-video", type=int, default=10)
    ap.add_argument("--fps", type=float, default=25.0)
    ap.add_argument("--min-side", type=int, default=256)
    ap.add_argument("--sample-rate", type=int, default=44100)
    ap.add_argument("--seed", type=int, default=666)
    args = ap.parse_args(argv)

    random.seed(args.seed)
    args.output_dir.mkdir(parents=True, exist_ok=True)
    from vaura_tpu_torch.data import media

    n_clips = 0
    for video in sorted(args.input_dir.glob("*_denoised.mp4")):
        info = media.probe(video)
        duration = info["duration"]
        half = args.clip_duration / 2
        if args.tactic == "annotations":
            times_file = video.with_name(
                video.name.replace("_denoised.mp4", "_times.txt")
            )
            if not times_file.exists():
                logger.warning("no annotations for %s", video.name)
                continue
            starts = [
                (max(min(t - half, duration - args.clip_duration), 0.0), mat, mot)
                for t, mat, mot in read_hit_times(times_file)
                if t < duration
            ]
        elif args.tactic == "random":
            hi = max(duration - args.clip_duration, 0.0)
            starts = [
                (random.uniform(0, hi), "unknown", "unknown")
                for _ in range(args.clips_per_video)
            ]
        else:  # dummy: uniform spacing
            n = max(int(duration // args.clip_duration), 1)
            starts = [
                (i * args.clip_duration, "unknown", "unknown") for i in range(n)
            ]
        for i, (start, material, motion) in enumerate(starts):
            dst = args.output_dir / (
                f"{video.stem}_{i}_{material}_{motion}.mp4"
            )
            try:
                cut_clip(
                    video, dst, start, args.clip_duration,
                    args.fps, args.min_side, args.sample_rate,
                )
                n_clips += 1
            except Exception as e:
                logger.error("clip failed for %s @%.2fs: %s", video.name, start, e)
    logger.info("wrote %d clips", n_clips)


if __name__ == "__main__":
    main()
