"""Dataset re-encoder CLI: re-encode a directory of videos to the V-AURA
media contract (25 fps, min-side 256, h264 crf10 yuv420p, 44.1 kHz mono
aac) with the native libav module (no ffmpeg subprocess) and a process pool.

Counterpart of ``scripts/reencode_videos.py`` (reference
``scripts/reencode_videos.py``), over ``vaura_tpu_torch/data/media.py``: the
same arguments, defaults and outputs; a host tool that touches no device. It
needs the native media library (libav), which the card's machine lacks:
there every file fails with ``MediaError``, logged as the JAX tool logs it.

Usage::

    python -m vaura_tpu_torch.scripts.reencode_videos IN_DIR OUT_DIR
        [--fps 25] [--min-side 256] [--crf 10] [--sample-rate 44100]
        [--workers 32] [--glob '*.mp4']
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing as mp
from functools import partial
from pathlib import Path

logger = logging.getLogger(__name__)


def reencode_one(src: Path, out_dir: Path, fps: float, min_side: int, crf: int,
                 sample_rate: int) -> bool:
    from vaura_tpu_torch.data import media

    dst = out_dir / src.name
    try:
        media.reencode(
            src, dst, fps=fps, min_side=min_side, crf=crf, sample_rate=sample_rate
        )
        return True
    except Exception as e:
        logger.error("failed to re-encode %s: %s", src, e)
        return False


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input_dir", type=Path)
    ap.add_argument("output_dir", type=Path)
    ap.add_argument("--fps", type=float, default=25.0)
    ap.add_argument("--min-side", type=int, default=256)
    ap.add_argument("--crf", type=int, default=10)
    ap.add_argument("--sample-rate", type=int, default=44100)
    ap.add_argument("--workers", type=int, default=32)
    ap.add_argument("--glob", default="*.mp4")
    args = ap.parse_args(argv)

    args.output_dir.mkdir(parents=True, exist_ok=True)
    files = sorted(args.input_dir.glob(args.glob))
    fn = partial(
        reencode_one,
        out_dir=args.output_dir,
        fps=args.fps,
        min_side=args.min_side,
        crf=args.crf,
        sample_rate=args.sample_rate,
    )
    workers = min(args.workers, max(mp.cpu_count(), 1))
    if workers > 1:
        with mp.Pool(workers) as pool:
            results = pool.map(fn, files)
    else:
        results = [fn(f) for f in files]
    logger.info("re-encoded %d/%d files", sum(results), len(files))


if __name__ == "__main__":
    main()
