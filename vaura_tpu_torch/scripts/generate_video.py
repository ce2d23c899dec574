"""A+V muxer CLI: merge generated WAVs back onto their source videos with
the native libav muxer.

Counterpart of ``scripts/generate_video.py`` (reference
``scripts/generate_video.py``), over ``vaura_tpu_torch/data/media.py``: the
same arguments and outputs; a host tool that touches no device. It needs
the native media library (libav), which the card's machine lacks: there the
first mux raises ``MediaError``, logged per clip as the JAX tool logs it.

Usage::

    python -m vaura_tpu_torch.scripts.generate_video VIDEO_DIR AUDIO_DIR OUT_DIR [--crf 10]
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

logger = logging.getLogger(__name__)


def mux_one(video_path: Path, wav_path: Path, out_path: Path, crf: int = 10) -> None:
    from vaura_tpu_torch.data import media
    from vaura_tpu_torch.ops.audio import read_wav

    frames, _, info = media.read_video(video_path, want_audio=False)
    audio, sr = read_wav(wav_path)
    media.write_video(
        out_path,
        frames,
        fps=info["video_fps"],
        audio=audio[0],
        audio_sample_rate=sr,
        crf=crf,
    )


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("video_dir", type=Path, help="directory of source videos")
    ap.add_argument("audio_dir", type=Path, help="directory of generated WAVs")
    ap.add_argument("output_dir", type=Path)
    ap.add_argument("--crf", type=int, default=10)
    args = ap.parse_args(argv)

    args.output_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for wav in sorted(args.audio_dir.glob("*.wav")):
        video = args.video_dir / (wav.stem + ".mp4")
        if not video.exists():
            logger.warning("no source video for %s", wav.name)
            continue
        try:
            mux_one(video, wav, args.output_dir / video.name, args.crf)
            n += 1
        except Exception as e:
            logger.error("mux failed for %s: %s", wav.name, e)
    logger.info("muxed %d clips", n)


if __name__ == "__main__":
    main()
