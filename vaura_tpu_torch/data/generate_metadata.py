"""Dataset metadata generation (counterpart of
``vaura_tpu/data/generate_metadata.py``; reference
``models/data/generate_metadata.py``): probe media files and write the
JSONL metadata consumed by the family-B datasets. Uses the native libav
module instead of shelling out to ffprobe."""

from __future__ import annotations

import argparse
import gzip
import json
import logging
from pathlib import Path
from typing import Iterable, Optional

logger = logging.getLogger(__name__)


def probe_to_meta(path: Path) -> Optional[dict]:
    from vaura_tpu_torch.data import media

    try:
        info = media.probe(path)
    except Exception as e:
        logger.warning("probe failed for %s: %s", path, e)
        return None
    return {
        "filepath": str(path),
        "duration": info["duration"],
        "audio_codec_name": "aac" if info["has_audio"] else "",
        "audio_fps": info["audio_sample_rate"],
        "audio_channels": info["audio_channels"],
        "video_codec_name": "h264" if info["has_video"] else "",
        "video_fps": info["video_fps"],
        "video_width": info["width"],
        "video_height": info["height"],
        "pix_fmt": "yuv420p",
    }


def write_meta_file(
    video_paths: Iterable[Path], out_path: Path, compress: bool = False
) -> int:
    out_path.parent.mkdir(parents=True, exist_ok=True)
    open_fn = gzip.open if compress or str(out_path).endswith(".gz") else open
    n = 0
    with open_fn(out_path, "wt") as f:
        for p in video_paths:
            meta = probe_to_meta(Path(p))
            if meta is not None:
                f.write(json.dumps(meta) + "\n")
                n += 1
    logger.info("wrote %d entries to %s", n, out_path)
    return n


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("video_dir", type=Path)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--glob", default="*.mp4")
    ap.add_argument("--gzip", action="store_true")
    args = ap.parse_args()
    out = args.out or (
        args.video_dir / ("data.jsonl.gz" if args.gzip else "data.jsonl")
    )
    files = sorted(args.video_dir.glob(args.glob))
    write_meta_file(files, out, compress=args.gzip)


if __name__ == "__main__":
    main()
