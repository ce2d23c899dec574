"""Generate the bundled data assets the reference ships via git-LFS.

Counterpart of ``scripts/make_demo_assets.py``, over
``vaura_tpu_torch/data/media.py``: the same files, JSONL and score JSON
schemas and seeded clips, so both tools produce the same assets. A host
tool that touches no device; it needs the native media library (libav),
which the card's machine lacks: there the first clip raises
``MediaError``.

The reference distribution bundles small data assets that exist in its
repo only as git-LFS pointers (unfetchable offline):

* ``data/demo/*.mp4`` + ``data/demo/test/data.jsonl`` — three 10 s demo
  clips + family-B JSONL metadata (reference ``demo.ipynb`` cells 1-8,
  ``data/demo/dataloader_config.yaml``).
* ``data/vas/test/data.jsonl`` — VAS test-set metadata consumed by
  ``configs/generate_vas.yaml`` (reference ``video_dataset.py:333-355``).
* ``data/excluded_files/filtered_examples_vggsound/imagebind_scores.json``
  (+ ``_norm`` variant) and
  ``.../filtered_examples_audioset/imagebind_scores_audioset.json`` —
  ImageBind AV-alignment scores used by the filtering study
  (reference ``vggsound_dataset.py:142-153``).

This script synthesizes schema-identical stand-ins so every shipped
config and the demo run out of the box: deterministic test-pattern MP4s
(written by the native libav module to the media contract's codecs), real
probed JSONL metadata over them, and seeded placeholder score JSONs
covering the shipped split lists. Drop the upstream LFS files over them
for the real content.

Usage::

    python -m vaura_tpu_torch.scripts.make_demo_assets [--root data]
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger("make_demo_assets")

# reference demo clip names (data/demo/*.mp4; YouTube id + ms range)
DEMO_CLIPS = (
    "76UZQRJq028_181000_191000.mp4",
    "Vi7kQhNcaOs_114000_124000.mp4",
    "xK-7W3ZPd3o_94000_104000.mp4",
)
# VAS category naming (test-set clips are <category>__<id>.mp4 style)
VAS_CLIPS = (
    "dog__demo0001.mp4",
    "drum__demo0002.mp4",
    "fireworks__demo0003.mp4",
    "hammer__demo0004.mp4",
)


def _pattern_frames(seed: int, n: int, h: int, w: int) -> np.ndarray:
    """A smooth moving test pattern (compresses well, decodes anywhere)."""
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0, 2 * np.pi, size=3)
    speed = rng.uniform(1.0, 4.0, size=3)
    t = np.arange(n, dtype=np.float32)[:, None, None]
    y = np.linspace(0, 2 * np.pi, h, dtype=np.float32)[None, :, None]
    x = np.linspace(0, 2 * np.pi, w, dtype=np.float32)[None, None, :]
    chans = [
        0.5 + 0.5 * np.sin(x * (i + 1) + y * (3 - i) + phase[i] + 0.1 * speed[i] * t)
        for i in range(3)
    ]
    return np.stack(
        [np.broadcast_to(c, (n, h, w)) for c in chans], axis=-1
    ).astype(np.float32)


def _event_audio(seed: int, seconds: float, sr: int) -> np.ndarray:
    """Sparse percussive events (clicks/tones) — sounds vaguely like the
    onset-heavy content the model targets."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    audio = np.zeros(n, np.float32)
    t_ev = np.sort(rng.uniform(0.1, seconds - 0.2, size=int(seconds * 3)))
    for te in t_ev:
        i = int(te * sr)
        dur = int(rng.uniform(0.02, 0.12) * sr)
        f0 = rng.uniform(120.0, 2000.0)
        env = np.exp(-np.linspace(0, 6, dur, dtype=np.float32))
        tone = np.sin(
            2 * np.pi * f0 / sr * np.arange(dur, dtype=np.float32)
        )
        audio[i : i + dur] += 0.6 * env[: len(audio) - i] * tone[: len(audio) - i]
    return np.clip(audio, -1, 1)


def make_clip(path: Path, seed: int, seconds: float, fps: float,
              hw: tuple[int, int], sr: int) -> None:
    from vaura_tpu_torch.data import media

    n = int(round(seconds * fps))
    frames = _pattern_frames(seed, n, *hw)
    audio = _event_audio(seed + 1, seconds, sr)
    path.parent.mkdir(parents=True, exist_ok=True)
    media.write_video(
        path, frames, fps=fps, audio=audio, audio_sample_rate=sr, crf=23
    )
    logger.info("wrote %s (%.1fs @ %g fps, %d Hz)", path, seconds, fps, sr)


def write_jsonl(video_paths, out_path: Path, root: Path) -> None:
    """data.jsonl with repo-root-relative filepaths (the configs and demo
    run from the repo root, reference data/demo/test/data.jsonl)."""
    from vaura_tpu_torch.data.generate_metadata import probe_to_meta

    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        for p in video_paths:
            meta = probe_to_meta(Path(p))
            assert meta is not None, f"probe failed for {p}"
            meta["filepath"] = str(Path(p).relative_to(root.parent))
            f.write(json.dumps(meta) + "\n")
    logger.info("wrote %s (%d entries)", out_path, len(video_paths))


def write_imagebind_scores(root: Path) -> None:
    """Seeded placeholder AV-alignment scores over the shipped split
    lists — JSON ``{clip name: score in [0,1]}``. The `_norm` variant is
    min-max normalized (the ib_filtering_study configs consume it with
    thresholds 0.0-0.3)."""
    rng = np.random.default_rng(0x1B)

    def names_from(split_dir: Path) -> list[str]:
        names: list[str] = []
        for txt in sorted(split_dir.glob("*.txt")):
            names += [
                ln.strip() for ln in txt.read_text().splitlines() if ln.strip()
            ]
        return sorted(set(names))

    vgg = names_from(root / "splits" / "vggsound")
    vgg += names_from(root / "splits" / "visualsound")
    vgg = sorted(set(vgg))
    scores = {n: round(float(s), 6) for n, s in
              zip(vgg, rng.beta(5.0, 2.0, size=len(vgg)))}
    lo, hi = (min(scores.values()), max(scores.values())) if scores else (0, 1)
    norm = {n: round((s - lo) / max(hi - lo, 1e-9), 6)
            for n, s in scores.items()}
    d = root / "excluded_files" / "filtered_examples_vggsound"
    d.mkdir(parents=True, exist_ok=True)
    (d / "imagebind_scores.json").write_text(json.dumps(scores, indent=0))
    (d / "imagebind_scores_norm.json").write_text(json.dumps(norm, indent=0))
    logger.info("wrote %s (%d entries)", d, len(scores))

    aud = names_from(root / "splits" / "audioset")
    a_scores = {n: round(float(s), 6) for n, s in
                zip(aud, rng.beta(5.0, 2.0, size=len(aud)))}
    da = root / "excluded_files" / "filtered_examples_audioset"
    da.mkdir(parents=True, exist_ok=True)
    (da / "imagebind_scores_audioset.json").write_text(
        json.dumps(a_scores, indent=0)
    )
    logger.info("wrote %s (%d entries)", da, len(a_scores))


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", type=Path, default=Path("data"))
    args = ap.parse_args(argv)
    root = args.root.resolve()

    # demo clips: 10 s @ 30 fps, 288x384, 48 kHz — deliberately NOT at the
    # media contract (25 fps / 44.1 kHz) so the demo dataloader's
    # on-the-fly resample path is exercised, like the reference's raw
    # YouTube demo clips
    demo_paths = []
    for i, name in enumerate(DEMO_CLIPS):
        p = root / "demo" / name
        make_clip(p, seed=100 + i, seconds=10.0, fps=30.0, hw=(288, 384),
                  sr=48000)
        demo_paths.append(p)
    write_jsonl(demo_paths, root / "demo" / "test" / "data.jsonl", root)

    # VAS test clips: 8 s @ 25 fps (VAS distributes pre-cut clips)
    vas_paths = []
    for i, name in enumerate(VAS_CLIPS):
        p = root / "vas" / "test" / "videos" / name
        make_clip(p, seed=200 + i, seconds=8.0, fps=25.0, hw=(256, 342),
                  sr=44100)
        vas_paths.append(p)
    write_jsonl(vas_paths, root / "vas" / "test" / "data.jsonl", root)

    write_imagebind_scores(root)


if __name__ == "__main__":
    main()
