"""JSONL-metadata video datasets: ``VideoMeta`` + ``load_video_meta`` +
``VideoDataset`` + ``VideoDataModule`` (counterpart of
``vaura_tpu/data/video_dataset.py``).

Decoding goes through the native libav module
(``vaura_tpu.data.media.read_video``) instead of PyAV; the robust-loading
retry policy (resample a random index on bad media, up to
``max_load_attempts``, reference ``video_dataset.py:161-211``) is kept.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from vaura_tpu_torch.data.core import DataLoader, DataModule, Dataset

logger = logging.getLogger(__name__)

EPS = float(np.finfo(np.float32).eps)


@dataclasses.dataclass(order=True)
class VideoMeta:
    """ffprobe-derived per-file metadata (reference
    ``video_dataset.py:39-64``)."""

    filepath: str
    duration: float
    audio_codec_name: str = ""
    audio_fps: int = 0
    audio_channels: int = 0
    video_codec_name: str = ""
    video_fps: float = 0.0
    video_width: int = 0
    video_height: int = 0
    pix_fmt: str = ""
    description: str = ""
    material: str = ""
    action_type: str = ""
    effect: str = ""

    @classmethod
    def from_dict(cls, d: dict) -> "VideoMeta":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def load_video_meta(path: Union[str, Path], resolve: bool = False) -> List[VideoMeta]:
    """Load JSONL(.gz) metadata (reference ``video_dataset.py:66-89``)."""
    open_fn = gzip.open if str(path).lower().endswith(".gz") else open
    metas = []
    with open_fn(path, "rb") as fp:
        for line in fp.readlines():
            m = VideoMeta.from_dict(json.loads(line))
            if resolve:
                m.filepath = Path(m.filepath).resolve().as_posix()
            metas.append(m)
    return metas


def solve_discarded_filenames(file_list: Sequence[Union[str, Path]]) -> List[str]:
    """Expand files/dirs of discard lists into .mp4 basenames
    (reference ``video_dataset.py:252-283``)."""

    def from_file(f: Path) -> List[str]:
        with open(f, encoding="utf-8") as fh:
            return [
                Path(line).with_suffix(".mp4").name
                for line in fh.read().splitlines()
                if line.strip()
            ]

    out: List[str] = []
    for f in map(Path, file_list):
        if f.suffix == ".mp4":
            out.append(f.name)
        elif f.is_file():
            out.extend(from_file(f))
        elif f.is_dir():
            for sub in f.iterdir():
                out.extend(from_file(sub))
    return out


class VideoDataset(Dataset):
    """Robust JSONL-driven A/V dataset (reference
    ``video_dataset.py:91-355``). Items: ``frames`` [T, H, W, C] uint8,
    ``audio`` [1, Ta] float32, ``meta`` dict."""

    def __init__(
        self,
        split: str,
        metadata: List[VideoMeta],
        sample_duration: float,
        max_load_attempts: int = 10,
        filter_on_duration: bool = True,
        discarded_files: Sequence[Union[str, Path]] = (),
        crop: bool = True,
        seed: int = 0,
    ):
        assert max_load_attempts > 0 and sample_duration > 0
        self.split = split
        self.sample_duration = sample_duration
        self.max_load_attempts = max_load_attempts
        self.crop = crop
        self._rng = np.random.default_rng((seed, hash(split) & 0xFFFF))

        initial = len(metadata)
        if filter_on_duration:
            metadata = [
                m for m in metadata if m.duration >= sample_duration + EPS
            ]
        if discarded_files:
            discard = set(solve_discarded_filenames(discarded_files))
            metadata = [m for m in metadata if Path(m.filepath).name not in discard]
        if initial != len(metadata):
            logger.info("Filtered out %d files.", initial - len(metadata))
        self.dataset = metadata

    def __len__(self) -> int:
        return len(self.dataset)

    def _sample_start_pts(self, idx: int, duration: float, video_len: float) -> float:
        if self.split != "train":
            return 0.0
        return float(self._rng.uniform(0, max(video_len - duration - EPS, 0)))

    def _load(self, meta: VideoMeta, start_pts: float):
        from vaura_tpu_torch.data import media

        frames, audio, info = media.read_video(
            meta.filepath,
            start=start_pts,
            duration=self.sample_duration + EPS,
            fps=meta.video_fps if meta.video_fps > 0 else -1.0,
            sample_rate=meta.audio_fps if meta.audio_fps > 0 else -1,
        )
        return frames, audio, info

    def _loaded_ok(self, frames, audio, vfps: float, afps: float) -> bool:
        if frames is None or audio is None:
            return False
        if frames.shape[0] < int(vfps * self.sample_duration):
            return False
        if audio.shape[-1] < int(afps * self.sample_duration):
            return False
        return True

    def __getitem__(self, idx: int) -> dict:
        attempts = 0
        while attempts < self.max_load_attempts:
            meta = self.dataset[idx]
            start_pts = self._sample_start_pts(
                idx, self.sample_duration, meta.duration
            )
            try:
                frames, audio, info = self._load(meta, start_pts)
                if self._loaded_ok(frames, audio, meta.video_fps, meta.audio_fps):
                    break
            except Exception as e:
                logger.error("load failed for %s: %s", meta.filepath, e)
            logger.warning(
                "Video %s could not be loaded correctly. Trying another one.",
                Path(meta.filepath).name,
            )
            idx = int(self._rng.integers(0, len(self)))
            attempts += 1
        else:
            raise RuntimeError(
                f"Video could not be loaded after {self.max_load_attempts} tries."
            )

        if self.crop:
            frames = frames[: int(meta.video_fps * self.sample_duration)]
            audio = audio[..., : int(meta.audio_fps * self.sample_duration)]
        out_meta = meta.to_dict()
        out_meta["start_pts"] = start_pts
        out_meta["sample_duration"] = self.sample_duration
        out_meta.update(info)
        return {"frames": frames, "audio": audio.astype(np.float32), "meta": out_meta}

    @classmethod
    def from_meta_file(cls, path: Union[str, Path], **kwargs) -> "VideoDataset":
        path = Path(path)
        if path.is_dir():
            for cand in ("data.jsonl", "data.jsonl.gz"):
                if (path / cand).exists():
                    path = path / cand
                    break
            else:
                raise ValueError(f"no data.jsonl(.gz) under {path}")
        return cls(metadata=load_video_meta(path), **kwargs)


class VideoDataModule(DataModule):
    """Stage-based datamodule over per-split meta files (reference
    ``video_datamodule.py``)."""

    def __init__(
        self,
        batch_size: int,
        num_workers: int = 0,
        data_dir: Optional[str] = None,
        train_meta: Optional[str] = None,
        val_meta: Optional[str] = None,
        test_meta: Optional[str] = None,
        predict_meta: Optional[str] = None,
        sample_duration: float = 2.56,
        discarded_files: Sequence[str] = (),
        seed: int = 0,
        **kwargs,
    ):
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.data_dir = data_dir
        self.metas = {
            "train": train_meta,
            "validation": val_meta,
            "test": test_meta,
            "predict": predict_meta,
        }
        self.sample_duration = sample_duration
        self.discarded_files = discarded_files
        self.seed = seed
        self.kwargs = kwargs
        self.datasets: Dict[str, VideoDataset] = {}

    def _build(self, split: str) -> None:
        meta = self.metas.get(split) or self.data_dir
        if meta is None:
            raise ValueError(f"no metadata path for split {split}")
        # a dataset-root dir holds per-split subdirs (reference
        # video_datamodule.py:64-90 appends `<split>/` before looking for
        # data.jsonl, e.g. ./data/vas -> vas/test/data.jsonl)
        mp = Path(meta)
        if mp.is_dir() and not any(
            (mp / c).exists() for c in ("data.jsonl", "data.jsonl.gz")
        ) and (mp / split).is_dir():
            meta = mp / split
        self.datasets[split] = VideoDataset.from_meta_file(
            meta,
            split=split,
            sample_duration=self.sample_duration,
            discarded_files=self.discarded_files,
            seed=self.seed,
            **self.kwargs,
        )

    def setup(self, stage: Optional[str] = None) -> None:
        splits = (
            ["train", "validation", "test", "predict"]
            if stage in (None, "fit")
            else [stage if stage != "test" else "test"]
        )
        for split in splits:
            try:
                self._build(split)
            except ValueError:
                if stage is not None:
                    raise

    def train_dataloader(self) -> DataLoader:
        return DataLoader(
            self.datasets["train"], self.batch_size, shuffle=True,
            seed=self.seed, num_workers=self.num_workers,
        )

    def val_dataloader(self) -> DataLoader:
        return DataLoader(
            self.datasets["validation"], self.batch_size,
            num_workers=self.num_workers,
        )

    def test_dataloader(self) -> DataLoader:
        return DataLoader(
            self.datasets["test"], self.batch_size, num_workers=self.num_workers
        )

    def predict_dataloader(self) -> DataLoader:
        return DataLoader(self.datasets["predict"], 1)
