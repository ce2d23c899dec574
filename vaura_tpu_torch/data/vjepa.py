"""V-JEPA-style clip-partitioned datasets (counterpart of
``vaura_tpu/data/vjepa.py``; reference ``models/data/vjepa_dataset.py`` /
``vjepa_datamodule.py`` / ``vjepa_gen_dataset.py``).

Items carry ``frames`` partitioned into ``[num_clips, C, frames_per_clip,
H, W]`` plus ``clip_indices`` meta, matching the reference's nested-clip
contract (``vjepa_dataset.py:213-242``) collapsed to dense arrays.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np

from vaura_tpu_torch.data.transforms import Compose, build_transforms
from vaura_tpu_torch.data.video_dataset import (
    VideoDataModule,
    VideoDataset,
    VideoMeta,
    load_video_meta,
)


def get_clip_indices(
    video_len_in_samples: int,
    num_clips: int,
    frames_per_clip: int,
    frame_step: int,
    random_clip_sampling: bool = False,
    allow_clip_overlap: bool = True,
) -> np.ndarray:
    """Partition the video into equal segments and lay a frame-index
    linspace in each (reference ``vjepa_dataset.py:10-74``)."""
    partition_len = video_len_in_samples // num_clips
    clip_len = int(frames_per_clip * frame_step)
    out = []
    for i in range(num_clips):
        if partition_len > clip_len:
            end = clip_len
            if random_clip_sampling:
                end = np.random.randint(clip_len, partition_len)
            start = end - clip_len
            idx = np.linspace(start, end, num=frames_per_clip)
            idx = np.clip(idx, start, end - 1).astype(np.int64) + i * partition_len
        else:
            if allow_clip_overlap:
                idx = np.linspace(
                    0, partition_len, num=max(partition_len // frame_step, 1)
                )
                pad = frames_per_clip - len(idx)
                if pad > 0:
                    idx = np.concatenate([idx, np.full(pad, partition_len)])
                idx = np.clip(idx, 0, partition_len - 1).astype(np.int64)
                idx = idx + i * partition_len
            else:
                sample_len = min(clip_len, video_len_in_samples) - 1
                idx = np.linspace(
                    0, sample_len, num=max(sample_len // frame_step, 1)
                )
                pad = frames_per_clip - len(idx)
                if pad > 0:
                    idx = np.concatenate([idx, np.full(pad, sample_len)])
                idx = np.clip(idx, 0, sample_len - 1).astype(np.int64)
                clip_step = 0
                if video_len_in_samples > clip_len and num_clips > 1:
                    clip_step = (video_len_in_samples - clip_len) // (num_clips - 1)
                idx = idx + i * clip_step
        out.append(idx[:frames_per_clip])
    return np.stack(out)


def partition_video(
    video: np.ndarray, frames_per_clip: int, frame_step: int, num_clips: int
) -> np.ndarray:
    """[C, T, H, W] -> [num_clips, C, frames_per_clip, H, W]
    (reference ``partition_video``, nested lists collapsed)."""
    span = frames_per_clip * frame_step
    return np.stack(
        [video[:, i * span : (i + 1) * span : frame_step] for i in range(num_clips)]
    )


def partition_audio(
    audio: np.ndarray,
    frames_per_clip: int,
    frame_step: int,
    vfps: float,
    afps: float,
    num_clips: int,
) -> np.ndarray:
    """[1, Ta] -> [num_clips, 1, samples_per_clip]."""
    fpc = int(frames_per_clip / vfps * afps * frame_step)
    return np.stack([audio[:, i * fpc : (i + 1) * fpc] for i in range(num_clips)])


class VJEPADataset(VideoDataset):
    """Reference ``vjepa_dataset.py:77-211``."""

    def __init__(
        self,
        split: str,
        metadata: List[VideoMeta],
        sample_duration: float,
        max_load_attempts: int = 10,
        filter_on_duration: bool = True,
        discarded_files: Sequence[Union[str, Path]] = (),
        crop: bool = True,
        audio_transforms: Optional[Compose] = None,
        video_transforms: Optional[Compose] = None,
        partition_audio_to_clips: bool = False,
        partition_video_to_clips: bool = True,
        frames_per_clip: int = 16,
        frame_step: int = 1,
        model_fps: float = 25.0,
        assert_fps: bool = True,
        seed: int = 0,
    ):
        assert frames_per_clip > 0 and frame_step > 0 and model_fps > 0
        super().__init__(
            split,
            metadata,
            sample_duration,
            max_load_attempts,
            filter_on_duration,
            discarded_files,
            crop,
            seed=seed,
        )
        if isinstance(audio_transforms, list):
            audio_transforms = build_transforms(audio_transforms)
        if isinstance(video_transforms, list):
            video_transforms = build_transforms(video_transforms)
        self.audio_transforms = audio_transforms
        self.video_transforms = video_transforms
        self.partition_audio_to_clips = partition_audio_to_clips
        self.partition_video_to_clips = partition_video_to_clips
        self.model_fps = model_fps
        self.assert_fps = assert_fps
        self.frames_per_clip = frames_per_clip
        self.frame_step = frame_step

    def __getitem__(self, idx: int) -> dict:
        item = super().__getitem__(idx)
        if self.assert_fps:
            assert round(item["meta"]["video_fps"]) == round(self.model_fps), (
                f"Video FPS is not {self.model_fps}"
            )
        if self.audio_transforms is not None:
            item["audio"] = self.audio_transforms(item["audio"])
        # frames arrive [T, H, W, C] uint8 from the native reader; the
        # transform stack is expected to leave [C, T, H, W] float
        if self.video_transforms is not None:
            item["frames"] = self.video_transforms(item["frames"])
        else:
            item["frames"] = (
                np.transpose(item["frames"], (3, 0, 1, 2)).astype(np.float32) / 255.0
            )
        if self.partition_video_to_clips:
            item = self.to_video_segments(item)
        if self.partition_audio_to_clips:
            item = self.to_audio_segments(item)
        return item

    def _num_clips(self, item: dict) -> int:
        n = item["frames"].shape[1] // self.frames_per_clip // self.frame_step
        assert n, "num_clips is zero"
        return n

    def to_video_segments(self, item: dict) -> dict:
        n = self._num_clips(item)
        item["frames"] = partition_video(
            item["frames"], self.frames_per_clip, self.frame_step, n
        )
        item["meta"]["clip_indices"] = get_clip_indices(
            video_len_in_samples=n * self.frames_per_clip * self.frame_step,
            num_clips=n,
            frames_per_clip=self.frames_per_clip,
            frame_step=self.frame_step,
        )
        return item

    def to_audio_segments(self, item: dict) -> dict:
        n = (
            item["frames"].shape[0]
            if item["frames"].ndim == 5
            else self._num_clips(item)
        )
        item["audio"] = partition_audio(
            item["audio"],
            self.frames_per_clip,
            self.frame_step,
            item["meta"]["video_fps"],
            item["meta"]["audio_fps"],
            n,
        )
        return item


class VJEPAGenDataset(VJEPADataset):
    """Generation variant with per-file fixed start points from a CSV
    (reference ``vjepa_gen_dataset.py:27-54``)."""

    def __init__(self, *args, fixed_start_pts_csv: Optional[str] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.fixed_start_pts = {}
        if fixed_start_pts_csv:
            import csv

            with open(fixed_start_pts_csv) as f:
                for row in csv.reader(f):
                    if len(row) >= 2:
                        self.fixed_start_pts[Path(row[0]).name] = float(row[1])

    def _sample_start_pts(self, idx, duration, video_len):
        name = Path(self.dataset[idx].filepath).name
        if name in self.fixed_start_pts:
            return self.fixed_start_pts[name]
        return super()._sample_start_pts(idx, duration, video_len)


def _vjepa_module(dataset_cls):
    class _Module(VideoDataModule):
        def _build(self, split: str) -> None:
            meta = self.metas.get(split) or self.data_dir
            if meta is None:
                raise ValueError(f"no metadata path for split {split}")
            path = Path(meta)
            if path.is_dir():
                # a dataset-root dir holds per-split subdirs (reference
                # video_datamodule.py:64-90 appends `<split>/` before
                # looking for data.jsonl, e.g. ./data/vas -> vas/test/)
                for base in (path, path / split):
                    for cand in ("data.jsonl", "data.jsonl.gz"):
                        if (base / cand).exists():
                            path = base / cand
                            break
                    else:
                        continue
                    break
            self.datasets[split] = dataset_cls(
                split=split,
                metadata=load_video_meta(path),
                sample_duration=self.sample_duration,
                discarded_files=self.discarded_files,
                seed=self.seed,
                **self.kwargs,
            )

    return _Module


VJEPADataModule = _vjepa_module(VJEPADataset)
VJEPAGenDataModule = _vjepa_module(VJEPAGenDataset)
