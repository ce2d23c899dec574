"""Synthetic dataset/datamodule — the fixture backend that lets every action
run without real media (counterpart of ``vaura_tpu/data/dummy.py``, the same
items under one seed; registered as dataset type ``dummy``).

Output contract per item:
  * ``frames``: [num_clips, 3, frames_per_clip, H, W] float32 (constant
    fill = idx, like the reference's ``torch.full``)
  * ``audio``: [1, ceil(video_length * sample_rate_audio)] float32 noise
  * ``meta``: ``clip_indices`` [num_clips, frames_per_clip] int64 and
    ``filepath``

666 train / 66 eval items (reference ``dummy_dataset.py:30-33``).
"""

from __future__ import annotations

from math import ceil
from typing import Optional, Tuple

import numpy as np

from vaura_tpu_torch.data.core import DataLoader, DataModule, Dataset


class DummyDataset(Dataset):
    def __init__(
        self,
        split: str,
        frame_shape: Tuple[int, int] = (224, 224),
        video_length: float = 2.56,
        sample_rate_audio: int = 44100,
        sample_rate_video: float = 25.0,
        frames_per_clip: int = 16,
        num_clips: int = 4,
        frame_step: int = 1,
        seed: int = 0,
        **_,
    ):
        self.split = split
        self.frame_shape = frame_shape
        self.frames_per_clip = frames_per_clip
        self.num_clips = num_clips
        self.frame_step = frame_step
        self.seed = seed
        self.video_len_in_samples = ceil(video_length * sample_rate_video)
        self.audio_len_in_samples = ceil(video_length * sample_rate_audio)

    def __len__(self) -> int:
        return 666 if self.split == "train" else 66

    def _clip_indices(self) -> np.ndarray:
        """Equal partitioning of the video into ``num_clips`` segments with
        a linspace of frame indices in each (reference
        ``dummy_dataset.py:53-...``, the default non-random path)."""
        partition_len = self.video_len_in_samples // self.num_clips
        clip_len = int(self.frames_per_clip * self.frame_step)
        out = []
        for i in range(self.num_clips):
            if partition_len > clip_len:
                idx = np.linspace(0, clip_len, num=self.frames_per_clip)
                idx = np.clip(idx, 0, clip_len - 1).astype(np.int64)
            else:
                idx = np.linspace(
                    0, partition_len, num=max(partition_len // self.frame_step, 1)
                )
                pad = self.frames_per_clip - len(idx)
                if pad > 0:
                    idx = np.concatenate([idx, np.full(pad, partition_len)])
                idx = np.clip(idx, 0, partition_len - 1).astype(np.int64)
            out.append(idx + i * partition_len)
        return np.stack(out)

    def __getitem__(self, idx: int) -> dict:
        H, W = self.frame_shape
        frames = np.full(
            (self.num_clips, 3, self.frames_per_clip, H, W),
            float(idx),
            dtype=np.float32,
        )
        rng = np.random.default_rng((self.seed, idx))
        audio = rng.standard_normal((1, self.audio_len_in_samples)).astype(
            np.float32
        )
        return {
            "frames": frames,
            "audio": audio,
            "meta": {
                "clip_indices": self._clip_indices(),
                "filepath": f"/dummy/{idx}.mp4",
            },
        }


class DummyDataModule(DataModule):
    def __init__(
        self,
        batch_size: int,
        num_workers: int = 0,
        frame_shape: Tuple[int, int] = (224, 224),
        seed: int = 0,
        **kwargs,
    ):
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.frame_shape = tuple(frame_shape)
        self.seed = seed
        self.kwargs = kwargs
        self.datasets = {}

    def setup(self, stage: Optional[str] = None) -> None:
        for split in ["train", "validation", "test", "predict"]:
            self.datasets[split] = DummyDataset(
                split, frame_shape=self.frame_shape, seed=self.seed, **self.kwargs
            )

    def train_dataloader(self) -> DataLoader:
        return DataLoader(
            self.datasets["train"],
            self.batch_size,
            shuffle=True,
            seed=self.seed,
            num_workers=self.num_workers,
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
        # batch 1 like the reference (dummy_datamodule.py predict loader)
        return DataLoader(self.datasets["predict"], 1, num_workers=0)
