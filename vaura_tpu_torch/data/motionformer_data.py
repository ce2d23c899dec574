"""MotionFormer datasets (counterpart of
``vaura_tpu/data/motionformer_data.py``; reference
``models/data/motionformer_dataset.py`` / ``motionformer_gen_dataset.py`` +
their datamodules).

Same contract as the VJEPA family but segments are produced by a sliding
window over contiguous frames (``GenerateMultipleSegments``): items carry
``frames`` ``[S, C, 16, H, W]`` segments ready for the divided space-time
ViT.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from vaura_tpu_torch.data.transforms import GenerateMultipleSegments
from vaura_tpu_torch.data.vjepa import (
    VJEPADataset,
    _vjepa_module,
)


class MotionFormerDataset(VJEPADataset):
    """Reference ``motionformer_dataset.py:11-117``: partition via the
    segment transform with train-time random window starts."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.to_segments_transform = GenerateMultipleSegments(
            segment_size_vframes=self.frames_per_clip,
            n_segments=None,  # set per item
            is_start_random=(self.split == "train"),
            audio_jitter_sec=0.0,
            step_size_seg=self.frame_step,
        )

    def to_video_segments(self, item: dict) -> dict:
        num_clips = (
            item["frames"].shape[1] // self.frames_per_clip // self.frame_step
        )
        assert num_clips, "num_clips is zero"
        self.to_segments_transform.n_segments = num_clips
        tmp = {
            # transform operates time-major
            "video": np.transpose(item["frames"], (1, 0, 2, 3)),  # [T, C, H, W]
            "audio": item["audio"].mean(axis=0),
            "path": item["meta"]["filepath"],
            "meta": {
                "video": {"fps": [item["meta"]["video_fps"]]},
                "audio": {"framerate": [item["meta"]["audio_fps"]]},
            },
        }
        tmp = self.to_segments_transform(
            tmp, segment_a=self.partition_audio_to_clips
        )
        if self.partition_audio_to_clips:
            item["audio"] = tmp["audio"][:, None, :]  # [S, 1, Ta_seg]
        # [S, T, C, H, W] -> [S, C, T, H, W]
        item["frames"] = np.transpose(tmp["video"], (0, 2, 1, 3, 4))
        return item

    def to_audio_segments(self, item: dict) -> dict:
        # already handled inside to_video_segments (reference
        # motionformer_dataset.py:113-117)
        return item


class MotionFormerGenDataset(MotionFormerDataset):
    """Generation variant with fixed per-file start points
    (reference ``motionformer_gen_dataset.py:27-54``)."""

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


MotionFormerDataModule = _vjepa_module(MotionFormerDataset)
MotionFormerGenDataModule = _vjepa_module(MotionFormerGenDataset)
