"""Clip partitioning of the V-JEPA-style datasets: the functions of
``vaura_tpu/data/vjepa.py`` that the VGGSound dataset uses. The V-JEPA
datamodules themselves are not ported yet (ROADMAP.md)."""

from __future__ import annotations

import numpy as np


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
