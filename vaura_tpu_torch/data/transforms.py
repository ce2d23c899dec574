"""Video & audio transforms for the host data pipeline (numpy).

Counterpart of ``vaura_tpu/data/transforms.py`` (the same classes), itself
the equivalent of the reference's transform zoo
(``models/data/transforms/video_transforms.py`` / ``audio_transforms.py``),
instantiated from ``{target, params}`` config lists into a ``Compose``
(the reference builds an ``nn.Sequential`` the same way,
``video_transforms.py:22-35``). All transforms operate on numpy arrays:
video ``[T, H, W, C]`` uint8/float or ``[T, C, H, W]`` after ``Permute``;
audio ``[C, T]`` float32.

Reference-name and torchvision aliases resolve to these classes through
``vaura_tpu_torch.config.registry``.
"""

from __future__ import annotations

import math
import random
from typing import List, Optional, Sequence

import numpy as np
from scipy import signal as _signal

from vaura_tpu_torch.ops.audio import integrated_loudness, resample_poly


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


def build_transforms(cfg_list: Optional[List[dict]]) -> Optional[Compose]:
    """Instantiate a transform list from config (reference
    ``get_transforms``, ``video_transforms.py:22-35``)."""
    if not cfg_list:
        return None
    from vaura_tpu_torch.config import instantiate_from_config

    return Compose([instantiate_from_config(c) for c in cfg_list])


# ------------------------------------------------------------------ #
# video transforms
# ------------------------------------------------------------------ #
class ToFloat32DType:
    """uint8 [0,255] -> float32 (reference ``ToFloat32DType``)."""

    def __init__(self, scale: bool = True):
        self.scale = scale

    def __call__(self, x):
        x = np.asarray(x, dtype=np.float32)
        return x / 255.0 if self.scale else x


class Div255:
    def __call__(self, x):
        return np.asarray(x, np.float32) / 255.0


class Normalize:
    """Channel-wise (x - mean) / std over the last (or channel) axis."""

    def __init__(self, mean, std, channel_axis: int = -1):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.channel_axis = channel_axis

    def __call__(self, x):
        x = np.asarray(x, np.float32)
        shape = [1] * x.ndim
        shape[self.channel_axis] = -1
        return (x - self.mean.reshape(shape)) / self.std.reshape(shape)


class Permute:
    """Axis permutation (reference ``video_transforms.Permute``, which
    names the argument ``permutation``)."""

    def __init__(self, dims: Sequence[int] = None, permutation: Sequence[int] = None):
        assert (dims is None) != (permutation is None), "pass dims or permutation"
        self.dims = tuple(dims if dims is not None else permutation)

    def __call__(self, x):
        return np.transpose(x, self.dims)


class Resize:
    """Bilinear spatial resize of [T, H, W, C] or [T, C, H, W] video.

    torchvision semantics (the reference pipelines rely on them,
    e.g. ``Resize(256)`` then ``*Crop(224)``): an int size resizes the
    *shorter* side to that value preserving aspect ratio; a [h, w] pair
    resizes exactly. ``antialias``/``interpolation`` are accepted for
    config compatibility (PIL bilinear always antialiases).
    """

    def __init__(
        self, size, channels_last: bool = True, antialias=True, interpolation=None
    ):
        self.size = size if isinstance(size, int) else tuple(size)
        self.channels_last = channels_last

    def _target_hw(self, H: int, W: int):
        if isinstance(self.size, int):
            s = self.size
            if H <= W:
                return s, max(1, round(W * s / H))
            return max(1, round(H * s / W)), s
        return self.size

    def __call__(self, x):
        from PIL import Image

        x = np.asarray(x)
        if self.channels_last:
            th, tw = self._target_hw(x.shape[1], x.shape[2])
        else:
            th, tw = self._target_hw(x.shape[2], x.shape[3])
        frames = []
        for f in x:
            if not self.channels_last:
                f = np.transpose(f, (1, 2, 0))
            img = Image.fromarray(
                f.astype(np.uint8) if f.dtype != np.uint8 else f
            ).resize((tw, th), Image.BILINEAR)
            out = np.asarray(img)
            if not self.channels_last:
                out = np.transpose(out, (2, 0, 1))
            frames.append(out)
        out = np.stack(frames)
        return out.astype(x.dtype) if x.dtype != np.uint8 else out


class CenterCrop:
    def __init__(self, size, channels_last: bool = True):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.channels_last = channels_last

    def __call__(self, x):
        x = np.asarray(x)
        th, tw = self.size
        if self.channels_last:
            H, W = x.shape[1], x.shape[2]
            y0, x0 = (H - th) // 2, (W - tw) // 2
            return x[:, y0 : y0 + th, x0 : x0 + tw]
        H, W = x.shape[2], x.shape[3]
        y0, x0 = (H - th) // 2, (W - tw) // 2
        return x[:, :, y0 : y0 + th, x0 : x0 + tw]


class RandomNullify:
    """Zero the whole sample with probability p (reference
    ``RandomNullify``, ``video_transforms.py:80``)."""

    def __init__(self, p: float = 0.1):
        self.p = p

    def __call__(self, x):
        if random.random() < self.p:
            return np.zeros_like(x)
        return x


class UniformTemporalSubsample:
    """Evenly subsample to ``ceil(target_fps * clip_duration)`` frames
    (reference ``video_transforms.py:101``)."""

    def __init__(self, target_fps: int, clip_duration: float):
        self.num_samples = math.ceil(target_fps * clip_duration)

    def __call__(self, x):
        T = x.shape[0]
        idx = np.linspace(0, T - 1, self.num_samples)
        idx = np.clip(idx, 0, T - 1).astype(np.int64)
        return x[idx]


class GenerateMultipleSegments:
    """Segment a [T, ...] video (and optionally [Ta] audio) into
    ``n_segments`` windows of ``segment_size_vframes`` with stride
    ``step_size_seg * segment`` (reference ``video_transforms.py:114-266``).
    Train mode picks a random window start; eval centers it.
    """

    def __init__(
        self,
        segment_size_vframes: int,
        n_segments: Optional[int] = None,
        is_start_random: bool = False,
        audio_jitter_sec: float = 0.0,
        step_size_seg: float = 1.0,
    ):
        self.segment_size_vframes = segment_size_vframes
        self.n_segments = n_segments
        self.is_start_random = is_start_random
        self.audio_jitter_sec = audio_jitter_sec
        self.step_size_seg = step_size_seg

    def __call__(self, item: dict, segment_a: bool = False) -> dict:
        video = item["video"]  # [T, ...]
        v_len = video.shape[0]
        v_fps = int(item["meta"]["video"]["fps"][0])
        seg_v = self.segment_size_vframes
        stride_v = int(self.step_size_seg * seg_v)
        n_max_v = (v_len - seg_v) // stride_v + 1

        a_len = a_fps = seg_a = None
        if segment_a:
            audio = item["audio"]
            a_len = audio.shape[0]
            a_fps = int(item["meta"]["audio"]["framerate"][0])
            seg_a = int(round(seg_v / v_fps * a_fps))
            stride_a = int(self.step_size_seg * seg_a)
            n_max = min(n_max_v, (a_len - seg_a) // stride_a + 1)
        else:
            n_max = n_max_v

        n_seg = self.n_segments if self.n_segments else n_max
        assert n_seg <= n_max, (
            f"cant make {n_seg} segs of len {seg_v} in a vid of len {v_len}"
        )

        seq_len_frames = int(
            (n_seg * self.step_size_seg + (1 - self.step_size_seg)) * seg_v
        )
        max_start = v_len - seq_len_frames
        v_start = (
            random.randint(0, max_start) if self.is_start_random else max_start // 2
        )
        v_starts = np.array([v_start + i * stride_v for i in range(n_seg)])
        item["video"] = np.stack(
            [video[s : s + seg_v] for s in v_starts], axis=0
        )

        if segment_a:
            stride_a = int(self.step_size_seg * seg_a)
            a_start = int(round(v_start / v_fps * a_fps))
            a_starts = np.array([a_start + i * stride_a for i in range(n_seg)])
            if self.audio_jitter_sec > 0:
                jit = int(self.audio_jitter_sec * a_fps)
                seq_len_a = int(
                    (n_seg * self.step_size_seg + (1 - self.step_size_seg)) * seg_a
                )
                jit = min(jit, a_start, a_len - a_start - seq_len_a)
                if jit > 0:
                    a_starts = a_starts + random.randint(-jit, jit)
            item["audio"] = np.stack(
                [audio[s : s + seg_a] for s in a_starts], axis=0
            )
        return item


# ------------------------------------------------------------------ #
# audio transforms (reference audio_transforms.py:29-192)
# ------------------------------------------------------------------ #
class AudioStandardNormalize:
    def __call__(self, wav):
        wav = np.asarray(wav, np.float32)
        return (wav - wav.mean()) / (wav.std() + 1e-8)


class AudioLoudnessNormalize:
    """Target-LUFS gain (reference uses pyloudnorm)."""

    def __init__(self, target_loudness: float = -14.0, sample_rate: int = 44100):
        self.target = target_loudness
        self.sr = sample_rate

    def __call__(self, wav):
        wav = np.asarray(wav, np.float32)
        current = integrated_loudness(wav, self.sr)
        gain = 10.0 ** ((self.target - current) / 20.0)
        return wav * gain


class AudioStereoToMono:
    def __init__(self, keepdim: bool = True):
        # reference audio_transforms.py:162-168
        self.keepdim = keepdim

    def __call__(self, wav):
        wav = np.atleast_2d(np.asarray(wav, np.float32))
        return wav.mean(axis=0, keepdims=self.keepdim)


class AudioResample:
    """Polyphase resample. Two constructor surfaces: explicit
    ``(orig_freq, new_freq)``, or the reference's ``(target_sr,
    clip_duration)`` where the source rate is inferred per call from the
    waveform length (reference audio_transforms.py:171-182)."""

    def __init__(
        self,
        orig_freq: Optional[int] = None,
        new_freq: Optional[int] = None,
        target_sr: Optional[int] = None,
        clip_duration: Optional[float] = None,
    ):
        if target_sr is not None:
            assert clip_duration is not None, (
                "AudioResample(target_sr=...) needs clip_duration"
            )
            self.orig, self.new = None, int(target_sr)
            self.clip_duration = float(clip_duration)
        else:
            assert orig_freq is not None and new_freq is not None
            self.orig, self.new = int(orig_freq), int(new_freq)
            self.clip_duration = None

    def __call__(self, wav):
        wav = np.asarray(wav, np.float32)
        orig = (
            self.orig
            if self.orig is not None
            else int(round(wav.shape[-1] / self.clip_duration))
        )
        return resample_poly(wav, orig, self.new)


class AudioTrim:
    """Trim to a maximum length. Accepts ``(max_len_sec, sample_rate)``
    or the reference's ``(duration, sr)`` names
    (reference audio_transforms.py:185-192)."""

    def __init__(
        self,
        max_len_sec: Optional[float] = None,
        sample_rate: int = 44100,
        duration: Optional[float] = None,
        sr: Optional[int] = None,
    ):
        if duration is not None:
            max_len_sec = duration
        if sr is not None:
            sample_rate = sr
        self.max_len = (
            math.ceil(max_len_sec * sample_rate)
            if max_len_sec is not None
            else None
        )

    def __call__(self, wav):
        if self.max_len is None:
            return wav
        return wav[..., : self.max_len]


class AudioUnsqueeze:
    def __call__(self, wav):
        wav = np.asarray(wav, np.float32)
        return wav[None] if wav.ndim == 1 else wav


class AudioRandomVolume:
    """Random gain (reference wraps torchaudio Vol)."""

    def __init__(self, p: float = 0.5, gain: float = 2.0, gain_type: str = "amplitude"):
        self.p = p
        self.gain = gain
        self.gain_type = gain_type

    def __call__(self, wav):
        if random.random() >= self.p:
            return wav
        g = random.uniform(1.0 / self.gain, self.gain)
        if self.gain_type == "db":
            g = 10 ** (g / 20)
        return np.clip(np.asarray(wav, np.float32) * g, -1.0, 1.0)


class AudioLowpassFilter:
    def __init__(self, p: float = 0.5, cutoff_freq: float = 8000, sample_rate: int = 44100):
        self.p = p
        self.sos = _signal.butter(
            4, cutoff_freq, btype="low", fs=sample_rate, output="sos"
        )

    def __call__(self, wav):
        if random.random() >= self.p:
            return wav
        return _signal.sosfilt(self.sos, np.asarray(wav, np.float32), axis=-1).astype(
            np.float32
        )


class AudioGaussNoise:
    def __init__(self, p: float = 0.5, amplitude: float = 0.01):
        self.p = p
        self.amplitude = amplitude

    def __call__(self, wav):
        if random.random() >= self.p:
            return wav
        wav = np.asarray(wav, np.float32)
        return wav + np.random.randn(*wav.shape).astype(np.float32) * self.amplitude


class AudioPitchShift:
    """Pitch shift by semitones via resample + time-stretch-free crop
    (approximation of the reference's sox pitch effect)."""

    def __init__(self, p: float = 0.5, shift: int = 2, sample_rate: int = 44100):
        self.p = p
        self.shift = shift
        self.sr = sample_rate

    def __call__(self, wav):
        if random.random() >= self.p:
            return wav
        semitones = random.uniform(-self.shift, self.shift)
        rate = 2 ** (semitones / 12.0)
        wav = np.asarray(wav, np.float32)
        T = wav.shape[-1]
        res = resample_poly(wav, int(self.sr * rate), self.sr)
        if res.shape[-1] >= T:
            return res[..., :T]
        pad = T - res.shape[-1]
        return np.pad(res, [(0, 0)] * (res.ndim - 1) + [(0, pad)])


class AudioReverb:
    """Simple exponential-decay convolution reverb (approximation of the
    reference's sox reverb)."""

    def __init__(self, p: float = 0.5, decay: float = 0.3, sample_rate: int = 44100):
        self.p = p
        ir_len = int(0.2 * sample_rate)
        t = np.arange(ir_len) / sample_rate
        self.ir = (np.exp(-t / decay) * np.random.default_rng(0).standard_normal(ir_len)).astype(np.float32)
        self.ir /= np.abs(self.ir).sum()

    def __call__(self, wav):
        if random.random() >= self.p:
            return wav
        wav = np.atleast_2d(np.asarray(wav, np.float32))
        out = np.stack(
            [_signal.fftconvolve(ch, self.ir)[: ch.shape[-1]] for ch in wav]
        )
        return (0.7 * wav + 0.3 * out).astype(np.float32)


class AudioPhaser:
    """Allpass-cascade phaser (approximation of the sox phaser effect)."""

    def __init__(self, p: float = 0.5, sample_rate: int = 44100):
        self.p = p
        self.sr = sample_rate

    def __call__(self, wav):
        if random.random() >= self.p:
            return wav
        wav = np.asarray(wav, np.float32)
        out = wav
        for f0 in (200.0, 400.0, 800.0):
            w0 = 2 * math.pi * f0 / self.sr
            a = (1 - math.tan(w0 / 2)) / (1 + math.tan(w0 / 2))
            b = [a, -1.0]
            aa = [1.0, -a]
            out = _signal.lfilter(b, aa, out, axis=-1).astype(np.float32)
        return (0.5 * wav + 0.5 * out).astype(np.float32)


class RandomCrop:
    def __init__(self, size, channels_last: bool = True):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.channels_last = channels_last

    def __call__(self, x):
        x = np.asarray(x)
        th, tw = self.size
        if self.channels_last:
            H, W = x.shape[1], x.shape[2]
        else:
            H, W = x.shape[2], x.shape[3]
        y0 = random.randint(0, max(H - th, 0))
        x0 = random.randint(0, max(W - tw, 0))
        if self.channels_last:
            return x[:, y0 : y0 + th, x0 : x0 + tw]
        return x[:, :, y0 : y0 + th, x0 : x0 + tw]


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5, channels_last: bool = True):
        self.p = p
        self.channels_last = channels_last

    def __call__(self, x):
        if random.random() < self.p:
            return np.flip(x, axis=-2 if self.channels_last else -1).copy()
        return x
