"""Host audio ops: normalization strategies, loudness, resampling, WAV I/O.

Counterpart of ``vaura_tpu/ops/audio.py`` (numpy and scipy only, kept as the
port's own copy): ``normalize_audio`` with clip/peak/rms/loudness strategies
(loudness as ITU-R BS.1770 K-weighted integrated loudness), polyphase
resampling on the host, a stdlib 16-bit WAV writer and reader, the header
and sample encoding of a WAV stream, and a log-mel spectrogram.
"""

from __future__ import annotations

import math
import wave
from pathlib import Path
from typing import Optional

import numpy as np
from scipy import signal as _signal


# ----------------------------------------------------------------- #
# loudness (ITU-R BS.1770-4, mono/stereo, no gating blocks < 400ms)
# ----------------------------------------------------------------- #
def _k_weighting_coeffs(sr: int):
    """Pre-filter (shelving) + RLB high-pass biquads of BS.1770."""
    # stage 1: spherical-head shelving filter
    db = 3.999843853973347
    f0 = 1681.974450955533
    Q = 0.7071752369554196
    K = math.tan(math.pi * f0 / sr)
    Vh = 10 ** (db / 20.0)
    Vb = Vh**0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    b_shelf = np.array(
        [
            (Vh + Vb * K / Q + K * K) / a0,
            2.0 * (K * K - Vh) / a0,
            (Vh - Vb * K / Q + K * K) / a0,
        ]
    )
    a_shelf = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0])
    # stage 2: RLB high-pass
    f0 = 38.13547087602444
    Q = 0.5003270373238773
    K = math.tan(math.pi * f0 / sr)
    a_hp = np.array(
        [
            1.0,
            2.0 * (K * K - 1.0) / (1.0 + K / Q + K * K),
            (1.0 - K / Q + K * K) / (1.0 + K / Q + K * K),
        ]
    )
    b_hp = np.array([1.0, -2.0, 1.0])
    return (b_shelf, a_shelf), (b_hp, a_hp)


def integrated_loudness(wav: np.ndarray, sample_rate: int) -> float:
    """BS.1770-4 integrated loudness (LUFS) with -70/-10 LU gating.
    ``wav``: [C, T] or [T]."""
    wav = np.atleast_2d(np.asarray(wav, dtype=np.float64))
    (b1, a1), (b2, a2) = _k_weighting_coeffs(sample_rate)
    filtered = _signal.lfilter(b2, a2, _signal.lfilter(b1, a1, wav, axis=-1), axis=-1)
    block = int(0.4 * sample_rate)
    hop = int(0.1 * sample_rate)
    if filtered.shape[-1] < block:
        ms = np.mean(filtered**2, axis=-1).sum()
        return -0.691 + 10 * math.log10(max(ms, 1e-12))
    n_blocks = 1 + (filtered.shape[-1] - block) // hop
    powers = np.array(
        [
            (filtered[:, i * hop : i * hop + block] ** 2).mean(axis=-1).sum()
            for i in range(n_blocks)
        ]
    )
    loudness_blocks = -0.691 + 10 * np.log10(np.maximum(powers, 1e-12))
    # absolute gate
    keep = loudness_blocks > -70.0
    if not keep.any():
        return -70.0
    # relative gate
    rel_threshold = (
        -0.691 + 10 * np.log10(max(powers[keep].mean(), 1e-12)) - 10.0
    )
    keep &= loudness_blocks > rel_threshold
    if not keep.any():
        return -70.0
    return float(-0.691 + 10 * np.log10(max(powers[keep].mean(), 1e-12)))


def normalize_loudness(
    wav: np.ndarray,
    sample_rate: int,
    loudness_headroom_db: float = 14.0,
    loudness_compressor: bool = False,
    energy_floor: float = 2e-3,
) -> np.ndarray:
    """Reference ``utils/data_utils.py:337-388``."""
    wav = np.asarray(wav, dtype=np.float32)
    energy = float(np.sqrt(np.mean(wav**2)))
    if energy < energy_floor:
        return wav
    input_loudness_db = integrated_loudness(wav, sample_rate)
    delta = -loudness_headroom_db - input_loudness_db
    gain = 10.0 ** (delta / 20.0)
    out = gain * wav
    if loudness_compressor:
        out = np.tanh(out)
    return out


def normalize_audio(
    wav: np.ndarray,
    normalize: bool = True,
    strategy: str = "peak",
    peak_clip_headroom_db: float = 6.0,
    rms_headroom_db: float = 18.0,
    loudness_headroom_db: float = 12.0,
    loudness_compressor: bool = False,
    sample_rate: Optional[int] = None,
) -> np.ndarray:
    """Reference ``utils/data_utils.py:407-...`` strategies:
    clip / peak / rms / loudness."""
    wav = np.asarray(wav, dtype=np.float32)
    scale_peak = 10 ** (-peak_clip_headroom_db / 20)
    scale_rms = 10 ** (-rms_headroom_db / 20)
    if strategy == "peak":
        rescale = scale_peak / max(float(np.abs(wav).max()), 1e-12)
        if normalize or rescale < 1:
            wav = wav * rescale
    elif strategy == "clip":
        wav = np.clip(wav, -scale_peak, scale_peak)
    elif strategy == "rms":
        mono = wav.mean(axis=0) if wav.ndim > 1 else wav
        rescale = scale_rms / max(float(np.sqrt((mono**2).mean())), 1e-12)
        if normalize or rescale < 1:
            wav = wav * rescale
        wav = np.clip(wav, -1, 1)
    elif strategy == "loudness":
        assert sample_rate is not None, "loudness normalization needs sample_rate"
        wav = normalize_loudness(
            wav, sample_rate, loudness_headroom_db, loudness_compressor
        )
        wav = np.clip(wav, -1, 1)
    elif strategy in ("", "none", None):
        pass
    else:
        raise ValueError(f"Unknown normalization strategy {strategy!r}")
    return wav


# ----------------------------------------------------------------- #
# resampling
# ----------------------------------------------------------------- #
def resample_poly(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample on host (data-pipeline use). For on-device
    resampling use a strided conv with a windowed-sinc kernel."""
    if orig_sr == target_sr:
        return wav
    g = math.gcd(int(orig_sr), int(target_sr))
    return _signal.resample_poly(wav, target_sr // g, orig_sr // g, axis=-1).astype(
        np.float32
    )


# ----------------------------------------------------------------- #
# WAV I/O (stdlib)
# ----------------------------------------------------------------- #
def write_wav(path, wav: np.ndarray, sample_rate: int) -> None:
    """16-bit PCM WAV writer. ``wav``: [T] or [C, T] float in [-1, 1].
    ``path``: filename or a binary file-like object (e.g. BytesIO for the
    serving surface)."""
    wav = np.asarray(wav)
    if wav.ndim == 1:
        wav = wav[None]
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2")
    dest = path if hasattr(path, "write") else str(path)
    with wave.open(dest, "wb") as f:
        f.setnchannels(pcm.shape[0])
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.T.tobytes())


def wav_stream_header(sample_rate: int, channels: int = 1) -> bytes:
    """RIFF/WAVE header for a 16-bit PCM stream of UNKNOWN length: the
    RIFF and data chunk sizes are 0xFFFFFFFF — the convention players and
    ffmpeg accept for live WAV streams (a finite WAV's sizes are patched
    after the fact; a socket can't seek back). Append :func:`pcm16`
    frames after it (serving surface: ``scripts/serve.py /generate_long``)."""
    import struct

    byte_rate = sample_rate * channels * 2
    return b"".join(
        [
            b"RIFF", struct.pack("<I", 0xFFFFFFFF), b"WAVE",
            b"fmt ", struct.pack(
                "<IHHIIHH", 16, 1, channels, sample_rate, byte_rate,
                channels * 2, 16,
            ),
            b"data", struct.pack("<I", 0xFFFFFFFF),
        ]
    )


def pcm16(wav: np.ndarray) -> bytes:
    """float [-1, 1] ``[T]`` or ``[C, T]`` -> interleaved little-endian
    int16 bytes (the sample encoding of :func:`write_wav`, without the
    container — for streaming after :func:`wav_stream_header`)."""
    wav = np.asarray(wav)
    if wav.ndim == 1:
        wav = wav[None]
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2")
    return pcm.T.tobytes()


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    with wave.open(str(path), "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        ch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    return data.reshape(-1, ch).T, sr


def log_mel(
    wav: np.ndarray, sr: int, n_fft: int = 1024, n_mels: int = 64
) -> np.ndarray:
    """Log-mel spectrogram ``[n_mels, T]`` (triangular filterbank over an
    STFT power spectrum; 75% overlap). Shared by the objective eval
    metrics (``scripts/eval_metrics.py``) and the offline FAD embedder
    (``vaura_tpu.ops.fad.MelStatsEmbedder``)."""
    from scipy import signal as _signal

    f, _t, spec = _signal.stft(
        np.asarray(wav, np.float32).reshape(-1), fs=sr, nperseg=n_fft,
        noverlap=n_fft * 3 // 4,
    )
    power = np.abs(spec) ** 2
    mel_f = 2595 * np.log10(1 + f / 700)
    mel_pts = np.linspace(mel_f.min(), mel_f.max(), n_mels + 2)
    fb = np.zeros((n_mels, len(f)))
    for m in range(n_mels):
        lo, mid, hi = mel_pts[m], mel_pts[m + 1], mel_pts[m + 2]
        up = (mel_f - lo) / max(mid - lo, 1e-9)
        down = (hi - mel_f) / max(hi - mid, 1e-9)
        fb[m] = np.clip(np.minimum(up, down), 0, 1)
    return np.log(fb @ power + 1e-8)
