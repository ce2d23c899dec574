"""PANNs Cnn14 audio tagger (Kong et al. 2020): embeddings for FAD and
class posteriors for paired KLD.

Counterpart of ``vaura_tpu/ops/panns.py``: the same numpy front end
(torchlibrosa's: 32 kHz mono, centred power STFT with reflect padding,
n_fft 1024, hop 320, periodic Hann; 64 Slaney-normalised mel bands over
50-14000 Hz; ``10 log10(max(mel, 1e-10))``), and Cnn14 as an ``nn.Module``
on an explicit device with the published checkpoint's names (``bn0``,
``conv_block{1..6}.{conv1,bn1,conv2,bn2}``, ``fc1``, ``fc_audioset``), so
``Cnn14_mAP=0.431.pth`` loads with ``load_state_dict`` (its spectrogram
and mel-bank tensors are skipped: the front end computes them). The
network: ``bn0`` over the mel axis, six blocks of two 3x3 conv-BN-ReLU and
a 2x2 average pool (64 ... 2048 channels), the mel mean, the time max plus
mean, ``fc1`` + ReLU -> 2048-d embedding, ``fc_audioset`` -> 527 sigmoid
posteriors. Every block pools 2x2 here, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vaura_tpu_torch.ops.vggish import full_float32, load_checkpoint
from vaura_tpu_torch.utils import DeviceLike, resolve_device

SAMPLE_RATE = 32000
N_FFT = 1024
HOP = 320
N_MELS = 64
FMIN, FMAX = 50.0, 14000.0
AMIN = 1e-10
BLOCK_CHANNELS = (64, 128, 256, 512, 1024, 2048)
N_CLASSES = 527


def _hz_to_mel_slaney(f):
    f = np.asarray(f, np.float64)
    # linear below 1 kHz, logarithmic above (librosa htk=False)
    mel = f / (200.0 / 3.0)
    return np.where(
        f >= 1000.0,
        15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
        mel,
    )


def _mel_to_hz_slaney(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0,
                    1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)),
                    m * (200.0 / 3.0))


def _mel_filterbank() -> np.ndarray:
    """[n_fft // 2 + 1, N_MELS] Slaney-normalised triangular filters
    (librosa.filters.mel's defaults, which torchlibrosa uses)."""
    fft_hz = np.linspace(0.0, SAMPLE_RATE / 2.0, N_FFT // 2 + 1)
    hz_pts = _mel_to_hz_slaney(np.linspace(
        _hz_to_mel_slaney(FMIN), _hz_to_mel_slaney(FMAX), N_MELS + 2))
    weights = np.zeros((fft_hz.shape[0], N_MELS))
    for i in range(N_MELS):
        lo, center, hi = hz_pts[i : i + 3]
        lower = (fft_hz - lo) / max(center - lo, 1e-10)
        upper = (hi - fft_hz) / max(hi - center, 1e-10)
        # Slaney norm: constant energy per band
        weights[:, i] = np.maximum(0.0, np.minimum(lower, upper)) * (
            2.0 / (hi - lo))
    return weights


def log_mel_spectrogram(wav: np.ndarray, sr: int) -> np.ndarray:
    """Waveform -> [T, 64] log-mel frames, torchlibrosa-compatible."""
    wav = np.asarray(wav, np.float32).reshape(-1)
    if sr != SAMPLE_RATE:
        from vaura_tpu_torch.ops.audio import resample_poly

        wav = np.asarray(resample_poly(wav, sr, SAMPLE_RATE)).reshape(-1)
    if wav.shape[0] < N_FFT:
        wav = np.pad(wav, (0, N_FFT - wav.shape[0]))
    half = N_FFT // 2
    padded = np.pad(wav, (half, half), mode="reflect")  # centred frames
    n_frames = 1 + (padded.shape[0] - N_FFT) // HOP
    idx = np.arange(N_FFT)[None, :] + HOP * np.arange(n_frames)[:, None]
    window = np.hanning(N_FFT + 1)[:-1].astype(np.float32)  # periodic Hann
    power = np.abs(np.fft.rfft(padded[idx] * window, n=N_FFT)) ** 2
    mel = power @ _mel_filterbank()
    return (10.0 * np.log10(np.maximum(mel, AMIN))).astype(np.float32)


class ConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, bias=False,
                               device=device)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False,
                               device=device)
        self.bn1 = nn.BatchNorm2d(cout, device=device)
        self.bn2 = nn.BatchNorm2d(cout, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        return F.avg_pool2d(x, 2)


class Cnn14(nn.Module):
    """``[N, T, 64]`` log-mel -> ``(embedding [N, 2048], posteriors
    [N, 527])``; use in eval mode (BatchNorm on its running statistics)."""

    def __init__(self, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.bn0 = nn.BatchNorm2d(N_MELS, device=device)
        chans = (1,) + BLOCK_CHANNELS
        for i in range(len(BLOCK_CHANNELS)):
            self.add_module(f"conv_block{i + 1}",
                            ConvBlock(chans[i], chans[i + 1], device))
        self.fc1 = nn.Linear(2048, 2048, device=device)
        self.fc_audioset = nn.Linear(2048, N_CLASSES, device=device)
        self.device = device

    def forward(self, logmel: torch.Tensor):
        with full_float32():
            x = self.bn0(logmel[:, None].transpose(1, 3)).transpose(1, 3)
            for i in range(len(BLOCK_CHANNELS)):
                x = getattr(self, f"conv_block{i + 1}")(x)
            x = x.mean(dim=3)  # the mel axis -> [N, C, T']
            x = x.amax(dim=2) + x.mean(dim=2)  # time pool
            emb = F.relu(self.fc1(x))
            return emb, torch.sigmoid(self.fc_audioset(emb))


class PANNsEmbedder:
    """Pluggable embedder for ``ops/fad.py``: one 2048-d embedding row per
    clip for FAD, and the AudioSet posteriors of the most recent call in
    ``last_probs`` for paired KLD; computed on ``device``."""

    name = "panns"

    def __init__(self, ckpt_path: str, device: DeviceLike = None):
        self.net = load_checkpoint(
            ckpt_path, Cnn14(device), unwrap=("model", "state_dict"),
            skip=("spectrogram_extractor.", "logmel_extractor."))
        self.last_probs: np.ndarray | None = None

    @torch.no_grad()
    def __call__(self, wav: np.ndarray, sr: int) -> np.ndarray:
        logmel = torch.from_numpy(log_mel_spectrogram(wav, sr)[None])
        emb, probs = self.net(logmel.to(self.net.device))
        self.last_probs = probs.float().cpu().numpy()[0]
        return emb.float().cpu().numpy()
