"""VGGish audio embedder (Hershey et al. 2017), the standard FAD embedding.

Counterpart of ``vaura_tpu/ops/vggish.py``: the same numpy front end
(``log_mel_patches``, as the published ``vggish_params`` /
``mel_features`` define it: 16 kHz mono, 25 ms periodic-Hann window and
10 ms hop, 512-point magnitude STFT, 64 HTK-mel bands over 125-7500 Hz,
``log(mel + 0.01)``, non-overlapping 0.96 s examples of 96 x 64), and the
network as an ``nn.Module`` on an explicit device. The module carries
torchvggish's own names (``features.{0,3,6,8,11,13}`` for the six 3x3
convs between ReLUs and 2x2 max-pools, ``embeddings.{0,2,4}`` for the
three fully connected layers), so the published ``vggish.pth`` loads with
``load_state_dict`` and needs no converter; it flattens the last feature
map in (h, w, c) order before the FC stack, as torchvggish does.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from vaura_tpu_torch.utils import DeviceLike, resolve_device

SAMPLE_RATE = 16000
STFT_WINDOW = 400  # 25 ms
STFT_HOP = 160  # 10 ms
NUM_MEL_BINS = 64
MEL_MIN_HZ = 125.0
MEL_MAX_HZ = 7500.0
LOG_OFFSET = 0.01
EXAMPLE_FRAMES = 96  # 0.96 s at the 10 ms hop
EMBEDDING_DIM = 128


def _hz_to_mel(f):
    return 1127.0 * np.log1p(np.asarray(f, np.float64) / 700.0)


def _mel_matrix(num_spec_bins: int) -> np.ndarray:
    """[num_spec_bins, NUM_MEL_BINS] triangular weights (HTK mel), per the
    published ``mel_features.spectrogram_to_mel_matrix``."""
    nyquist = SAMPLE_RATE / 2.0
    spec_mel = _hz_to_mel(np.linspace(0.0, nyquist, num_spec_bins))
    band_edges = np.linspace(
        _hz_to_mel(MEL_MIN_HZ), _hz_to_mel(MEL_MAX_HZ), NUM_MEL_BINS + 2
    )
    weights = np.zeros((num_spec_bins, NUM_MEL_BINS))
    for i in range(NUM_MEL_BINS):
        lo, center, hi = band_edges[i : i + 3]
        lower = (spec_mel - lo) / (center - lo)
        upper = (hi - spec_mel) / (hi - center)
        weights[:, i] = np.maximum(0.0, np.minimum(lower, upper))
    weights[0, :] = 0.0  # DC bin excluded
    return weights


def log_mel_patches(wav: np.ndarray, sr: int) -> np.ndarray:
    """Waveform -> [N, 96, 64] log-mel examples (float32); an empty
    [0, 96, 64] array for clips shorter than one example."""
    wav = np.asarray(wav, np.float32).reshape(-1)
    if sr != SAMPLE_RATE:
        from vaura_tpu_torch.ops.audio import resample_poly

        wav = np.asarray(resample_poly(wav, sr, SAMPLE_RATE)).reshape(-1)
    empty = np.zeros((0, EXAMPLE_FRAMES, NUM_MEL_BINS), np.float32)
    if wav.shape[0] < STFT_WINDOW:
        return empty
    n_frames = 1 + (wav.shape[0] - STFT_WINDOW) // STFT_HOP
    idx = (np.arange(STFT_WINDOW)[None, :]
           + STFT_HOP * np.arange(n_frames)[:, None])
    window = 0.5 - 0.5 * np.cos(
        2.0 * np.pi / STFT_WINDOW * np.arange(STFT_WINDOW)
    )  # periodic Hann (mel_features.periodic_hann)
    mag = np.abs(np.fft.rfft(wav[idx] * window, n=512))  # fft_length 512
    logmel = np.log(mag @ _mel_matrix(mag.shape[1]) + LOG_OFFSET)
    n_ex = logmel.shape[0] // EXAMPLE_FRAMES
    if n_ex == 0:
        return empty
    return (logmel[: n_ex * EXAMPLE_FRAMES]
            .reshape(n_ex, EXAMPLE_FRAMES, NUM_MEL_BINS).astype(np.float32))


class VGGish(nn.Module):
    """``[N, 96, 64]`` log-mel examples -> ``[N, 128]`` embeddings."""

    def __init__(self, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        conv = lambda i, o: nn.Conv2d(i, o, 3, padding=1, device=device)
        pool = lambda: nn.MaxPool2d(2, 2)
        self.features = nn.Sequential(
            conv(1, 64), nn.ReLU(), pool(),
            conv(64, 128), nn.ReLU(), pool(),
            conv(128, 256), nn.ReLU(), conv(256, 256), nn.ReLU(), pool(),
            conv(256, 512), nn.ReLU(), conv(512, 512), nn.ReLU(), pool(),
        )
        self.embeddings = nn.Sequential(
            nn.Linear(512 * 4 * 6, 4096, device=device), nn.ReLU(),
            nn.Linear(4096, 4096, device=device), nn.ReLU(),
            nn.Linear(4096, EMBEDDING_DIM, device=device), nn.ReLU(),
        )
        self.device = device

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        with full_float32():
            x = self.features(patches[:, None])  # NCHW -> [N, 512, 6, 4]
            # torchvggish flattens in (h, w, c) order
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
            return self.embeddings(x)


@contextlib.contextmanager
def full_float32():
    """Run convolutions and matrix products in full float32 until the block
    ends, restoring the flags after: on the card cuDNN takes TF32 for
    float32 convolutions by default (``torch.backends.cudnn.allow_tf32``),
    whose 10-bit mantissas would part the embeddings from the CPU's."""
    backends = torch.backends
    flags = (backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32)
    backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32 = flags


def load_checkpoint(path, module: nn.Module, unwrap=("state_dict",),
                    skip=()) -> nn.Module:
    """Load a published ``.pth`` into ``module`` (strict, after unwrapping
    the keys of ``unwrap`` and dropping names that start with ``skip``).
    The file is read with ``weights_only=True`` (tensors, containers and
    numbers, as the published files hold): a file that pickles other
    objects is refused."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in unwrap:
        if isinstance(sd, dict) and key in sd:
            sd = sd[key]
    module.load_state_dict({k: v for k, v in sd.items()
                            if not k.startswith(tuple(skip))})
    return module.eval()


class VGGishEmbedder:
    """Pluggable embedder for ``ops/fad.py``: one 128-d row per 0.96 s
    example (FAD statistics are taken over examples, as in the published
    evaluation protocols), computed on ``device``."""

    name = "vggish"

    def __init__(self, ckpt_path: str, device: DeviceLike = None):
        self.net = load_checkpoint(ckpt_path, VGGish(device))

    @torch.no_grad()
    def __call__(self, wav: np.ndarray, sr: int) -> np.ndarray:
        patches = log_mel_patches(wav, sr)
        if patches.shape[0] == 0:
            return np.zeros((0, EMBEDDING_DIM), np.float32)
        x = torch.from_numpy(patches).to(self.net.device)
        return self.net(x).float().cpu().numpy()
