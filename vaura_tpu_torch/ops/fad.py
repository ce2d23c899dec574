"""Frechet Audio Distance and paired KL divergence (in-repo eval metrics).

Counterpart of ``vaura_tpu/ops/fad.py`` (numpy; the port keeps its own copy,
as it imports nothing of the JAX package). The metric math with a pluggable
embedder: ``MelStatsEmbedder`` (deterministic log-mel statistics, offline;
not comparable to published numbers), ``ops/vggish.py`` and
``ops/panns.py`` (the published embedding networks, on a device).

FAD (Kilgour et al. 2019): the Frechet distance between Gaussians fitted
to embedding sets, ``|mu1-mu2|^2 + tr(C1 + C2 - 2 (C1^1/2 C2 C1^1/2)^1/2)``,
with the PSD square roots from symmetric eigendecompositions (negative
eigenvalues of finite-sample covariances clamped).

Paired KLD: mean KL(ref || gen) between a classifier's output distributions
on matched reference and generated clips.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "embedding_stats",
    "frechet_distance",
    "frechet_audio_distance",
    "paired_kl_divergence",
    "paired_kl_divergence_from_probs",
    "MelStatsEmbedder",
]


def embedding_stats(emb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Mean and covariance of an ``[N, D]`` embedding set."""
    emb = np.asarray(emb, np.float64)
    assert emb.ndim == 2, emb.shape
    mu = emb.mean(axis=0)
    cov = np.cov(emb, rowvar=False)
    if cov.ndim == 0:  # D == 1
        cov = cov.reshape(1, 1)
    return mu, cov


def _psd_sqrt(mat: np.ndarray) -> np.ndarray:
    """Symmetric PSD square root via eigh, clamping negative eigenvalues."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(
    mu1: np.ndarray, cov1: np.ndarray, mu2: np.ndarray, cov2: np.ndarray
) -> float:
    """Fréchet distance between two Gaussians.

    ``tr((C1^1/2 C2 C1^1/2)^1/2)`` is computed through PSD eigh square
    roots, which is exact for the symmetric product form and avoids the
    complex drift of ``sqrtm(C1 @ C2)``.
    """
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    cov1, cov2 = np.asarray(cov1, np.float64), np.asarray(cov2, np.float64)
    diff = mu1 - mu2
    s1_half = _psd_sqrt(cov1)
    covmean_tr = np.trace(_psd_sqrt(s1_half @ cov2 @ s1_half))
    return float(
        diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * covmean_tr
    )


def frechet_audio_distance(
    emb_background: np.ndarray, emb_eval: np.ndarray
) -> float:
    """FAD between a background (reference) and an evaluation embedding
    set, both ``[N, D]``."""
    mu1, c1 = embedding_stats(emb_background)
    mu2, c2 = embedding_stats(emb_eval)
    return frechet_distance(mu1, c1, mu2, c2)


def paired_kl_divergence(
    logits_ref: np.ndarray, logits_gen: np.ndarray, eps: float = 1e-10
) -> float:
    """Mean KL(ref || gen) between paired classifier distributions
    (``[N, C]`` logits each)."""
    lr = np.asarray(logits_ref, np.float64)
    lg = np.asarray(logits_gen, np.float64)
    assert lr.shape == lg.shape and lr.ndim == 2, (lr.shape, lg.shape)

    def softmax(x):
        x = x - x.max(axis=-1, keepdims=True)
        e = np.exp(x)
        return e / e.sum(axis=-1, keepdims=True)

    p, q = softmax(lr), softmax(lg)
    kl = np.sum(p * (np.log(p + eps) - np.log(q + eps)), axis=-1)
    return float(kl.mean())


def paired_kl_divergence_from_probs(
    probs_ref: np.ndarray, probs_gen: np.ndarray, eps: float = 1e-8
) -> float:
    """Mean KL(ref || gen) between paired multi-label posteriors
    (``[N, C]`` each, e.g. PANNs sigmoid outputs), row-normalized into
    distributions first (the convention audio-generation KLD evals use for
    multi-label taggers)."""
    p = np.asarray(probs_ref, np.float64) + eps
    q = np.asarray(probs_gen, np.float64) + eps
    assert p.shape == q.shape and p.ndim == 2, (p.shape, q.shape)
    p = p / p.sum(axis=-1, keepdims=True)
    q = q / q.sum(axis=-1, keepdims=True)
    kl = np.sum(p * (np.log(p) - np.log(q)), axis=-1)
    return float(kl.mean())


class MelStatsEmbedder:
    """Deterministic offline audio embedder: per-clip concat of log-mel
    frame means and standard deviations (``2 * n_mels`` dims). A stand-in
    for pretrained classifier embeddings (VGGish / PANN) when no weights
    are available; any callable ``wav, sr -> [D]`` plugs into
    :func:`frechet_audio_distance` the same way."""

    def __init__(self, n_fft: int = 1024, n_mels: int = 64):
        self.n_fft = n_fft
        self.n_mels = n_mels

    def __call__(self, wav: np.ndarray, sr: int) -> np.ndarray:
        from vaura_tpu_torch.ops.audio import log_mel

        mel = log_mel(wav, sr, self.n_fft, self.n_mels)  # [n_mels, T]
        return np.concatenate([mel.mean(axis=-1), mel.std(axis=-1)])
