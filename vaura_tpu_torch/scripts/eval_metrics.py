"""Objective audio metrics over generated clips, and the eval action.

Counterpart of ``scripts/eval_metrics.py``: per pair of ``<stem>.wav``
files in a generated and a reference directory, the multi-scale log-mel L1
distance, SI-SNR and the loudness (LUFS) difference; with ``fad`` a
set-level Frechet audio distance under a named embedder (``melstats``:
offline and deterministic, not comparable to published numbers;
``vggish``: a torchvggish checkpoint, the standard published-FAD
embedding; ``panns``: a Cnn14 checkpoint, which also gives the paired
``kld_panns``). The embedding networks run on a device: ``--platform``
(``cpu``, ``gpu`` or ``cuda``) here, ``trainer.platform`` in the eval
action (``run_eval``), else CUDA, which raises when absent.

Usage::

    python -m vaura_tpu_torch.scripts.eval_metrics GENERATED_DIR REFERENCE_DIR \\
        [--fad --embedder vggish --embedder-ckpt vggish.pth] [--out report.json]
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np

from vaura_tpu_torch.ops.audio import (
    integrated_loudness,
    log_mel,
    read_wav,
    resample_poly,
)
from vaura_tpu_torch.utils import DeviceLike

logger = logging.getLogger(__name__)

_PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def spectral_distance(a: np.ndarray, b: np.ndarray, sr: int) -> float:
    """Multi-scale log-mel L1 (the melspec term of AudioCraft-style
    reconstruction metrics)."""
    n = min(len(a), len(b))
    a, b = a[:n], b[:n]
    dists = []
    for n_fft in (512, 1024, 2048):
        ma, mb = log_mel(a, sr, n_fft), log_mel(b, sr, n_fft)
        tmin = min(ma.shape[1], mb.shape[1])
        dists.append(float(np.mean(np.abs(ma[:, :tmin] - mb[:, :tmin]))))
    return float(np.mean(dists))


def si_snr(est: np.ndarray, ref: np.ndarray) -> float:
    n = min(len(est), len(ref))
    est, ref = est[:n] - est[:n].mean(), ref[:n] - ref[:n].mean()
    s = (np.dot(est, ref) / (np.dot(ref, ref) + 1e-9)) * ref
    e = est - s
    return float(10 * np.log10((np.dot(s, s) + 1e-9) / (np.dot(e, e) + 1e-9)))


def evaluate_pair(gen_path: Path, ref_path: Path) -> dict:
    g, gsr = read_wav(gen_path)
    r, rsr = read_wav(ref_path)
    g, r = g[0], r[0]
    if gsr != rsr:
        r = resample_poly(r, rsr, gsr)
    return {
        "melspec_l1": spectral_distance(g, r, gsr),
        "si_snr_db": si_snr(g, r),
        "loudness_delta_lufs": float(
            integrated_loudness(g, gsr) - integrated_loudness(r, gsr)
        ),
    }


def make_embedder(name: str, ckpt: "str | None" = None,
                  device: DeviceLike = None):
    """A named FAD embedder (``ops/fad.py``'s interface): ``melstats``
    (numpy), ``vggish`` or ``panns`` (a network on ``device``, from the
    checkpoint ``ckpt``)."""
    if name == "melstats":
        from vaura_tpu_torch.ops.fad import MelStatsEmbedder

        return MelStatsEmbedder()
    if name == "vggish":
        assert ckpt, "vggish embedder needs --embedder-ckpt vggish.pth"
        from vaura_tpu_torch.ops.vggish import VGGishEmbedder

        return VGGishEmbedder(ckpt, device)
    if name == "panns":
        assert ckpt, "panns embedder needs --embedder-ckpt Cnn14_mAP=0.431.pth"
        from vaura_tpu_torch.ops.panns import PANNsEmbedder

        return PANNsEmbedder(ckpt, device)
    raise ValueError(f"unknown embedder {name!r}")


def evaluate_dirs(
    generated_dir: Path,
    reference_dir: Path,
    fad: bool = False,
    embedder: str = "melstats",
    embedder_ckpt: "str | None" = None,
    device: DeviceLike = None,
) -> dict:
    """Pairwise metrics over ``<stem>.wav`` pairs + optional set-level FAD
    with a named embedder. Returns ``{"per_file", "mean", "n"}``."""
    from vaura_tpu_torch.ops.fad import (
        frechet_audio_distance,
        paired_kl_divergence_from_probs,
    )

    results = {}
    gen_embs, ref_embs = [], []
    gen_probs, ref_probs = [], []
    emb = make_embedder(embedder, embedder_ckpt, device) if fad else None

    def _rows(e):
        e = np.asarray(e)
        return e[None] if e.ndim == 1 else e  # embedders may emit [N, D]

    for gen in sorted(Path(generated_dir).glob("*.wav")):
        ref = Path(reference_dir) / gen.name
        if not ref.exists():
            logger.warning("no reference for %s", gen.name)
            continue
        results[gen.stem] = evaluate_pair(gen, ref)
        if emb is not None:
            for path, embs, probs in ((gen, gen_embs, gen_probs),
                                      (ref, ref_embs, ref_probs)):
                wav, sr = read_wav(path)
                embs.append(_rows(emb(wav[0], sr)))
                if getattr(emb, "last_probs", None) is not None:
                    probs.append(emb.last_probs)
    if not results:
        return {"per_file": {}, "mean": {}, "n": 0}
    agg = {
        key: float(np.mean([r[key] for r in results.values()]))
        for key in next(iter(results.values()))
    }
    if emb is not None:
        ge = np.concatenate(gen_embs) if gen_embs else np.zeros((0, 1))
        re_ = np.concatenate(ref_embs) if ref_embs else np.zeros((0, 1))
        if len(ge) > 1 and len(re_) > 1:
            agg[f"fad_{embedder}"] = frechet_audio_distance(re_, ge)
        if gen_probs and len(gen_probs) == len(ref_probs):
            # paired KLD over classifier posteriors (panns embedder)
            agg[f"kld_{embedder}"] = paired_kl_divergence_from_probs(
                np.stack(ref_probs), np.stack(gen_probs)
            )
    return {"per_file": results, "mean": agg, "n": len(results)}


def run_eval(cfg: dict):
    """The eval action (``main.py``'s ``action=eval``): ``generated_dir``
    (or ``output_dir``) against ``reference_dir``, with ``fad``,
    ``embedder`` and ``embedder_ckpt``; prints the mean metrics as JSON
    and returns the report. Without the two directories it prints where
    the metrics come from and returns None. The device is the config's
    (``config_device``), resolved first: without CUDA and without
    ``trainer.platform`` the action raises."""
    from vaura_tpu_torch.scripts.generate import config_device

    device = config_device(cfg)
    gen_dir = cfg.get("generated_dir") or cfg.get("output_dir")
    ref_dir = cfg.get("reference_dir")
    if not (gen_dir and ref_dir):
        print(
            "eval: pass generated_dir=... reference_dir=... for the "
            "in-repo objective metrics (vaura_tpu_torch/scripts/"
            "eval_metrics.py), or use an external FAD/KLD framework as the "
            "reference does (reference README.md:93)."
        )
        return None
    report = evaluate_dirs(
        gen_dir, ref_dir, fad=bool(cfg.get("fad")),
        embedder=str(cfg.get("embedder", "melstats")),
        embedder_ckpt=cfg.get("embedder_ckpt"), device=device,
    )
    print(json.dumps(report["mean"], indent=2))
    return report


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("generated_dir", type=Path)
    ap.add_argument("reference_dir", type=Path)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument(
        "--fad", action="store_true",
        help="also compute a set-level Frechet Audio Distance with the "
             "embedder chosen by --embedder",
    )
    ap.add_argument(
        "--embedder", choices=["melstats", "vggish", "panns"], default="melstats",
        help="FAD embedding network: melstats (offline, deterministic, "
             "NOT comparable to published numbers), vggish (torchvggish "
             "weights; the standard published-FAD embedding) or panns "
             "(Cnn14 checkpoint; also reports paired kld_panns)",
    )
    ap.add_argument("--embedder-ckpt", type=str, default=None)
    ap.add_argument(
        "--platform", choices=sorted(_PLATFORMS), default=None,
        help="the device of the embedder network (default: CUDA, which "
             "must be present)",
    )
    args = ap.parse_args()
    report = evaluate_dirs(
        args.generated_dir, args.reference_dir, args.fad,
        embedder=args.embedder, embedder_ckpt=args.embedder_ckpt,
        device=_PLATFORMS[args.platform] if args.platform else None,
    )
    if report["n"] == 0:
        logger.error("no pairs evaluated")
        return
    print(json.dumps(report["mean"], indent=2))
    if args.out:
        args.out.write_text(json.dumps(report, indent=2))
        logger.info("wrote %s", args.out)


if __name__ == "__main__":
    main()
