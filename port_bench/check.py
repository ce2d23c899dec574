"""The comparison that decides ``correct``: the program's outputs against the
plain reference, run after the window has closed.

Generation: for rows of every call of the window, drawn from the seed and
the call's index, the reference runs the sampler teacher-forced over the
served sequence with the visual condition and with the null condition
(the encoder's features worked out again from the frames where the cell
sends frames) and blends them with the configuration's CFG scale. It
draws again, from the call's generator, the Gumbel noise that the tokens
were sampled with, and measures how far each served token's score (its
blended logit over the temperature plus its noise, among the top-k) lies
below the reference's best: 0 where the reference draws the same token.
``token_gap`` is the widest gap and ``token_gap_mean`` the mean over every
generated slot. The reference decodes the served codes to a waveform, and
the program's waveform's relative L2 distance from it is ``wave_rel_err``
(the widest row); in a frames cell, that of the program's features is
``feat_rel_err``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

from port_bench.reference import dac as ref_dac
from port_bench.reference import encoder as ref_encoder
from port_bench.reference import sampler as ref_sampler


@contextlib.contextmanager
def exact_matmuls():
    """float32 products without TF32, restored afterwards (the flags are
    the process's: the program's window runs with its own)."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per row (first axis) ``||got - ref|| / ||ref||``."""
    d = (got.float() - ref.float()).flatten(1).norm(dim=1)
    return d / ref.float().flatten(1).norm(dim=1).clamp_min(1e-30)


@torch.no_grad()
def compare_generation(made: Dict[str, Dict[str, torch.Tensor]], config: dict,
                       served: List[dict], block: int = 2) -> Dict[str, float]:
    """``served``: per call the compared ``rows``, the call's sampling
    ``generator`` (made anew from the seed) and ``batch``, the rows'
    ``codes [n, K, T]``, ``audio [n, 1, N]``, inputs (``feats [n, Tv, D]``
    or ``frames [n, S, C, T, H, W]``) and, with frames, the program's
    ``prog_feats``. Returns ``token_gap``, ``token_gap_mean``,
    ``wave_rel_err`` and (frames) ``feat_rel_err``."""
    g = config["generate"]
    V = config["sampler"]["d_codebook"]
    out = {"token_gap": 0.0, "wave_rel_err": 0.0}
    total, n_slots = 0.0, 0
    with exact_matmuls():
        for call in served:
            n, K, T = call["codes"].shape
            noise = ref_sampler.gumbel_draws(call["generator"], call["batch"],
                                             K, V, T + K - 1, call["rows"])
            for sl in ref_sampler.blocks(n, block):
                if "frames" in call:
                    feats = ref_encoder.features(made["encoder"], config["encoder"],
                                                 call["frames"][sl])
                    err = rel_err(call["prog_feats"][sl], feats).max().item()
                    out["feat_rel_err"] = max(out.get("feat_rel_err", 0.0), err)
                else:
                    feats = call["feats"][sl]
                codes = call["codes"][sl]
                seq, valid = ref_sampler.delayed_sequence(codes, V)
                blended = ref_sampler.guided_logits(
                    made["sampler"], config["sampler"], seq, feats,
                    g["tokens_per_frame"], g["cfg_scale"])
                gap = ref_sampler.served_gap(blended, seq, valid, g["top_k"],
                                             g["temperature"], noise[sl])
                del blended
                out["token_gap"] = max(out["token_gap"], gap.max().item())
                total += gap.double().sum().item()
                n_slots += gap.numel()
                wave = ref_dac.decode(made["dac"], config["codec"], codes)
                err = rel_err(call["audio"][sl], wave).max().item()
                out["wave_rel_err"] = max(out["wave_rel_err"], err)
            del noise
    out["token_gap_mean"] = total / max(n_slots, 1)
    return out


def verdict(readings: Dict[str, float], limits: Dict[str, float],
            complete: bool) -> Tuple[bool, list]:
    """``(correct, [(name, value, limit)])``: every reading at or under its
    limit, none missing, and every answer came."""
    checks = [(k, float(readings.get(k, float("nan"))), float(lim))
              for k, lim in sorted(limits.items())]
    ok = complete and all(v <= lim for _, v, lim in checks)
    return ok, checks


def sample_rows(n: int, k: int, seed: int, index: int = 0) -> torch.Tensor:
    """``k`` of ``n`` rows drawn from the seed and a call's ``index``,
    sorted."""
    from port_bench.weights import stream

    g = torch.Generator().manual_seed(stream(seed, 1000 + index))
    return torch.randperm(n, generator=g)[:k].sort().values


def sequence_complete(codes: torch.Tensor, vocab: int) -> bool:
    """Every generated code is a codebook entry (none left unfilled)."""
    return bool(((codes >= 0) & (codes < vocab)).all())


def peak(device) -> Optional[int]:
    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))
