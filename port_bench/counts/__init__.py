"""Operations and bytes from shapes, and the card's peaks.

The counts are of the work each layer needs at a cell's shapes, whatever
implements it: matrix and convolution products as 2 FLOPs a multiply-add,
attention as its two products over the keys each query sees, bytes as each
input read once and each output written once. Elementwise work (norms,
activations, Snake) is not counted as FLOPs.
"""

from __future__ import annotations

import math
from typing import Sequence

# NVIDIA H100 SXM, dense, at 700 W (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def roofline_pct(flops: float, bytes_: float, seconds: float) -> float:
    """The least time the card could take (the larger of ops over the bf16
    peak and bytes over the memory bandwidth) as a share of ``seconds``."""
    return 100.0 * max(flops / PEAK_BF16_FLOPS, bytes_ / PEAK_HBM_BYTES) / seconds


# ----------------------------------------------------------------- sampler
def sampler_widths(s: dict) -> dict:
    d, h = s["d_model"], s["nhead"]
    hidden = int(2 * (4 * d) / 3)
    mult = s.get("multiple_of", 256)
    hidden = hidden if hidden % mult == 0 else hidden + mult - hidden % mult
    kv = s.get("n_kv_head") or h
    return {"d": d, "L": s["num_layers"], "H": h, "Hkv": kv, "hd": d // h,
            "hidden": hidden, "K": s["num_codebooks"], "V": s["d_codebook"],
            "token_dim": d - d // s["cond_feature_channel_scaler"],
            "cd": s.get("codebook_dim", 8)}


def sampler_matmul_params(s: dict) -> int:
    """Weights of the products a position runs through: the blocks' dense
    layers, the LM head and the token projections."""
    w = sampler_widths(s)
    d, kv = w["d"], w["Hkv"] * w["hd"]
    block = d * (d + 2 * kv) + d * d + 3 * d * w["hidden"]
    return w["L"] * block + d * w["K"] * w["V"] + w["K"] * w["cd"] * w["token_dim"]


def sampler_decode_flops(s: dict, rows: int, steps: int) -> float:
    """A decode over ``steps`` positions (position ``p`` attends to ``p + 1``
    keys) for ``rows`` rows (both CFG streams count)."""
    w = sampler_widths(s)
    keys = steps * (steps + 1) / 2
    per_row = 2 * sampler_matmul_params(s) * steps + 4 * w["L"] * w["d"] * keys
    return rows * per_row


def sampler_train_flops(s: dict, batch: int, seq: int) -> float:
    """One training step over ``batch`` sequences of ``seq`` positions:
    ``6 N T`` for the products and ``12 L d S^2`` for attention (forward
    and backward; remat's recomputation not counted)."""
    w = sampler_widths(s)
    return batch * (6 * sampler_matmul_params(s) * seq
                    + 12 * w["L"] * w["d"] * seq * seq)


def decode_attention_bytes(s: dict, rows: int, steps: int, cache_bytes: float = 1,
                           scale_bytes: int = 4) -> float:
    """Bytes the decode-attention launches of a whole decode read and write:
    at position ``p`` each of ``rows`` rows reads its ``p`` cached K and V
    rows (``cache_bytes`` a value) and their per-head scales, the new K and
    V and q in bf16, and writes its bf16 output; every layer."""
    w = sampler_widths(s)
    Hkv, H, hd = w["Hkv"], w["H"], w["hd"]
    cached = steps * (steps - 1) / 2  # sum of p over 0 .. steps-1
    per_layer = rows * (cached * 2 * Hkv * (hd * cache_bytes + scale_bytes)
                        + steps * (2 * H * hd * 2 + 2 * Hkv * hd * 2))
    return w["L"] * per_layer


def decode_attention_flops(s: dict, rows: int, steps: int) -> float:
    w = sampler_widths(s)
    keys = steps * (steps + 1) / 2
    return w["L"] * rows * 4 * w["H"] * w["hd"] * keys


# ----------------------------------------------------------------- encoder
def encoder_widths(e: dict, frames: Sequence[int]) -> dict:
    D = e.get("embed_dim", 768)
    g = e.get("img_size", 224) // e.get("patch_size", 16)
    S, C, T = frames[0], frames[1], frames[2]
    return {"D": D, "M": e.get("mlp_ratio", 4) * D, "depth": e.get("depth", 12),
            "hw": g * g, "t": T // e.get("z_block_size", 2), "S": S,
            "patch": C * e.get("z_block_size", 2) * e.get("patch_size", 16) ** 2}


def encoder_sublayer_flops(e: dict, frames: Sequence[int]) -> float:
    """One clip's divided blocks: both attention sublayers (q/k/v and output
    projections over every token and the CLS, the CLS query over all
    tokens, each group's queries over its members and the CLS key) and the
    MLP over the tokens."""
    w = encoder_widths(e, frames)
    D, M, hw, t = w["D"], w["M"], w["hw"], w["t"]
    N = 1 + t * hw
    proj = 2 * N * D * 3 * D + 2 * N * D * D
    cls = 4 * N * D
    time_att = proj + cls + 4 * hw * t * (t + 1) * D
    space_att = proj + cls + 4 * t * hw * (hw + 1) * D
    mlp = 4 * (N - 1) * D * M
    return w["S"] * w["depth"] * (time_att + space_att + mlp)


def encoder_sublayer_bytes(e: dict, frames: Sequence[int]) -> float:
    """Each sublayer's token rows in and out (bf16) and its weights."""
    w = encoder_widths(e, frames)
    D, M, N = w["D"], w["M"], 1 + w["t"] * w["hw"]
    rows = 3 * 2 * N * D * 2
    weights = 2 * (4 * D * D) * 2 + 2 * D * M * 2
    return w["S"] * w["depth"] * (rows + weights)


def encoder_flops(e: dict, frames: Sequence[int]) -> float:
    """One clip's forward: the tubelet embedding, the blocks and the
    per-frame aggregation layer."""
    w = encoder_widths(e, frames)
    D, M, hw, t = w["D"], w["M"], w["hw"], w["t"]
    R = hw + 1
    agg = 2 * R * D * 3 * D + 4 * R * R * D + 2 * R * D * D + 4 * R * D * M
    patch = 2 * w["patch"] * D * t * hw
    return encoder_sublayer_flops(e, frames) + w["S"] * (patch + t * agg)


# ------------------------------------------------------------------- codec
def _dac(c: dict) -> dict:
    enc_rates = c.get("encoder_rates", [2, 4, 8, 8])
    enc = c.get("encoder_dim", 64)
    return {"enc": enc, "enc_rates": enc_rates,
            "dec": c.get("decoder_dim", 1536),
            "dec_rates": c.get("decoder_rates", [8, 8, 4, 2]),
            "latent": c.get("latent_dim") or enc * 2 ** len(enc_rates),
            "K": c.get("n_codebooks", 9), "cd": c.get("codebook_dim", 8),
            "hop": math.prod(enc_rates)}


def dac_hop(c: dict) -> int:
    """Waveform samples a codec frame."""
    return _dac(c)["hop"]


def dac_decode_flops(c: dict, frames: int) -> float:
    """Codes of ``frames`` codec frames -> waveform: the codebook
    projection and every convolution of the decoder."""
    w = _dac(c)
    T, d = frames, w["dec"]
    f = 2 * w["K"] * w["cd"] * w["latent"] * T + 2 * w["latent"] * d * 7 * T
    for s in w["dec_rates"]:
        f += 2 * d * (d // 2) * 2 * s * T  # the transposed conv
        T, d = T * s, d // 2
        f += 3 * (2 * d * d * 7 * T + 2 * d * d * T)
    return f + 2 * d * 7 * T


def dac_encode_flops(c: dict, samples: int) -> float:
    """A waveform of ``samples`` -> codes: every convolution of the encoder
    and the quantiser's projections and codebook similarities."""
    w = _dac(c)
    T, d = samples, w["enc"]
    f = 2 * d * 7 * T
    for s in w["enc_rates"]:
        f += 3 * (2 * d * d * 7 * T + 2 * d * d * T)
        f += 2 * d * 2 * d * 2 * s * (T // s)
        T, d = T // s, d * 2
    f += 2 * d * w["latent"] * 3 * T
    V = c.get("codebook_size", 1024)
    return f + w["K"] * T * (4 * w["latent"] * w["cd"] + 2 * w["cd"] * V)
