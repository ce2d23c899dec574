"""Plain float32 reference of the 44.1 kHz DAC codec (Descript Audio Codec,
the 8 kbps model V-AURA uses): codes -> waveform and waveform -> codes.

Weight norm is taken as folded (``W = g * v / ||v||``), each conv one
plain weight. Snake is ``x + sin^2(alpha x) / (alpha + 1e-9)``. The
residual vector quantiser projects the residual to ``codebook_dim``, takes
the codebook entry of highest cosine similarity, projects it back and
subtracts it. The caller switches TF32 off (``exact_matmuls``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Spec = Tuple[str, Tuple[int, ...], str]


def widths(cfg: dict) -> dict:
    rates = cfg.get("encoder_rates", [2, 4, 8, 8])
    enc = cfg.get("encoder_dim", 64)
    return {"enc": enc, "enc_rates": rates,
            "dec": cfg.get("decoder_dim", 1536),
            "dec_rates": cfg.get("decoder_rates", [8, 8, 4, 2]),
            "latent": cfg.get("latent_dim") or enc * 2 ** len(rates),
            "K": cfg.get("n_codebooks", 9), "V": cfg.get("codebook_size", 1024),
            "cd": cfg.get("codebook_dim", 8),
            "hop": math.prod(rates)}


def _res_specs(p: str, dim: int) -> List[Spec]:
    return [(p + "snake1.alpha", (dim,), "ones"),
            (p + "conv1.weight", (dim, dim, 7), "fan_in"),
            (p + "conv1.bias", (dim,), "zeros"),
            (p + "snake2.alpha", (dim,), "ones"),
            (p + "conv2.weight", (dim, dim, 1), "fan_in"),
            (p + "conv2.bias", (dim,), "zeros")]


def param_specs(cfg: dict) -> List[Spec]:
    """Every parameter as ``(name, shape, init)`` (see
    ``reference.sampler.param_specs``; ``unit`` is N(0, 1), ``axis1``
    N(0, 1/shape[1]), ``conv_t`` a transposed conv's N(0, 1/(2 in)),
    ``out`` N(0, 0.003^2/fan_in), which keeps the waveform below
    tanh's saturation)."""
    w = widths(cfg)
    specs: List[Spec] = [("encoder.conv_in.weight", (w["enc"], 1, 7), "fan_in"),
                         ("encoder.conv_in.bias", (w["enc"],), "zeros")]
    d = w["enc"]
    for i, s in enumerate(w["enc_rates"]):
        p = f"encoder.blocks.{i}."
        for j, dil in enumerate((1, 3, 9)):
            specs += _res_specs(p + f"res{j + 1}.", d)
        specs += [(p + "snake.alpha", (d,), "ones"),
                  (p + "down.weight", (2 * d, d, 2 * s), "fan_in"),
                  (p + "down.bias", (2 * d,), "zeros")]
        d *= 2
    specs += [("encoder.snake_out.alpha", (d,), "ones"),
              ("encoder.conv_out.weight", (w["latent"], d, 3), "fan_in"),
              ("encoder.conv_out.bias", (w["latent"],), "zeros"),
              ("quantizer.codebooks", (w["K"], w["V"], w["cd"]), "unit"),
              ("quantizer.in_proj_w", (w["K"], w["latent"], w["cd"]), "axis1"),
              ("quantizer.in_proj_b", (w["K"], w["cd"]), "zeros"),
              ("quantizer.out_proj_w", (w["K"], w["cd"], w["latent"]), "axis1"),
              ("quantizer.out_proj_b", (w["K"], w["latent"]), "zeros"),
              ("decoder.conv_in.weight", (w["dec"], w["latent"], 7), "fan_in"),
              ("decoder.conv_in.bias", (w["dec"],), "zeros")]
    d = w["dec"]
    for i, s in enumerate(w["dec_rates"]):
        p = f"decoder.blocks.{i}."
        specs += [(p + "snake.alpha", (d,), "ones"),
                  (p + "up.weight", (d, d // 2, 2 * s), "conv_t"),
                  (p + "up.bias", (d // 2,), "zeros")]
        for j in range(3):
            specs += _res_specs(p + f"res{j + 1}.", d // 2)
        d //= 2
    specs += [("decoder.snake_out.alpha", (d,), "ones"),
              ("decoder.conv_out.weight", (1, d, 7), "out"),
              ("decoder.conv_out.bias", (1,), "zeros")]
    return specs


def _snake(x, alpha):
    a = alpha.float()[None, :, None]
    return x + torch.sin(a * x) ** 2 / (a + 1e-9)


def _conv(sd, name, x, **kw):
    return F.conv1d(x, sd[name + ".weight"].float(), sd[name + ".bias"].float(),
                    **kw)


def _residual(sd, p, x, dilation):
    y = _conv(sd, p + "conv1", _snake(x, sd[p + "snake1.alpha"]),
              padding=3 * dilation, dilation=dilation)
    y = _conv(sd, p + "conv2", _snake(y, sd[p + "snake2.alpha"]))
    return x + y


def decode(sd: Dict[str, torch.Tensor], cfg: dict, codes: torch.Tensor
           ) -> torch.Tensor:
    """Codes ``[B, K, T]`` -> waveform ``[B, 1, T * hop]``."""
    w = widths(cfg)
    B, K, T = codes.shape
    cb = sd["quantizer.codebooks"].float()[:K]
    z = sd["quantizer.out_proj_b"].float()[:K].sum(0)[None, :, None]
    for k in range(K):
        z = z + (cb[k][codes[:, k].long()] @ sd["quantizer.out_proj_w"][k].float()
                 ).transpose(1, 2)
    x = _conv(sd, "decoder.conv_in", z, padding=3)
    for i, s in enumerate(w["dec_rates"]):
        p = f"decoder.blocks.{i}."
        x = F.conv_transpose1d(_snake(x, sd[p + "snake.alpha"]),
                               sd[p + "up.weight"].float(),
                               sd[p + "up.bias"].float(), stride=s,
                               padding=math.ceil(s / 2))
        for j, dil in enumerate((1, 3, 9)):
            x = _residual(sd, p + f"res{j + 1}.", x, dil)
    x = _conv(sd, "decoder.conv_out", _snake(x, sd["decoder.snake_out.alpha"]),
              padding=3)
    return torch.tanh(x)


def encode(sd: Dict[str, torch.Tensor], cfg: dict, wav: torch.Tensor
           ) -> torch.Tensor:
    """Waveform ``[B, 1, N]`` (right-padded with zeros to a multiple of the
    hop) -> codes ``[B, K, N / hop]``."""
    w = widths(cfg)
    hop = w["hop"]
    x = F.pad(wav.float(), (0, (hop - wav.shape[-1] % hop) % hop))
    x = _conv(sd, "encoder.conv_in", x, padding=3)
    for i, s in enumerate(w["enc_rates"]):
        p = f"encoder.blocks.{i}."
        for j, dil in enumerate((1, 3, 9)):
            x = _residual(sd, p + f"res{j + 1}.", x, dil)
        x = _conv(sd, p + "down", _snake(x, sd[p + "snake.alpha"]), stride=s,
                  padding=math.ceil(s / 2))
    z = _conv(sd, "encoder.conv_out", _snake(x, sd["encoder.snake_out.alpha"]),
              padding=1).transpose(1, 2)  # [B, T, latent]
    codes = []
    for k in range(w["K"]):
        z_e = z @ sd["quantizer.in_proj_w"][k].float() + sd["quantizer.in_proj_b"][k].float()
        cb = sd["quantizer.codebooks"][k].float()
        sim = F.normalize(z_e, dim=-1, eps=1e-8) @ F.normalize(cb, dim=-1, eps=1e-8).t()
        idx = sim.argmax(-1)
        z = z - (cb[idx] @ sd["quantizer.out_proj_w"][k].float()
                 + sd["quantizer.out_proj_b"][k].float())
        codes.append(idx)
    return torch.stack(codes, 1)
