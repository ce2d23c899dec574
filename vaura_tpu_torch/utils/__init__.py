"""Device resolution, stage timing, seeded random initialisation and the
config helpers of the spec functions."""

from __future__ import annotations

import math
import time
from typing import Dict, Union

import torch
from torch import nn

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when no device was named and CUDA is absent, so a run
    never falls back to the CPU without being asked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


class StageClock:
    """Milliseconds between successive ``mark(name)`` calls, each interval
    under the name of the mark that ends it: CUDA events on the card (read
    once, after the last mark), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self, name: str):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def ms(self) -> Dict[str, float]:
        if self.cuda and self.marks:
            self.marks[-1][1].synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
        return out


_EMBEDDINGS = ("emb", "cls_token", "pos_embed", "temp_embed",
               "empty_video_emb")
# fan-in of tensors whose input axis is not everything after the first
_FAN_IN = {"proj_v": lambda s: s[-1], "out_proj_w": lambda s: s[1]}


@torch.no_grad()
def seeded_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of ``module`` from ``generator``, on the
    parameter's own device: biases zero; norm weights and scales, Snake
    alphas and weight-norm gains one; embedding and positional tables and
    LoRA's ``lora_a`` ``N(0, 0.02)`` (its ``lora_b`` zero, as a ``_b``
    leaf); codebooks ``N(0, 1)``; every other matrix or
    kernel ``N(0, 1/fan_in)`` with the fan-in over all axes but the first
    (torch's ``[out, in, ...]`` layout)."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias" or leaf.endswith("_b"):
            p.zero_()
            continue
        if leaf == "proj_g" or (p.ndim == 1 and leaf in ("weight", "scale",
                                                          "alpha")):
            p.fill_(1.0)
            continue
        if leaf in _EMBEDDINGS or leaf == "lora_a" or p.ndim == 1:
            std = 0.02
        elif leaf == "codebooks":
            std = 1.0
        else:
            std = _FAN_IN.get(leaf, lambda s: math.prod(s[1:]))(p.shape) ** -0.5
        tmp = torch.empty(p.shape, dtype=torch.float32, device=p.device)
        tmp.normal_(0.0, std, generator=generator)
        p.copy_(tmp)
    return module


ANY = object()  # a field value the port accepts whatever it is


def drop_unported_fields(kwargs: dict, fields: dict, what: str) -> dict:
    """``kwargs`` without the JAX-only config ``fields`` (name -> the one
    value the port's behaviour equals, or ``ANY``). A value that asks for
    behaviour the port does not have raises ``NotImplementedError``."""
    out = {}
    for k, v in kwargs.items():
        if k not in fields:
            out[k] = v
        elif fields[k] is not ANY and v != fields[k]:
            raise NotImplementedError(
                f"{what} {k}={v!r} is not ported (ROADMAP.md, 'Modules to "
                "port', item 'Everything else')")
    return out
