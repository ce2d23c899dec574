"""Weights and inputs made from the run's seed, on the device.

The parameter tables are the reference's (``reference.*.param_specs``):
names, shapes and an init rule each. ``make`` draws them in one normal
draw per storage dtype into one flat buffer, ordered so that each scale is
one contiguous slice, and returns views of it by name. The program gets
them through ``load_state_dict`` (strict: a name or shape that differs
from the reference's raises); the reference reads the same tensors.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], str]


def stream(seed: int, k: int) -> int:
    """The seed of sub-stream ``k`` of the run's ``seed`` (weights,
    inputs, each call's sampling)."""
    return (int(seed) * 1000003 + 7919 * k) % (2 ** 63 - 1)


def generator(device, seed: int, k: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream(seed, k))


def init_std(init: str, shape) -> float:
    """The standard deviation of a normal init rule (see the reference's
    ``param_specs``)."""
    fan = math.prod(shape[1:]) if len(shape) > 1 else shape[0]
    return {"emb": 0.02, "unit": 1.0, "fan_in": fan ** -0.5,
            "axis1": shape[1] ** -0.5 if len(shape) > 1 else 1.0,
            "conv_t": (2 * shape[0]) ** -0.5,
            "out": 0.003 * fan ** -0.5}[init]


@torch.no_grad()
def make(specs: List[Spec], dtypes: Dict[str, torch.dtype],
         gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Tensors for ``specs`` in the storage dtype ``dtypes[name]``: zeros,
    ones, or normal draws scaled by ``init_std``."""
    out: Dict[str, torch.Tensor] = {}
    for dtype in sorted({dtypes[n] for n, _, _ in specs}, key=str):
        group = [(n, s, i) for n, s, i in specs if dtypes[n] == dtype]
        key = lambda x: (x[2] in ("zeros", "ones"), x[2],
                         0.0 if x[2] in ("zeros", "ones") else init_std(x[2], x[1]))
        group.sort(key=key)
        sizes = [math.prod(s) for _, s, _ in group]
        flat = torch.empty(sum(sizes), dtype=dtype, device=device)
        n_normal = sum(z for z, (_, _, i) in zip(sizes, group)
                       if i not in ("zeros", "ones"))
        flat[:n_normal].normal_(0.0, 1.0, generator=gen)
        off, run = 0, None  # run: (start, scale) of the current scale slice
        for (name, shape, init), size in zip(group, sizes):
            view = flat[off:off + size]
            if init == "zeros":
                view.zero_()
            elif init == "ones":
                view.fill_(1.0)
            else:
                std = init_std(init, shape)
                if run is None or run[1] != std:
                    if run is not None:
                        flat[run[0]:off].mul_(run[1])
                    run = (off, std)
            out[name] = view.view(shape)
            off += size
        if run is not None:
            flat[run[0]:n_normal].mul_(run[1])
    return out


def storage_dtypes(module: torch.nn.Module, prefix: str = ""
                   ) -> Dict[str, torch.dtype]:
    """The dtype each parameter of ``module`` is served in, by name (with
    ``prefix`` taken off)."""
    return {k[len(prefix):]: v.dtype for k, v in module.state_dict().items()
            if k.startswith(prefix)}
