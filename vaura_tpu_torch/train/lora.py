"""LoRA adapters on the sampler's dense layers.

Counterpart of ``vaura_tpu/train/lora.py``. The adapters are a module of
their own (``VauraSystem.lora_sampler``) beside the sampler, whose weights
and names stay as they are: one ``LoraPair`` per adapted ``PDense``, at the
PDense's own name (``layers.3.attention.wqkv.lora_a``), where the JAX
package stacks the layers' adapters on a leading axis.

Orientation: a ``PDense`` weight is ``[out, in]`` (JAX's kernel is ``[in,
out]``), so ``lora_a`` is ``[r, in]`` and ``lora_b`` ``[out, r]`` (JAX's
``a [in, r]`` and ``b [r, out]`` transposed), and the merged weight is ``W +
(alpha / r) * lora_b @ lora_a``. Standard initialisation (Hu et al. 2021):
``lora_a`` Gaussian times ``init_std``, ``lora_b`` zero, so the merged model
equals the base model at step 0.

``merge_lora`` returns the merged weights; ``VauraSystem.lora_merged``
installs them on the sampler's ``PDense`` layers for one generation call,
so a decode loop reads them without recomputing the products at each
step. A call that records a graph, or whose weights are FSDP2 shards,
gets each layer's ``merged_weight`` as its ``adapter`` instead: the layer
merges at each use, from the weight its module holds then (under FSDP2 the
block's gathered weight), and gradients reach the adapters through it.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from vaura_tpu_torch.models.sampler import PDense

DEFAULT_TARGETS: Tuple[str, ...] = ("wqkv", "wo", "w1", "w2", "w3")
INIT_STD = 0.02


class LoraPair(nn.Module):
    """``lora_a [r, in]`` and ``lora_b [out, r]`` of one dense layer."""

    def __init__(self, d_in: int, d_out: int, rank: int, device=None):
        super().__init__()
        self.lora_a = nn.Parameter(torch.zeros(rank, d_in, device=device))
        self.lora_b = nn.Parameter(torch.zeros(d_out, rank, device=device))


def lora_target_paths(sampler: nn.Module, targets: Sequence[str]
                      ) -> Dict[str, PDense]:
    """``{name: PDense}`` of the sampler's dense layers LoRA attaches to:
    those whose own name is in ``targets`` (``layers.0.attention.wqkv``, or
    ``lm_head`` if listed), as the JAX package selects a ``kernel`` by its
    parent module's name."""
    return {name: m for name, m in sampler.named_modules()
            if isinstance(m, PDense) and name.rsplit(".", 1)[-1] in targets}


def init_lora(sampler: nn.Module, rank: int,
              targets: Sequence[str] = DEFAULT_TARGETS,
              init_std: float = INIT_STD,
              generator: Optional[torch.Generator] = None) -> nn.Module:
    """A module of ``LoraPair``s at the names of the selected layers (nested
    as the sampler's modules are): ``lora_a`` drawn from ``generator`` times
    ``init_std``, ``lora_b`` zero, float32, on the sampler's device."""
    assert rank > 0
    sel = lora_target_paths(sampler, targets)
    assert sel, f"no LoRA targets matched {tuple(targets)!r}"
    root = nn.Module()
    for name, dense in sorted(sel.items()):
        w = dense.weight
        pair = LoraPair(w.shape[1], w.shape[0], rank, w.device)
        with torch.no_grad():
            pair.lora_a.normal_(0.0, init_std, generator=generator)
        *parents, leaf = name.split(".")
        node = root
        for part in parents:
            if not hasattr(node, part):
                node.add_module(part, nn.Module())
            node = getattr(node, part)
        node.add_module(leaf, pair)
    return root


def lora_pairs(lora: nn.Module) -> Dict[str, LoraPair]:
    """``{name of the adapted layer: LoraPair}``."""
    return {name: m for name, m in lora.named_modules()
            if isinstance(m, LoraPair)}


def merged_weight(W: torch.Tensor, pair: LoraPair, alpha: Optional[float],
                  cut: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                  ) -> torch.Tensor:
    """``W + (alpha / r) * lora_b @ lora_a`` in ``W``'s dtype; ``alpha``
    defaults to the rank (scale 1). ``cut(delta)``, when given, takes the
    part of the whole delta that ``W`` holds (a rank's rows or columns
    under a model axis)."""
    rank = pair.lora_a.shape[0]
    scale = (alpha if alpha is not None else float(rank)) / float(rank)
    delta = (pair.lora_b @ pair.lora_a) * scale
    if cut is not None:
        delta = cut(delta)
    return W + delta.to(W.dtype)


def adapted_layers(sampler: nn.Module, lora: nn.Module
                   ) -> Dict[str, Tuple[PDense, LoraPair]]:
    """``{name: (PDense, LoraPair)}`` of every adapted layer of
    ``sampler``. Raises ``ValueError`` on an int8 layer: the adapters
    cannot be merged into int8 weights."""
    out = {}
    for name, pair in lora_pairs(lora).items():
        dense = sampler.get_submodule(name)
        if dense.quantized:
            raise ValueError(
                f"LoRA adapters cannot be merged into int8 weights ({name}): "
                "generate without quantize, or merge the adapters into the "
                "float weights before quantizing")
        out[name] = (dense, pair)
    return out


def merge_lora(sampler: nn.Module, lora: nn.Module,
               alpha: Optional[float] = None,
               cut: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
    """``{name: merged_weight(W, ...)}`` for every adapted layer of
    ``sampler`` (``adapted_layers``); ``cut(name, delta)`` as
    ``merged_weight``'s, given the layer's name."""
    return {name: merged_weight(
                dense.weight, pair, alpha,
                None if cut is None else functools.partial(cut, name))
            for name, (dense, pair) in adapted_layers(sampler, lora).items()}


def count_lora_params(lora: nn.Module) -> int:
    return sum(p.numel() for p in lora.parameters())
