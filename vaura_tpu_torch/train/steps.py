"""Train and eval steps over a ``VauraSystem``.

Counterpart of ``vaura_tpu/train/steps.py``: ``train_step`` (loss, gradients
of the trainable leaves, optimizer update) and ``eval_step`` (teacher-forced
loss without dropout). The codec is always frozen; the visual encoder
follows ``freeze_feature_extractor``. Where the JAX package passes the
frozen subtrees beside the state, here the system holds every tensor and
the state names the trainable ones.

Under a mesh (``parallel.shard_module``) each rank steps on its rows of the
batch (``batch_to_device(..., mesh=)``): its loss is its rows' share of the
global loss, ``backward`` lets FSDP2 sum the gradients over the batch's
shards (its hooks read ``.grad``), the LoRA adapters' gradients, which
FSDP2 does not hold, are summed over the mesh
(``MeshPlacement.sum_replicated_grads``), and the metrics are the whole
batch's.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from vaura_tpu_torch.models.vaura import VauraSystem
from vaura_tpu_torch.train.state import TrainState, replicated_leaves
from vaura_tpu_torch.utils.spans import span


def split_params(system: VauraSystem
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``(trainable, frozen)`` partition of ``system.named_parameters()``:
    the sampler and the bridge train, the codec never does, the encoder
    follows ``freeze_feature_extractor``. With LoRA adapters the adapters
    train in the sampler's place, and the base sampler is frozen (merged
    with them at each entry call). Sets ``requires_grad`` of every leaf to
    match."""
    trainable, frozen = {}, {}
    sampler = "sampler" if system.lora_sampler is None else "lora_sampler"
    for name, p in system.named_parameters():
        top = name.split(".", 1)[0]
        train = top in (sampler, "bridge") or (
            top == "encoder" and not system.freeze_feature_extractor)
        p.requires_grad_(train)
        (trainable if train else frozen)[name] = p
    return trainable, frozen


def array_batch(batch: dict) -> dict:
    """The array leaves the step functions consume."""
    return {k: batch[k] for k in ("frames", "audio", "codes", "vis_feats")
            if k in batch}


def batch_to_device(batch: dict, device, non_blocking: bool = False,
                    mesh=None) -> dict:
    """Move the array leaves of a host batch (numeric numpy arrays and
    tensors, also inside nested dicts) onto ``device``; meta leaves
    (strings, lists) are kept. ``non_blocking`` onto a CUDA device copies
    from pinned host memory without waiting, on the current stream, which
    the steps that read the batch follow. Under a ``mesh`` only this rank's
    rows move (``parallel.mesh.shard_batch``)."""
    if mesh is not None:
        from vaura_tpu_torch.parallel.mesh import shard_batch

        batch = shard_batch(mesh, batch)
    pin = non_blocking and torch.device(device).type == "cuda"

    def put(x):
        if isinstance(x, np.ndarray) and np.issubdtype(x.dtype, np.number):
            x = torch.from_numpy(x)
        if isinstance(x, torch.Tensor):
            if pin and not x.is_cuda:
                x = x.pin_memory()
            return x.to(device, non_blocking=pin)
        return x

    return {k: batch_to_device(v, device, non_blocking)
            if isinstance(v, dict) else put(v) for k, v in batch.items()}


def prefetch_to_device(iterator, size: int = 2, device=None, mesh=None):
    """Double-buffer host batches onto ``device`` (the JAX package's
    ``prefetch_to_device``): up to ``size`` batches are in flight, so the
    host issues batch N+1's copy (``batch_to_device`` with
    ``non_blocking``) before step N and does not wait for it. Yields device
    batches (this rank's rows under a ``mesh``)."""
    import collections

    queue = collections.deque()
    for batch in iterator:
        queue.append(batch_to_device(batch, device, non_blocking=True,
                                     mesh=mesh))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def make_train_step(system: VauraSystem) -> Callable:
    """Returns ``train_step(state, batch, generator=None, clock=None) ->
    (state, metrics)``. ``batch`` holds ``frames`` (or visual features
    ``vis_feats``) and ``audio`` (or ``codes``); the dropout masks come from
    ``generator``. The parameters
    in ``state`` are updated in place. ``clock.mark(name)``, when given, is
    called after the forward, the backward and the optimizer. Spans
    (``utils.spans``): ``train.codec_encode``, ``train.encoder``,
    ``train.sampler`` and ``train.loss`` in the forward
    (``VauraSystem.train_forward``), then ``train.backward`` and
    ``train.optimizer``."""

    def train_step(state: TrainState, batch: dict,
                   generator: Optional[torch.Generator] = None, clock=None):
        batch = array_batch(batch)
        mark = clock.mark if clock is not None else (lambda name: None)
        loss, aux = system.train_forward(
            batch.get("frames"), batch.get("audio"), generator, train=True,
            vis_feats=batch.get("vis_feats"), codes=batch.get("codes"))
        mark("forward")
        with span("train.backward"):
            names = list(state.params)
            pl = system.placement
            if pl is None:
                grads = torch.autograd.grad(
                    loss, [state.params[k] for k in names], allow_unused=True)
            else:  # FSDP2 sums the shards' gradients into .grad
                loss.backward()
                grads = [state.params[k].grad for k in names]
            # a leaf the loss does not reach has a zero gradient (and still
            # decays), as in the JAX package
            grads = {k: torch.zeros_like(state.params[k]) if g is None else g
                     for k, g in zip(names, grads)}
            if pl is not None:  # the LoRA adapters, outside FSDP2
                rep = sorted(replicated_leaves(state.params))
                pl.sum_replicated_grads(rep, [grads[k] for k in rep])
        mark("backward")
        with span("train.optimizer"):
            state = state.apply_gradients(grads)
            if system.placement is not None:
                for p in state.params.values():
                    p.grad = None
        mark("optimizer")
        return state, {
            "loss": system.batch_total(loss.detach()),
            "loss_per_codebook": system.batch_total(
                aux["loss_per_codebook"].detach())}

    return train_step


def make_eval_step(system: VauraSystem) -> Callable:
    """Returns ``eval_step(batch) -> metrics``: the teacher-forced loss with
    ``train=False`` (no dropout; the encoder's fused sublayers) and no
    graph."""

    @torch.no_grad()
    def eval_step(batch: dict):
        batch = array_batch(batch)
        loss, aux = system.train_forward(
            batch.get("frames"), batch.get("audio"), None, train=False,
            vis_feats=batch.get("vis_feats"), codes=batch.get("codes"))
        return {"loss": system.batch_total(loss),
                "loss_per_codebook": system.batch_total(
                    aux["loss_per_codebook"])}

    return eval_step
