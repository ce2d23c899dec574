"""Train state and optimizer.

Counterpart of ``vaura_tpu/train/state.py``: AdamW where leaves of rank >= 2
receive weight decay and leaves of rank < 2 (biases, norms) do not; gradient
clipping by value or by global norm; a learning-rate schedule read at the
optimizer's own step count; gradient accumulation. Leaves named in
``FROZEN_LEAF_NAMES`` (the CFG ``uncond_embedding``) ride among the
trainable parameters and get zero updates.

The update reproduces ``optax``'s, which differs from ``torch.optim.AdamW``:
the decay term ``weight_decay * p`` is added to the Adam direction and the
sum is scaled by the learning rate; epsilon (1e-8) is added outside the
square root; both moments are bias-corrected; clipping is applied to each
gradient before Adam; with accumulation the running mean of k
micro-gradients is clipped and applied on every k-th call, the other calls
change nothing but the mean.

**Rank is taken as the JAX package sees it.** There the per-layer leaves of
the sampler's ``layers`` and the encoder's ``blocks`` are stacked on a
leading axis, so a block's norm weight ``[L, d]`` or bias ``[L, d]`` has
rank 2 and IS decayed. This package keeps one tensor per layer, one rank
lower, and labels such a leaf by its rank plus one, to compute what the JAX
package computes.

Parameters are updated in place (JAX returns new trees): the state holds
the system's own tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import torch

from vaura_tpu_torch.ops import schedules

FROZEN_LEAF_NAMES = ("uncond_embedding",)
# per-layer module lists that the JAX package stacks on a leading axis
STACKED_PREFIXES = ("sampler.layers.", "encoder.blocks.")

Params = Mapping[str, torch.Tensor]
LearningRate = Union[float, Callable[[int], float]]


def param_labels(params: Params) -> Dict[str, str]:
    """``decay`` (rank >= 2 as the JAX package counts it, see the module
    docstring), ``nodecay`` (biases, norms) or ``frozen`` for each leaf,
    keyed by the leaf's name in ``VauraSystem.named_parameters()``."""
    out = {}
    for name, p in params.items():
        rank = p.ndim + (1 if name.startswith(STACKED_PREFIXES) else 0)
        if name.rsplit(".", 1)[-1] in FROZEN_LEAF_NAMES:
            out[name] = "frozen"
        else:
            out[name] = "decay" if rank >= 2 else "nodecay"
    return out


def decay_mask(params: Params) -> Dict[str, bool]:
    return {k: v == "decay" for k, v in param_labels(params).items()}


def trainable_mask(params: Params) -> Dict[str, bool]:
    return {k: v != "frozen" for k, v in param_labels(params).items()}


@torch.no_grad()
def copy_leaves(dst: Dict[str, torch.Tensor], src: Mapping[str, torch.Tensor],
                what: str) -> None:
    """Copy ``src`` into the tensors of ``dst``, in place; the two must hold
    the same names with the same shapes."""
    missing, unexpected = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
    if missing or unexpected:
        raise ValueError(f"{what}: missing {missing[:5]}, unexpected "
                         f"{unexpected[:5]}")
    for k, t in dst.items():
        if tuple(src[k].shape) != tuple(t.shape):
            raise ValueError(f"{what}.{k}: shape {tuple(src[k].shape)}, "
                             f"expected {tuple(t.shape)}")
        t.copy_(src[k])


@dataclasses.dataclass
class OptState:
    count: int                      # updates applied (the schedule's step)
    mini_step: int                  # micro-gradients in the running mean
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    acc: Dict[str, torch.Tensor]    # running mean (accumulation only)

    def state_dict(self) -> dict:
        """``count``, ``mini_step`` and the ``mu`` / ``nu`` / ``acc`` leaves
        by name (the state's own tensors)."""
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": dict(self.mu), "nu": dict(self.nu), "acc": dict(self.acc)}

    def load_state_dict(self, sd: Mapping) -> None:
        """Copy ``state_dict()``'s layout into this state, in place; every
        leaf name and shape must match (``ValueError``)."""
        for key in ("mu", "nu", "acc"):
            copy_leaves(getattr(self, key), sd[key], f"opt_state.{key}")
        self.count, self.mini_step = int(sd["count"]), int(sd["mini_step"])


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """What ``make_optimizer`` returns: ``init(params)`` makes the state,
    ``update(grads, state, params)`` applies one call's gradients in
    place."""

    learning_rate: LearningRate
    weight_decay: float = 0.0
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    gradient_clip_val: Optional[float] = 1.0
    gradient_clip_algorithm: str = "value"
    accumulate_grad_batches: int = 1

    def init(self, params: Params) -> OptState:
        live = [k for k, v in param_labels(params).items() if v != "frozen"]
        zeros = lambda keys: {k: torch.zeros_like(params[k]) for k in keys}
        acc = zeros(params) if self.accumulate_grad_batches > 1 else {}
        return OptState(0, 0, zeros(live), zeros(live), acc)

    def lr_at(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: OptState,
               params: Params) -> None:
        names = list(params)
        g = [grads[k] for k in names]
        k_acc = self.accumulate_grad_batches
        if k_acc > 1:
            # running mean of the micro-gradients
            acc = [state.acc[k] for k in names]
            diff = torch._foreach_sub(g, acc)
            torch._foreach_add_(acc, diff, alpha=1.0 / (state.mini_step + 1))
            if state.mini_step < k_acc - 1:
                state.mini_step += 1
                return
            g = [a.clone() for a in acc]
            torch._foreach_zero_(acc)
            state.mini_step = 0
        clip = self.gradient_clip_val
        if clip is not None and clip > 0:
            if self.gradient_clip_algorithm == "value":
                g = torch._foreach_clamp_min(g, -clip)
                torch._foreach_clamp_max_(g, clip)
            elif self.gradient_clip_algorithm == "norm":
                norm = torch.linalg.vector_norm(
                    torch.stack(torch._foreach_norm(g)))
                scale = torch.where(norm < clip, torch.ones_like(norm),
                                    clip / norm)
                g = torch._foreach_mul(g, scale)
            else:
                raise ValueError(self.gradient_clip_algorithm)
        lr = self.lr_at(state.count)
        state.count += 1
        b1, b2 = self.betas
        bc1, bc2 = 1.0 - b1 ** state.count, 1.0 - b2 ** state.count
        grad_of = dict(zip(names, g))
        labels = param_labels(params)
        for label, wd in (("decay", self.weight_decay), ("nodecay", 0.0)):
            keys = [k for k in names if labels[k] == label]
            if not keys:
                continue
            p = [params[k] for k in keys]
            gk = [grad_of[k] for k in keys]
            mu = [state.mu[k] for k in keys]
            nu = [state.nu[k] for k in keys]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, gk, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, gk, gk, value=1.0 - b2)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            step = torch._foreach_div(mu, bc1)
            torch._foreach_div_(step, denom)
            if wd:
                torch._foreach_add_(step, p, alpha=wd)
            torch._foreach_add_(p, step, alpha=-lr)


def make_optimizer(
    learning_rate: LearningRate,
    weight_decay: float = 0.0,
    betas: Tuple[float, float] = (0.9, 0.95),
    gradient_clip_val: Optional[float] = 1.0,
    gradient_clip_algorithm: str = "value",
    accumulate_grad_batches: int = 1,
    mu_dtype: Optional[str] = None,
    nu_dtype: Optional[str] = None,
) -> Optimizer:
    """AdamW with per-rank decay, value or global-norm clipping, frozen
    leaves and gradient accumulation. The moments are kept in the
    parameters' dtype: ``mu_dtype`` / ``nu_dtype`` (reduced-precision
    moments) are not ported."""
    if mu_dtype is not None or nu_dtype is not None:
        raise NotImplementedError(
            "reduced-precision Adam moments (mu_dtype, nu_dtype) are not "
            "ported yet")
    if gradient_clip_algorithm not in ("value", "norm"):
        raise ValueError(gradient_clip_algorithm)
    return Optimizer(learning_rate, weight_decay, tuple(betas), 1e-8,
                     gradient_clip_val, gradient_clip_algorithm,
                     max(int(accumulate_grad_batches or 1), 1))


@dataclasses.dataclass
class TrainState:
    """Step count, the trainable leaves (the system's own tensors, by
    name) and the optimizer's state."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: OptState
    tx: Optimizer

    @classmethod
    def create(cls, params: Params, tx: Optimizer) -> "TrainState":
        params = dict(params)
        return cls(0, params, tx.init(params), tx)

    def state_dict(self) -> dict:
        """``{"params", "opt_state", "step"}``: what a checkpoint holds."""
        return {"params": dict(self.params),
                "opt_state": self.opt_state.state_dict(), "step": self.step}

    def load_state_dict(self, sd: Mapping) -> None:
        """Copy a ``state_dict()`` into the parameters and the optimizer's
        state, in place (``tx`` is the caller's, rebuilt from the config)."""
        copy_leaves(self.params, sd["params"], "params")
        self.opt_state.load_state_dict(sd["opt_state"])
        self.step = int(sd["step"])

    def apply_gradients(self, grads: Mapping[str, torch.Tensor]
                        ) -> "TrainState":
        """One optimizer call on the parameters, in place."""
        self.tx.update(grads, self.opt_state, self.params)
        self.step += 1
        return self


_SCHEDULERS = {
    cls.__name__: cls
    for cls in (schedules.InverseSquareRootLRScheduler,
                schedules.WarmUpToStaticLRScheduler,
                schedules.CosineLRScheduler)
}


def build_schedule(lr_scheduler_cfg: Optional[dict], base_lr: float
                   ) -> LearningRate:
    """A reference-style ``{"target": "...<Name>LRScheduler", "params":
    {...}}`` block -> a schedule (or the constant base rate for None). The
    target is resolved by its class name among ``ops.schedules``."""
    if lr_scheduler_cfg is None:
        return base_lr
    name = str(lr_scheduler_cfg["target"]).rsplit(".", 1)[-1]
    if name not in _SCHEDULERS:
        raise ValueError(f"unknown lr scheduler {lr_scheduler_cfg['target']!r}"
                         f"; known: {sorted(_SCHEDULERS)}")
    spec = _SCHEDULERS[name](**dict(lr_scheduler_cfg.get("params") or {}))
    return spec.build(base_lr)
