"""Learning-rate schedules as plain functions of the optimizer step.

Counterpart of ``vaura_tpu/ops/schedules.py``: each factory returns
``schedule(step) -> lr`` (a Python float for an integer step), read by the
optimizer at its own step count before the update. The ``*LRScheduler``
classes hold a reference-style config's parameters; ``build(base_lr)``
returns the schedule.

The inverse-sqrt and warmup-to-static schedules index their formulas at
``step + 1``: they reproduce the sequence a torch ``_LRScheduler`` realises
(it steps once at construction, so the optimizer never sees the zero
learning rate of warmup step 0), as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

Schedule = Callable[[int], float]


def inverse_sqrt_schedule(base_lr: float, warmup_steps: int,
                          warmup_init_lr: Optional[float] = 0.0) -> Schedule:
    """Linear warmup, then ``base_lr * sqrt(warmup_steps / step)``."""
    warmup_init = warmup_init_lr or 0.0

    def schedule(step) -> float:
        s = float(step) + 1.0
        if s < warmup_steps:
            return warmup_init + s * (base_lr - warmup_init) / max(warmup_steps, 1)
        return base_lr * (warmup_steps ** 0.5) * max(s, 1.0) ** -0.5

    return schedule


def warmup_to_static_schedule(base_lr: float, warmup_steps: int,
                              warmup_init_lr: Optional[float] = 0.0
                              ) -> Schedule:
    """Linear warmup, then constant."""
    warmup_init = warmup_init_lr or 0.0

    def schedule(step) -> float:
        s = float(step) + 1.0
        if s < warmup_steps:
            return warmup_init + s * (base_lr - warmup_init) / max(warmup_steps, 1)
        return base_lr

    return schedule


def cosine_schedule(base_lr: float, total_steps: int, warmup_steps: int,
                    lr_min_ratio: float = 0.0, cycle_length: float = 1.0
                    ) -> Schedule:
    """Linear warmup, then cosine decay to ``lr_min_ratio * base_lr``."""
    if warmup_steps < 0 or total_steps < 0:
        raise ValueError("warmup_steps and total_steps must be >= 0")

    def schedule(step) -> float:
        s = float(step)
        if s < warmup_steps:
            ratio = s / max(warmup_steps, 1)
        elif s <= total_steps:
            frac = (s - warmup_steps) / max(total_steps - warmup_steps, 1)
            ratio = lr_min_ratio + 0.5 * (1 - lr_min_ratio) * (
                1.0 + math.cos(math.pi * frac / cycle_length))
        else:
            ratio = lr_min_ratio
        return base_lr * ratio

    return schedule


class _ScheduleSpec:
    """Schedule parameters from a config; ``build(base_lr)`` returns the
    schedule."""

    def build(self, base_lr: float) -> Schedule:
        raise NotImplementedError

    def __call__(self, step):
        raise TypeError(
            "Schedule specs must be built with .build(base_lr) before use")


class InverseSquareRootLRScheduler(_ScheduleSpec):
    def __init__(self, warmup_steps: int, warmup_init_lr: float = 0.0,
                 **_ignored):
        self.warmup_steps = warmup_steps
        self.warmup_init_lr = warmup_init_lr

    def build(self, base_lr: float) -> Schedule:
        return inverse_sqrt_schedule(base_lr, self.warmup_steps,
                                     self.warmup_init_lr)


class WarmUpToStaticLRScheduler(_ScheduleSpec):
    def __init__(self, warmup_steps: int, warmup_init_lr: float = 0.0,
                 **_ignored):
        self.warmup_steps = warmup_steps
        self.warmup_init_lr = warmup_init_lr

    def build(self, base_lr: float) -> Schedule:
        return warmup_to_static_schedule(base_lr, self.warmup_steps,
                                         self.warmup_init_lr)


class CosineLRScheduler(_ScheduleSpec):
    def __init__(self, total_steps: int, warmup_steps: int,
                 lr_min_ratio: float = 0.0, cycle_length: float = 1.0,
                 **_ignored):
        self.total_steps = total_steps
        self.warmup_steps = warmup_steps
        self.lr_min_ratio = lr_min_ratio
        self.cycle_length = cycle_length

    def build(self, base_lr: float) -> Schedule:
        return cosine_schedule(base_lr, self.total_steps, self.warmup_steps,
                               self.lr_min_ratio, self.cycle_length)
