"""Codebook interleave patterns: ``Pattern`` and the five providers
(delayed, parallel, unrolled, VALL-E, MusicLM).

Counterpart of ``vaura_tpu/ops/patterns.py``. The layout is lowered
once on the host (numpy) into static index tables; ``build`` and ``revert``
are then single gathers on the device. The host code is a copy of the JAX
package's, kept here so that this package imports nothing of it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

LayoutCoord = Tuple[int, int]  # (timestep t, codebook q)
PatternLayout = List[List[LayoutCoord]]


@dataclass
class Pattern:
    """A layout over ``timesteps`` steps and ``n_q`` codebooks:
    ``layout[s]`` lists the (t, q) coordinates written at sequence step
    ``s``; ``layout[0]`` is empty (the BOS step)."""

    layout: PatternLayout
    timesteps: int
    n_q: int

    def __post_init__(self):
        assert len(self.layout) > 0
        assert self.layout[0] == []
        self._validate_layout()
        self._build_seq_tables = functools.lru_cache(100)(self._build_seq_tables)
        self._revert_tables = functools.lru_cache(100)(self._revert_tables)

    def _validate_layout(self):
        """No step writes one codebook twice, and each codebook's timesteps
        never go backwards along the sequence."""
        frontier = np.zeros(self.n_q, dtype=np.int64)
        for s, coords in enumerate(self.layout):
            if not coords:
                continue
            qs = [q for _, q in coords]
            assert len(set(qs)) == len(qs), (
                f"Multiple entries for one codebook at step {s}"
            )
            ts = np.array([t for t, _ in coords])
            assert (ts >= frontier[qs]).all(), f"Past timesteps found at step {s}"
            frontier[qs] = ts

    @property
    def num_sequence_steps(self) -> int:
        return len(self.layout) - 1

    @property
    def max_delay(self) -> int:
        max_t = 0
        for seq_coords in self.layout[1:]:
            for t, _ in seq_coords:
                max_t = max(max_t, t + 1)
        return max_t - self.timesteps

    @property
    def valid_layout(self) -> PatternLayout:
        """The layout without its trailing ``max_delay`` steps."""
        return self.layout[:len(self.layout) - self.max_delay]

    def _ref_layout(self, keep_only_valid_steps: bool) -> PatternLayout:
        return self.valid_layout if keep_only_valid_steps else self.layout

    def get_sequence_coords_with_timestep(self, t: int, q: Optional[int] = None):
        assert t <= self.timesteps
        coords = []
        for s, seq_codes in enumerate(self.layout):
            for code in seq_codes:
                if code[0] == t and (q is None or code[1] == q):
                    coords.append((s, code))
        return coords

    def get_steps_with_timestep(self, t: int, q: Optional[int] = None) -> List[int]:
        return [s for s, _ in self.get_sequence_coords_with_timestep(t, q)]

    def get_first_step_with_timesteps(self, t: int, q: Optional[int] = None):
        steps = self.get_steps_with_timestep(t, q)
        return steps[0] if steps else None

    def _build_seq_tables(self, timesteps: int,
                          keep_only_valid_steps: bool = False):
        """Indexes ``[K, S]`` into the flattened codes ``[K*timesteps]``
        plus one trailing special slot; coordinates at or beyond
        ``timesteps`` map to the special slot."""
        K = self.n_q
        assert timesteps <= self.timesteps, (
            "invalid number of timesteps used to build the sequence"
        )
        ref_layout = self._ref_layout(keep_only_valid_steps)
        indexes = np.full((K, len(ref_layout)), K * timesteps, dtype=np.int32)
        mask = np.zeros((K, len(ref_layout)), dtype=bool)
        for s, coords in enumerate(ref_layout):
            for t, q in coords:
                if t < timesteps:
                    indexes[q, s] = t + q * timesteps
                    mask[q, s] = True
        return indexes, mask

    def _revert_tables(self, sequence_steps: int,
                       keep_only_valid_steps: bool = False,
                       is_model_output: bool = False):
        """Indexes ``[K, T]`` into the flattened sequence
        ``[K*sequence_steps]`` plus one trailing special slot. With
        ``is_model_output`` step ``s`` of the sequence holds the prediction
        FOR layout step ``s + 1`` (the BOS step has no prediction made for
        it), so the layout is read from its second step."""
        K, T = self.n_q, self.timesteps
        ref_layout = self._ref_layout(keep_only_valid_steps)
        assert sequence_steps <= len(ref_layout), (
            f"sequence to revert is longer than the pattern: "
            f"{sequence_steps} > {len(ref_layout)}"
        )
        if is_model_output:
            ref_layout = ref_layout[1:]
        indexes = np.full((K, T), K * sequence_steps, dtype=np.int32)
        mask = np.zeros((K, T), dtype=bool)
        for s, coords in enumerate(ref_layout[:sequence_steps]):
            for t, q in coords:
                if t < T:
                    indexes[q, t] = s + q * sequence_steps
                    mask[q, t] = True
        return indexes, mask

    @staticmethod
    def _gather(x: torch.Tensor, np_idx: np.ndarray, special) -> torch.Tensor:
        """Gather along the flattened last two axes ``[..., K, n]`` plus one
        trailing slot filled with ``special``."""
        *lead, K, n = x.shape
        flat = torch.cat(
            [x.reshape(*lead, K * n),
             torch.full((*lead, 1), special, dtype=x.dtype, device=x.device)],
            dim=-1,
        )
        idx = torch.as_tensor(np_idx.reshape(-1), dtype=torch.long,
                              device=x.device)
        return flat.index_select(-1, idx).reshape(*lead, K, -1)

    def build_pattern_sequence(self, z: torch.Tensor, special_token: int,
                               keep_only_valid_steps: bool = False):
        """``[B, K, T]`` codes -> ``([B, K, S]`` sequence, indexes, mask)."""
        B, K, T = z.shape
        assert K == self.n_q, f"codebooks mismatch: {K} != {self.n_q}"
        np_idx, np_mask = self._build_seq_tables(T, keep_only_valid_steps)
        return self._gather(z, np_idx, special_token), np_idx, np_mask

    def revert_pattern_sequence(self, s: torch.Tensor, special_token: int,
                                keep_only_valid_steps: bool = False):
        """``[B, K, S]`` sequence -> ``([B, K, T]`` codes, indexes, mask)."""
        B, K, S = s.shape
        assert K == self.n_q
        np_idx, np_mask = self._revert_tables(S, keep_only_valid_steps, False)
        return self._gather(s, np_idx, special_token), np_idx, np_mask

    def revert_pattern_logits(self, logits: torch.Tensor, special_token: float,
                              keep_only_valid_steps: bool = False):
        """``[B, card, K, S]`` model logits -> ``([B, card, K, T]`` aligned to
        the codes, indexes, mask ``[K, T])``. Keeps the logits of the first
        sequence step (the prediction made from the BOS token) and drops
        the trailing step with no target; slots no step predicts hold
        ``special_token`` (NaN in training)."""
        B, card, K, S = logits.shape
        assert K == self.n_q
        np_idx, np_mask = self._revert_tables(S, keep_only_valid_steps, True)
        return self._gather(logits, np_idx, special_token), np_idx, np_mask


class CodebooksPatternProvider:
    """Base of the providers: ``get_pattern(timesteps)``, cached per
    instance."""

    def __init__(self, n_q: int):
        if n_q <= 0:
            raise ValueError(f"n_q must be positive, got {n_q}")
        self.n_q = n_q
        self.get_pattern = functools.lru_cache(100)(self.get_pattern)

    def get_pattern(self, timesteps: int) -> Pattern:
        raise NotImplementedError


def _non_decreasing(values, n: int, what: str) -> list:
    values = list(values)
    if len(values) != n or sorted(values) != values:
        raise ValueError(f"{what} must be {n} non-decreasing values")
    return values


class DelayedPatternProvider(CodebooksPatternProvider):
    """Delay codebook ``k`` by ``delays[k]`` steps (default ``k``), after
    ``empty_initial`` blank steps and ``flatten_first`` timesteps written
    one coordinate a step."""

    def __init__(self, n_q: int, delays: Optional[Sequence[int]] = None,
                 flatten_first: int = 0, empty_initial: int = 0):
        super().__init__(n_q)
        self.delays = _non_decreasing(
            range(n_q) if delays is None else delays, n_q, "delays")
        self.flatten_first = flatten_first
        self.empty_initial = empty_initial

    def get_pattern(self, timesteps: int) -> Pattern:
        """After the BOS row and ``empty_initial`` blank rows, the first
        ``flatten_first`` timesteps one ``(t, q)`` a row (row-major); then
        row ``r`` of the delayed body carries ``(flatten_first + r -
        delays[q], q)`` for every codebook whose delay has elapsed."""
        ff, n_q = self.flatten_first, self.n_q
        head: PatternLayout = [[]] * (1 + self.empty_initial)
        flat: PatternLayout = [[(t, q)] for t in range(min(timesteps, ff))
                               for q in range(n_q)]
        body: PatternLayout = [
            [(ff + r - d, q) for q, d in enumerate(self.delays) if 0 <= r - d]
            for r in range(timesteps + max(self.delays) - ff)
        ]
        return Pattern(head + flat + body, timesteps=timesteps, n_q=n_q)


class ParallelPatternProvider(DelayedPatternProvider):
    """No delay: all codebooks advance in lockstep."""

    def __init__(self, n_q: int):
        super().__init__(n_q, [0] * n_q)


class UnrolledPatternProvider(CodebooksPatternProvider):
    """Codebooks flattened onto inner steps (``flattening[q]``, default
    each its own), each group of an inner step delayed by its shared
    ``delays[q]`` (default 0)."""

    def __init__(self, n_q: int, flattening: Optional[Sequence[int]] = None,
                 delays: Optional[Sequence[int]] = None):
        super().__init__(n_q)
        flattening = _non_decreasing(
            range(n_q) if flattening is None else flattening, n_q,
            "flattening")
        delays = _non_decreasing([0] * n_q if delays is None else delays,
                                 n_q, "delays")
        self._flattened: dict = {}
        for q, (inner, delay) in enumerate(zip(flattening, delays)):
            grp = self._flattened.setdefault(inner, {"codebooks": [],
                                                     "delay": delay})
            if grp["delay"] != delay:
                raise ValueError("codebooks flattened to the same step must "
                                 "share a delay")
            grp["codebooks"].append(q)
        self.max_delay = max(delays)

    @property
    def _num_inner_steps(self) -> int:
        return max(self._flattened) + 1

    def num_virtual_steps(self, timesteps: int) -> int:
        return timesteps * self._num_inner_steps + 1

    def get_pattern(self, timesteps: int) -> Pattern:
        """Each timestep expands into one row per inner step; an inner
        step's row carries its codebooks, scheduled ``delay`` rows later
        (rows past the horizon dropped), an inner step without codebooks a
        blank row at its own time. Rows merge in schedule order: on ties
        blank rows first, then lower timesteps."""
        horizon = timesteps + self.max_delay
        rows: list = [(-1, [])]  # the BOS row sorts first
        for i in range(self._num_inner_steps):
            grp = self._flattened.get(i)
            if grp is None:
                rows += [(t, []) for t in range(horizon)]
            else:
                rows += [(t + grp["delay"],
                          [(t, q) for q in grp["codebooks"]])
                         for t in range(horizon - grp["delay"])]
        return Pattern([coords for _, coords in sorted(rows)],
                       timesteps=timesteps, n_q=self.n_q)


class VALLEPattern(CodebooksPatternProvider):
    """Codebook 0 alone over every timestep, then the others as one delayed
    block (``delays`` of codebooks 1.., default 0)."""

    def __init__(self, n_q: int, delays: Optional[Sequence[int]] = None):
        super().__init__(n_q)
        self.delays = _non_decreasing(
            [0] * (n_q - 1) if delays is None else delays, n_q - 1, "delays")

    def get_pattern(self, timesteps: int) -> Pattern:
        solo: PatternLayout = [[(t, 0)] for t in range(timesteps)]
        block: PatternLayout = [
            [(r - d, q + 1) for q, d in enumerate(self.delays) if r >= d]
            for r in range(timesteps + max(self.delays, default=0))
        ]
        return Pattern([[]] + solo + block, timesteps=timesteps, n_q=self.n_q)


class MusicLMPattern(CodebooksPatternProvider):
    """Flattened one coordinate a row, group-major: every timestep of the
    codebooks ``[g, g + group_by)`` before the next group."""

    def __init__(self, n_q: int, group_by: int = 2):
        super().__init__(n_q)
        self.group_by = group_by

    def get_pattern(self, timesteps: int) -> Pattern:
        layout: PatternLayout = [[]] + [
            [(t, q)]
            for g in range(0, self.n_q, self.group_by)
            for t in range(timesteps)
            for q in range(g, g + self.group_by)
        ]
        return Pattern(layout, timesteps=timesteps, n_q=self.n_q)
