"""Host spans at the program's layer boundaries, on the profiler's clock.

``span(name)`` marks a block of host code: an encoder slice
(``encoder.chunk``), a decode step and its parts (``decode_step``,
``decode_step.forward``, ``decode_step.sample``), a codec slice
(``dac.slice``), the parts of a training step (``train.*``). Off, the
default, it reads one module flag and returns one shared object that does
nothing: no ``record_function``, no CUDA event, no synchronisation, no
allocation. Inside ``recording()`` it appends ``(name, depth, start_ns,
end_ns)`` as it closes, ``depth`` the number of spans open around it: two
reads of the host clock and one append. ``StageClock.mark`` adds the
stages between its marks (``encoder``, ``decode_loop``, ``dac``) as spans
under the names of the marks that end them (``stage_edge``).

Names are given whole, a child's under its parent's as a prefix
(``decode_step.sample`` inside ``decode_step``). The clock is
``time.time_ns``, Unix nanoseconds: the clock that ``torch.profiler``
stamps its host and device events on (kineto's ``start_ns()``), so a span
and a traced launch compare as they are (``tests/test_torch_spans.py``).
The thread that calls the program opens and closes its spans.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, List, Optional, Tuple

Record = Tuple[str, int, int, int]  # (name, depth, start_ns, end_ns)

now_ns = time.time_ns

_records: Optional[List[Record]] = None  # the list being filled, None when off
_depth = 0


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "depth", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _depth
        self.depth = _depth
        _depth += 1
        self.t0 = now_ns()

    def __exit__(self, *exc):
        global _depth
        t1 = now_ns()
        _depth -= 1
        if _records is not None:
            _records.append((self.name, self.depth, self.t0, t1))
        return False


def span(name: str):
    """A context manager over one block of host code, recorded as ``name``
    while ``recording()`` is on."""
    if _records is None:
        return _OFF
    return _Span(name)


def stage_edge(name: str, since: Optional[int]) -> Optional[int]:
    """A boundary between stages: records the stage ``name`` that began at
    ``since`` (the previous boundary, None at the first) and returns this
    boundary's time, which begins the next stage; None when off."""
    if _records is None:
        return None
    t = now_ns()
    if since is not None:
        _records.append((name, _depth, since, t))
    return t


@contextlib.contextmanager
def recording() -> Iterator[List[Record]]:
    """Spans on over the block; yields the list their records fill, in the
    order they close."""
    global _records, _depth
    if _records is not None:
        raise RuntimeError("spans are already being recorded")
    out: List[Record] = []
    _records, _depth = out, 0
    try:
        yield out
    finally:
        _records = None
