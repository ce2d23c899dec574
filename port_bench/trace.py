"""The traced call: ``torch.profiler`` over one whole call or step, with the
CUDA activity only (CUPTI's kernel and runtime records: recording every
host operator as well slowed a generation call five-fold on the host),
read in memory from the profiler's raw kineto events; no trace file is
written.

Stage boundaries come from the host's ``cudaEventRecord`` calls: the
program's own ``StageClock`` marks in ``VauraSystem.generate`` (start,
encoder, decode loop, DAC), or the benchmark's clock around a training
step (start, forward, backward, optimizer). ``summarise`` reduces the
events to what the per-layer readers take: the union of the kernel
intervals (busy time), kernel time by name, the host's kernel launches in
each stage, and the longest idle gaps of the device with the stage and the
runtime call the host was in then.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Tuple

import numpy as np

# host-side CUDA runtime and driver calls that launch a kernel, and those
# that record an event (by the start of their names)
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel")
MARK_CALLS = ("cudaEventRecord", "cuEventRecord")


@contextlib.contextmanager
def profiled(device):
    """The profiler over the block: the CUDA activity only on a card (the
    CPU's operators where there is none, as in the tests)."""
    from torch.profiler import ProfilerActivity, profile

    act = ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU
    with profile(activities=[act]) as prof:
        yield prof


def union_ns(intervals: np.ndarray) -> Tuple[int, np.ndarray]:
    """``(covered ns, merged [n, 2] intervals)`` of ``[n, 2]`` start/end
    pairs."""
    if len(intervals) == 0:
        return 0, np.zeros((0, 2), dtype=np.int64)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    group = np.cumsum(new) - 1
    merged_end = np.zeros(int(new.sum()), dtype=np.int64)
    np.maximum.at(merged_end, group, iv[:, 1])
    merged = np.stack([iv[new, 0], merged_end], 1)
    return int((merged[:, 1] - merged[:, 0]).sum()), merged


def summarise(prof, stages: List[str], wall_s: float) -> dict:
    """Reduce the profiler's events of one traced call (``wall_s`` its
    length on the host clock). ``stages`` names the intervals between
    successive ``cudaEventRecord`` calls of the call."""
    kernels, kn = [], []
    host, hn = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CUDA":
            kernels.append((e.start_ns(), e.end_ns()))
            kn.append(e.name())
        else:
            host.append((e.start_ns(), e.end_ns()))
            hn.append(e.name())
    k = np.asarray(kernels, dtype=np.int64).reshape(-1, 2)
    h = np.asarray(host, dtype=np.int64).reshape(-1, 2)
    hn_arr = np.asarray(hn, dtype=object)
    busy_ns, merged = union_ns(k)
    by_name: Dict[str, List[float]] = {}
    for (a, b), n in zip(kernels, kn):
        d = by_name.setdefault(n, [0, 0.0])
        d[0] += 1
        d[1] += (b - a) * 1e-9
    names = sorted(set(hn))
    launch_names = [n for n in names if n.startswith(LAUNCH_CALLS)]
    mark_names = [n for n in names if n.startswith(MARK_CALLS)]
    is_launch = np.isin(hn_arr, launch_names) if len(hn) else np.zeros(0, bool)
    is_mark = np.isin(hn_arr, mark_names) if len(hn) else np.zeros(0, bool)
    marks = np.sort(h[is_mark, 0]) if len(hn) else np.zeros(0)
    spans = {}
    if len(marks) == len(stages) + 1:
        for name, a, b in zip(stages, marks[:-1], marks[1:]):
            inside = (h[:, 0] >= a) & (h[:, 0] < b)
            spans[name] = {"host_s": (b - a) * 1e-9,
                           "launches": int((inside & is_launch).sum())}
    gaps = []
    if len(merged) > 1:
        g = np.stack([merged[:-1, 1], merged[1:, 0]], 1)
        for i in np.argsort(g[:, 0] - g[:, 1], kind="stable")[:10]:
            a, b = int(g[i, 0]), int(g[i, 1])
            gaps.append([_host_label(h, hn_arr, marks, stages, a), (b - a) * 1e-9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {"wall_s": wall_s, "busy_s": busy_ns * 1e-9, "kernels": by_name,
            "n_kernels": len(kernels), "n_launch_calls": int(is_launch.sum()),
            "n_marks": int(len(marks)), "stages": spans,
            "breakdown": {"device_ops": [[n[:160], v[1]] for n, v in ops],
                          "idle_gaps": gaps}}


def _host_label(h: np.ndarray, names: np.ndarray, marks: np.ndarray,
                stages: List[str], t: int) -> str:
    """The stage the host was in at ``t`` and the runtime call under way
    then (``host code`` between calls)."""
    stage = "outside the stages"
    if len(marks) == len(stages) + 1:
        i = int(np.searchsorted(marks, t, side="right")) - 1
        if 0 <= i < len(stages):
            stage = stages[i]
    inside = np.nonzero((h[:, 0] <= t) & (h[:, 1] > t))[0] if len(h) else []
    call = str(names[inside[0]]) if len(inside) else "host code"
    return f"{stage}/{call}"[:160]


def kernel_seconds(trace: dict, patterns: Iterable[str]) -> Tuple[float, int]:
    """Device seconds and launches of the kernels whose names hold any of
    ``patterns``."""
    s, n = 0.0, 0
    for name, (count, sec) in trace["kernels"].items():
        if any(p in name for p in patterns):
            s += sec
            n += count
    return s, n
