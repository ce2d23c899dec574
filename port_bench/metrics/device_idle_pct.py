"""The device's idle share of a call or step (``device_idle_pct.gen``,
``device_idle_pct.train``): one minus the device's busy seconds in the
traced call or step (the union of its kernel intervals in the profiler's
trace) over the mean wall of the window's untraced ones, which do the same
work. The traced one's own wall is not the divisor: the profiler slows the
host about three-fold, and the device then waits on it. Busy seconds above
that wall mean the reading is wrong, and it raises."""


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    walls = [c["t1"] - c["t0"] for c in rec["calls"] if not c["traced"]]
    if not walls:
        return None
    wall = sum(walls) / len(walls)
    if tr["busy_s"] > wall:
        raise ValueError(f"busy {tr['busy_s']!r} s over the mean untraced "
                         f"wall {wall!r} s")
    return 100.0 * (1.0 - tr["busy_s"] / wall)
