"""How unevenly the router spreads the rows: per call, the mean over decode
steps and routed layers of the busiest expert's rows over the mean rows an
expert (1.0 is even), from the program's device counter of the rows routed
to each expert (``VauraSystem.expert_load``, read once a call), averaged
over the window's calls. A count's ratio."""


def read(rec):
    if rec["kind"] != "generate":
        return None
    vals = [c["expert_load_max"] for c in rec["calls"] if "expert_load_max" in c]
    return sum(vals) / len(vals) if vals else None
