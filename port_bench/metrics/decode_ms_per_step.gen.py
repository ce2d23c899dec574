"""Milliseconds a decode step: the program's own
``stage_ms["decode_loop"]`` (CUDA events; it holds the conditioning and
the pattern's build and revert too) summed over every call of the window
but the traced one, over their steps."""


def read(rec):
    if rec["kind"] != "generate":
        return None
    calls = [c for c in rec["calls"] if not c["traced"]]
    return (sum(c["stage_ms"]["decode_loop"] for c in calls)
            / (len(calls) * rec["shapes"]["steps"]))
