"""Milliseconds of the encoder stage a clip: the program's own
``stage_ms["encoder"]`` (CUDA events) summed over every call of the
window but the traced one, over their clips. Only where the cell sends
frames."""


def read(rec):
    if rec["kind"] != "generate" or not rec["shapes"]["encoder"]:
        return None
    calls = [c for c in rec["calls"] if not c["traced"]]
    return (sum(c["stage_ms"]["encoder"] for c in calls)
            / sum(c["clips"] for c in calls))
