"""Milliseconds of the training step's backward a step: the interval that
ends at the step's ``backward`` mark (the benchmark's CUDA-event clock,
which ``make_train_step`` marks), averaged over the window's steps but the
traced one."""


def read(rec):
    if rec["kind"] != "train":
        return None
    ms = [c["clock_ms"]["backward"] for c in rec["calls"]
          if not c["traced"] and c["clock_ms"]]
    return sum(ms) / len(ms) if ms else None
