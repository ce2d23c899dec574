"""Milliseconds of the training step's forward a step: the interval that
ends at the step's ``forward`` mark (the benchmark's CUDA-event clock,
which ``make_train_step`` marks), averaged over the window's steps but the
traced one.
The forward holds the frozen encoder and the codec's encode."""


def read(rec):
    if rec["kind"] != "train":
        return None
    ms = [c["clock_ms"]["forward"] for c in rec["calls"]
          if not c["traced"] and c["clock_ms"]]
    return sum(ms) / len(ms) if ms else None
