"""The whole training step's share of the card's bf16 peak: the model FLOPs
of a step at the cell's shapes (``counts``: the sampler's ``6 N T`` plus
attention over the sequence, the frozen encoder's forward, the codec's
encode) times the steps, over their wall on the host clock. The traced step
is left out (the profiler slows the host)."""

from port_bench import counts as C


def read(rec):
    if rec["kind"] != "train":
        return None
    cfg, sh = rec["config"], rec["shapes"]
    B = sh["batch"]
    seq = sh["codec_frames"] + cfg["sampler"]["num_codebooks"]
    samples = sh["codec_frames"] * C.dac_hop(cfg["codec"])
    flops = (C.sampler_train_flops(cfg["sampler"], B, seq)
             + B * C.encoder_flops(cfg["encoder"], sh["frames"])
             + B * C.dac_encode_flops(cfg["codec"], samples))
    calls = [c for c in rec["calls"] if not c["traced"]]
    if not calls:
        return None
    wall = sum(c["t1"] - c["t0"] for c in calls)
    return 100.0 * flops * len(calls) / wall / C.PEAK_BF16_FLOPS
