"""The whole call's share of the card's bf16 peak: the model FLOPs of a
call at the cell's shapes (``counts``: the encoder's forward where the cell
sends frames, the sampler's decode over both CFG streams, the codec's
decode) times the calls, over their wall on the host clock. The traced
call is left out (the profiler slows the host)."""

from port_bench import counts as C


def read(rec):
    if rec["kind"] != "generate":
        return None
    cfg, sh = rec["config"], rec["shapes"]
    B = sh["batch"]
    rows = 2 * B if cfg["generate"]["cfg_scale"] > 1 else B
    flops = (C.sampler_decode_flops(cfg["sampler"], rows, sh["steps"])
             + B * C.dac_decode_flops(cfg["codec"], sh["tokens"]))
    if sh["encoder"]:
        flops += B * C.encoder_flops(cfg["encoder"], sh["frames"])
    calls = [c for c in rec["calls"] if not c["traced"]]
    wall = sum(c["t1"] - c["t0"] for c in calls)
    return 100.0 * flops * len(calls) / wall / C.PEAK_BF16_FLOPS
