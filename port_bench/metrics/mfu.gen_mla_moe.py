"""The whole call's share of the card's bf16 peak, counting the weights a
position runs through (``counts/mla_moe.py``: every layer's latent
attention, the dense layer, the router and the 6 chosen and 2 shared
experts of each routed layer, the head; the latent attention's products),
over both CFG streams, and the codec's decode, times the calls, over their
wall on the host clock. A dense sampler's configuration counts every
weight (``counts.sampler_decode_flops``). The traced call is left out (the
profiler slows the host)."""

from port_bench import counts as C
from port_bench.counts import mla_moe as M


def read(rec):
    if rec["kind"] != "generate":
        return None
    cfg, sh = rec["config"], rec["shapes"]
    B = sh["batch"]
    rows = 2 * B if cfg["generate"]["cfg_scale"] > 1 else B
    decode = (M.sampler_decode_flops if "n_routed_experts" in cfg["sampler"]
              else C.sampler_decode_flops)
    flops = (decode(cfg["sampler"], rows, sh["steps"])
             + B * C.dac_decode_flops(cfg["codec"], sh["tokens"]))
    calls = [c for c in rec["calls"] if not c["traced"]]
    if not calls:
        return None
    wall = sum(c["t1"] - c["t0"] for c in calls)
    return 100.0 * flops * len(calls) / wall / C.PEAK_BF16_FLOPS
