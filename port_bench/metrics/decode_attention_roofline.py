"""Decode attention's share of its roofline in the traced call: the bytes a
whole decode's attention needs at the cell's shapes (``counts``: the int8
K and V rows below each step's position, their scales, q, the new K and V,
and the output, over both CFG streams and every layer) over the bandwidth,
against the device time of the decode-attention kernels.

The kernels are found by name (``csrc/decode_attention.cu``: the serving
form and the cluster form). A change that renames them points this list at
the new names."""

from port_bench import counts as C
from port_bench.trace import kernel_seconds

KERNELS = ("serve_kernel", "decode_kernel")
CACHE_BYTES = {"int8": 1, "int4": 0.5, "bfloat16": 2}


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "generate" or not tr:
        return None
    seconds, n = kernel_seconds(tr, KERNELS)
    if not n:
        return None
    s, sh = rec["config"]["sampler"], rec["shapes"]
    rows = 2 * sh["batch"] if rec["config"]["generate"]["cfg_scale"] > 1 else sh["batch"]
    cache = CACHE_BYTES[rec["config"]["dtypes"]["cache"]]
    scale = 0 if cache == 2 else 4
    return C.roofline_pct(C.decode_attention_flops(s, rows, sh["steps"]),
                          C.decode_attention_bytes(s, rows, sh["steps"], cache, scale),
                          seconds)
