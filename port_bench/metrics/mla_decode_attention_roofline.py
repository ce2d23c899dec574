"""The latent-attention decode kernel's share of its roofline in the traced
call: the bytes a whole decode's latent attention needs at the cell's
shapes (``counts/mla_moe.py``: the bf16 ``[c; k_pe]`` rows below each
step's position, the query, the new row and the float32 output, over both
CFG streams and every layer) over the bandwidth, or its operations over
the bf16 peak where those take longer, against the kernel's device time.

The kernel is found by name (``ops/mla_decode_attention.py``'s Triton
kernel). A change that renames it points this list at the new name."""

from port_bench.counts import mla_moe as C
from port_bench.counts import roofline_pct
from port_bench.trace import kernel_seconds

KERNELS = ("mla_decode_kernel",)


def read(rec):
    tr = rec.get("trace")
    s = rec["config"]["sampler"]
    if rec["kind"] != "generate" or not tr or "kv_lora_rank" not in s:
        return None
    seconds, n = kernel_seconds(tr, KERNELS)
    if not n:
        return None
    sh = rec["shapes"]
    rows = 2 * sh["batch"] if rec["config"]["generate"]["cfg_scale"] > 1 else sh["batch"]
    return roofline_pct(C.mla_decode_attention_flops(s, rows, sh["steps"]),
                        C.mla_decode_attention_bytes(s, rows, sh["steps"]),
                        seconds)
