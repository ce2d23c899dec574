"""The routed experts' products' share of their roofline in the traced
call: every expert's bf16 weights once a step and routed layer and the
routed rows in and out (``counts/mla_moe.py::expert_bytes``) over the
bandwidth, or the chosen experts' operations over the bf16 peak where
those take longer, against the device time of the grouped products.

The kernels are found by name: ``torch._grouped_mm``'s CUTLASS grouped GEMM
(its template names ``GroupProblemShape``) and the kernel that lays out its
groups' problems on the device. A change that computes the experts with
other kernels points this list at their names."""

from port_bench.counts import mla_moe as C
from port_bench.counts import roofline_pct
from port_bench.trace import kernel_seconds

KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def read(rec):
    tr = rec.get("trace")
    s = rec["config"]["sampler"]
    if rec["kind"] != "generate" or not tr or "n_routed_experts" not in s:
        return None
    seconds, n = kernel_seconds(tr, KERNELS)
    if not n:
        return None
    sh = rec["shapes"]
    rows = 2 * sh["batch"] if rec["config"]["generate"]["cfg_scale"] > 1 else sh["batch"]
    return roofline_pct(C.expert_flops(s, rows, sh["steps"]),
                        C.expert_bytes(s, rows, sh["steps"]), seconds)
