"""The encoder's fused sublayers' share of their roofline in the traced
call: the operations of every divided block's two attention sublayers and
its MLP at the cell's shapes (``counts``) over the bf16 peak, against the
device time of the kernels that run them.

The kernels are found by name (``csrc/encoder_attention.cu``'s group
attention, and ``csrc/gemm.cuh``'s row layer norm and GEMM, which both
sublayers launch). A change that renames them points this list at the new
names."""

from port_bench import counts as C
from port_bench.trace import kernel_seconds

KERNELS = ("group_attention_kernel", "layernorm_rows_kernel", "gemm_bias_kernel")


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "generate" or not tr or not rec["shapes"]["encoder"]:
        return None
    seconds, n = kernel_seconds(tr, KERNELS)
    if not n:
        return None
    e, sh = rec["config"]["encoder"], rec["shapes"]
    B = sh["batch"]
    return C.roofline_pct(B * C.encoder_sublayer_flops(e, sh["frames"]),
                          B * C.encoder_sublayer_bytes(e, sh["frames"]), seconds)
