"""Where one block of a hand-written kernel spends its cycles on the card.

    python3 -m vaura_tpu_torch.profile_kernels [encoder] [decode]

``nvcc`` builds a copy of ``csrc/encoder_attention.cu`` or
``csrc/decode_attention.cu`` with ``clock64()`` stamps written by thread 0
of one block at the phase boundaries named in ``STAMPS`` (each an anchor
line of the source, which must occur exactly once: ``tests/
test_torch_profile_kernels.py`` holds that), runs the wrapper at the
flagship shapes through the stamped library and prints the cycles between
stamps and, for the encoder sublayer, the kernels' device time by name under
``torch.profiler`` (of the stamped build: the stamps cost a few stores).
Decode attention is stamped at four positions with ``pos`` on the host and
in device memory, the layers' caches cycled so that tiles come from device
memory; its time per call is ``chip_smoke.py``'s to measure. Needs a CUDA card; builds into ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
from typing import Dict, List, Tuple

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

# source -> (condition that picks the stamping thread, [(phase that ENDS at
# the anchor, anchor line)]); the first anchor starts the clock
STAMPS: Dict[str, Tuple[str, List[Tuple[str, str]]]] = {
    "encoder_attention": (
        "tid == 0 && blockIdx.x == 1 && blockIdx.y == 0 && blockIdx.z == 0",
        [
            ("start", "  // 1. the first two slabs are on their way while the CLS"),
            ("first slabs requested, CLS tile, first slab landed",
             "  // 2. q | k | v = LN(x) Wqkv_h^T"),
            ("q/k/v product (12 k-slabs)",
             "  // 3. bias, q scaled, rounded to bf16 over the ring."),
            ("q/k/v to shared memory", "  // 4. token queries, 16 consecutive rows"),
            ("attention", "  // 5. CLS query partials over the pack's rows"),
            ("CLS partials", "      if (tid == 0) {\n        part_m[pidx] = m;"),
        ],
    ),
    "decode_attention": (
        "tid == 0 && blockIdx.x == 0 && blockIdx.y == 0",
        [
            ("start", "  // pos and the block's query heads (scaled, in float32) are requested"),
            ("pos and q requested, barriers set up, q in shared memory",
             "  const size_t row = static_cast<size_t>(Hkv) * HD;  // stride of a position"),
            ("tile requested", "  int phase = 0;"),
            ("tile landed", "    if (last) cluster_wait();  // rank 0 has started"),
            ("cluster barrier", "    // a warp's 16 rows: two lanes a row"),
            ("scores, softmax, values, merge, remote stores",
             "  if (first > pos) cluster_wait();"),
            ("(rank 0 stays)", "  // rank 0: merge the blocks that had a tile"),
        ],
    ),
}

_PROLOGUE = (
    "__device__ long long vt_prof[32];\n"
    'extern "C" int vt_read_prof(long long* out) {\n'
    "  return cudaMemcpyFromSymbol(out, vt_prof, sizeof(vt_prof));\n}\n"
)


def stamped_source(name: str) -> str:
    """The source of ``csrc/<name>.cu`` with the stamps of ``STAMPS`` in."""
    with open(os.path.join(CSRC, f"{name}.cu")) as f:
        src = f.read()
    who, stamps = STAMPS[name]
    if src.count("namespace {\n") != 1:
        raise ValueError(f"{name}: expected one anonymous namespace")
    src = src.replace("namespace {\n", _PROLOGUE + "namespace {\n")
    for k, (_, anchor) in enumerate(stamps):
        if src.count(anchor) != 1:
            raise ValueError(f"{name}: anchor occurs {src.count(anchor)} "
                             f"times: {anchor!r}")
        indent = anchor[:len(anchor) - len(anchor.lstrip(" "))]
        src = src.replace(
            anchor, f"{indent}if ({who}) vt_prof[{k}] = clock64();\n{anchor}")
    return src


def build_stamped(name: str, signatures, out_dir: str) -> ctypes.CDLL:
    from vaura_tpu_torch.kernels import build

    os.makedirs(out_dir, exist_ok=True)
    shutil.copy(os.path.join(CSRC, "common.cuh"), out_dir)
    cu, so = (os.path.join(out_dir, f"{name}_stamped.{e}") for e in ("cu", "so"))
    with open(cu, "w") as f:
        f.write(stamped_source(name))
    done = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, f"-I{out_dir}",
                           "-o", so, cu], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(done.stdout[-3000:] + done.stderr[-3000:])
    lib = ctypes.CDLL(so)
    lib.vt_error_string.argtypes = [ctypes.c_int]
    lib.vt_error_string.restype = ctypes.c_char_p
    lib.vt_read_prof.argtypes = [ctypes.c_void_p]
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    build._libs[name] = lib  # the wrappers now launch the stamped build
    return lib


def read_stamps(lib, name: str) -> str:
    buf = (ctypes.c_longlong * 32)()
    lib.vt_read_prof(buf)
    stamps = STAMPS[name][1]
    parts = [f"{stamps[k + 1][0]} {buf[k + 1] - buf[k]}"
             for k in range(len(stamps) - 1)]
    return "; ".join(parts) + f"; all {buf[len(stamps) - 1] - buf[0]}"


def profile_encoder(gen, out_dir: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vaura_tpu_torch.ops import encoder_fused as ef

    lib = build_stamped("encoder_attention", ef._ATTN_SIG, out_dir)
    Bp, N, D = 8, 1568, 768
    bf = torch.bfloat16
    f32 = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    kw = dict(x_tok=f32(Bp, N, D).to(bf), x_cls=f32(Bp, 1, D).to(bf),
              ln_scale=1.0 + 0.1 * f32(D), ln_bias=0.1 * f32(D),
              wqkv=(f32(3 * D, D) * D ** -0.5).to(bf), bqkv=0.02 * f32(3 * D),
              wproj=(f32(D, D) * D ** -0.5).to(bf), bproj=0.02 * f32(D))
    for axis, L in (("time", 8), ("space", 196)):
        run = lambda: ef.fused_attention_sublayer(**kw, num_heads=12, L=L, eps=1e-6)
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        print(f"[encoder_attention] {axis} axis L={L}, cycles of one block: "
              + read_stamps(lib, "encoder_attention"))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                run()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if "_kernel" in e.key and "at::" not in e.key:
                print(f"    {e.key[:72]:72s} {e.device_time_total / e.count:8.1f} us "
                      f"x {e.count // 10} a call")


def profile_decode(gen, out_dir: str) -> None:
    import torch

    from vaura_tpu_torch.ops import decode_attention as da

    lib = build_stamped("decode_attention", da._SIG, out_dir)
    B, H, hd, S, layers = 4, 16, 96, 230, 24
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda",
                                 dtype=torch.bfloat16)
    kc, vc = rnd(layers, B, S, H, hd), rnd(layers, B, S, H, hd)
    q, kcur, vcur = rnd(B, H, hd), rnd(B, H, hd), rnd(B, H, hd)
    pos_t = torch.arange(S, dtype=torch.int32, device="cuda")
    for pos in (0, 63, 100, 228):
        for form in ("host", "device"):
            p = pos if form == "host" else pos_t[pos:pos + 1]
            for i in range(layers):
                da.decode_attention_cuda(q, kc[i], vc[i], kcur, vcur, p)
            torch.cuda.synchronize()
            print(f"[decode_attention] pos {pos:3d} on the {form}, cycles of "
                  "rank 0 of one cluster: " + read_stamps(lib, "decode_attention"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("which", nargs="*", default=["encoder", "decode"])
    ap.add_argument("--out", default=os.path.join("chiprun_out", "profile_kernels"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_kernels: CUDA is not available", file=sys.stderr)
        return 2
    from vaura_tpu_torch.profile_generate import nvidia_smi

    print(f"{torch.cuda.get_device_name(0)} ({nvidia_smi()})")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "encoder" in args.which:
        profile_encoder(gen, args.out)
    if "decode" in args.which:
        profile_decode(gen, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
