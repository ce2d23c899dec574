"""Where one block of a hand-written kernel spends its cycles on the card.

    python3 -m vaura_tpu_torch.profile_kernels [encoder] [decode] [mlp] [grouped]
        [serve] [dots] [forms]

``nvcc`` builds a copy of a kernel's library in which one file of ``csrc/``
(the ``.cu`` itself, or the shared header that holds the kernel) carries
``clock64()`` stamps written by one thread of one block at the phase
boundaries named in ``STAMPS`` (each an anchor line of that file, which must
occur exactly once: ``tests/test_torch_profile_kernels.py`` holds that), runs
the wrapper at the flagship shapes through the stamped library and prints the
cycles between stamps and, for the encoder sublayers, the kernels' device
time by name under ``torch.profiler`` (of the stamped build: the stamps cost
a few stores). Decode attention is stamped at four positions with ``pos`` on
the host and in device memory, the layers' caches cycled so that tiles come
from device memory; its serving form (``serve``, the int8 cache) and the int8
x int8 kernel (``dots``, 8 groups) in both forms at B2 = 4 and 256 (the
stamping block is the first: rank 0 of the first cluster); the MLP
sublayer's GEMM once as fc1 and once as fc2; the grouped attention on both
axes. ``forms`` times both forms of every decode kernel over B2 = 4 ... 256
(mean over the flagship's positions, CUDA-graph replay): the crossover that
``ops/decode_attention.py::SERVE_FROM_PAIRS`` encodes. Other times per call
are ``chip_smoke.py``'s to measure. Needs a CUDA card; builds into ``--out``.
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

# library -> (file of csrc/ that is stamped, condition that picks the stamping
# thread, [(phase that ENDS at the anchor, anchor line)]); the first anchor
# starts the clock
STAMPS: Dict[str, Tuple[str, str, List[Tuple[str, str]]]] = {
    "encoder_attention": (
        "encoder_attention.cu",
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
        "decode_attention.cu",
        "tid == 0 && blockIdx.x == 0 && blockIdx.y == 0",
        [
            ("start", "  // pos and the block's query heads (scaled, in float32) are requested"),
            ("pos and q requested, barriers set up, q in shared memory",
             "  const size_t row = static_cast<size_t>(Hkv) * RD;  // bytes between positions"),
            ("tile requested", "  int phase = 0;"),
            ("tile landed", "    if (last) cluster_wait();  // rank 0 has started"),
            ("cluster barrier", "    // a warp's 16 rows: two lanes a row"),
            ("scores, softmax, values, merge, remote stores",
             "  if (first > pos) cluster_wait();"),
            ("(rank 0 stays)", "  // rank 0: merge the blocks that had a tile"),
        ],
    ),
    # the serving form of decode attention; the stamp inside the tile loop
    # is the last tile's
    "decode_serve": (
        "decode_attention.cu",
        "tid == 0 && blockIdx.x == 0",
        [
            ("start", "  // serve: pos and the query heads requested"),
            ("pos and q requested, stages and partials set up, q in shared memory",
             "  // Tile j (rows 64 j .. 64 j + 63) goes to stage"),
            ("first tiles requested, tiles up to the last landed and computed",
             "    // serve: a warp's 16 rows, merged into its running partial"),
            ("last tile's rows", "  // serve: the four warps merged"),
            ("warps merged, output", "  // serve: done"),
        ],
    ),
    "decode_dots": (
        "decode_attention.cu",
        "tid == 0 && blockIdx.x == 0",
        [
            ("start", "  // dots 1. the stages' mbarriers"),
            ("mbarriers, first copies issued, q, k/v_cur and starts loaded",
             "  // dots 2. q per query head"),
            ("q quantized, the current position's score, scales landed",
             "  // dots 3. the scores"),
            ("K tiles landed, scores", "  // dots 4. the block's max"),
            ("block max and sum, cluster barrier 1", "  // dots 5. the softmax's max M"),
            ("the blocks' (max, sum) fetched, M and Z", "  // dots 6. each group's max"),
            ("group maxima, cluster barrier 2", "  // dots 7. p8 of the block's rows"),
            ("p8", "  // dots 8. p8 . v8"),
            ("V tiles landed, value products", "  // dots 9. the block's integer sums"),
            ("sums into rank 0, cluster barrier 3", "  // dots 10. out = sum over groups"),
            ("output", "  // dots 11. done"),
        ],
    ),
    # the GEMM of both products; a block in the middle of the grid
    "encoder_mlp": (
        "gemm.cuh",
        "tid == 0 && blockIdx.x == gridDim.x - 1 && blockIdx.y == gridDim.y / 2",
        [
            ("start", "  // gemm 1. the residual tile rides in the first group of copies"),
            ("residual tile and three slabs requested, first slab landed",
             "  // gemm 2. Entering step s, slab s has landed"),
            ("product (K / 64 slabs)", "  // gemm 3. the sums through shared memory"),
            ("sums to shared memory", "  // gemm 4. bias and the epilogue's function"),
            ("bias, GELU or residual, stores", "  // gemm 5. done"),
        ],
    ),
    "grouped_cls_attention": (
        "grouped_cls_attention.cu",
        "tid == 0 && blockIdx.x == 1 && blockIdx.y == 0",
        [
            ("start", "  // 1. the pack's q, k and v rows are requested;"),
            ("q, k, v requested (the warp stands while the memory system is "
             "busy), CLS tiles", "  // 2. everything has landed"),
            ("the last copies landed, block barrier",
             "  // 3. attention, 16 consecutive rows a warp"),
            ("attention of warp 0's tiles, stores", "  // 4. done"),
        ],
    ),
}

# the library a stamped kernel lives in, where not its own name
LIBRARY = {"decode_serve": "decode_attention", "decode_dots": "decode_attention"}

_PROLOGUE = (
    "__device__ long long vt_prof[32];\n"
    'extern "C" int vt_read_prof(long long* out) {\n'
    "  return cudaMemcpyFromSymbol(out, vt_prof, sizeof(vt_prof));\n}\n"
)


def stamped_source(name: str) -> str:
    """The file of ``csrc/`` that ``STAMPS[name]`` names, with the stamps in."""
    fname, who, stamps = STAMPS[name]
    with open(os.path.join(CSRC, fname)) as f:
        src = f.read()
    if src.count("namespace {\n") != 1:
        raise ValueError(f"{fname}: expected one anonymous namespace")
    src = src.replace("namespace {\n", _PROLOGUE + "namespace {\n")
    for k, (_, anchor) in enumerate(stamps):
        if src.count(anchor) != 1:
            raise ValueError(f"{fname}: anchor occurs {src.count(anchor)} "
                             f"times: {anchor!r}")
        indent = anchor[:len(anchor) - len(anchor.lstrip(" "))]
        src = src.replace(
            anchor, f"{indent}if ({who}) vt_prof[{k}] = clock64();\n{anchor}")
    return src


def build_stamped(name: str, signatures, out_dir: str) -> ctypes.CDLL:
    """Copy ``csrc/`` into ``out_dir/<name>``, stamp the one file, build the
    library that holds the kernel there and make the wrappers launch it."""
    from vaura_tpu_torch.kernels import build

    lib_name = LIBRARY.get(name, name)
    src_dir = os.path.join(out_dir, name)
    shutil.copytree(CSRC, src_dir, dirs_exist_ok=True)
    with open(os.path.join(src_dir, STAMPS[name][0]), "w") as f:
        f.write(stamped_source(name))
    cu = os.path.join(src_dir, f"{lib_name}.cu")
    so = os.path.join(src_dir, f"{lib_name}.so")
    done = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, f"-I{src_dir}",
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
    build._libs[lib_name] = lib  # the wrappers now launch the stamped build
    return lib


def read_stamps(lib, name: str) -> str:
    buf = (ctypes.c_longlong * 32)()
    lib.vt_read_prof(buf)
    stamps = STAMPS[name][2]
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


def _quant_layers(gen, shape, bits):
    """A quantized cache of ``shape`` (int8, or int4 with ``bits`` 4), a
    layer at a time."""
    import torch

    from vaura_tpu_torch.ops.quantization import quantize_kv, quantize_kv4

    fn = quantize_kv4 if bits == 4 else quantize_kv
    parts = [fn(torch.randn(*shape[1:], generator=gen, device="cuda",
                            dtype=torch.bfloat16)) for _ in range(shape[0])]
    return torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])


def _flagship_groups(device):
    import torch

    from vaura_tpu_torch.models.vaura import chunk_bounds

    return torch.tensor(chunk_bounds(230, 8)[:-1], dtype=torch.int32,
                        device=device)


def profile_quant(gen, out_dir: str, name: str) -> None:
    """Stamps of the serving form over the int8 cache (``decode_serve``) or
    of the int8 x int8 kernel over it in 8 groups, both forms
    (``decode_dots``), at B2 = 4 and 256, pos in device memory."""
    import torch

    from vaura_tpu_torch.ops import decode_attention as da

    lib = build_stamped(name, da._SIG, out_dir)
    H, hd, S, layers = 16, 96, 230, 24
    groups = _flagship_groups("cuda")
    pos_t = torch.arange(S, dtype=torch.int32, device="cuda")
    forms = ("serve",) if name == "decode_serve" else da.FORMS
    for B2 in (4, 256):
        rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda",
                                     dtype=torch.bfloat16)
        q, kcur, vcur = rnd(B2, H, hd), rnd(B2, H, hd), rnd(B2, H, hd)
        kq, ks = _quant_layers(gen, (layers, B2, S, H, hd), 8)
        vq, vs = _quant_layers(gen, (layers, B2, S, H, hd), 8)
        dots = name == "decode_dots"
        for form in forms:
            for pos in (0, 63, 100, 228):
                for i in range(layers):
                    da.decode_attention_cuda(
                        q, kq[i], vq[i], kcur, vcur, pos_t[pos:pos + 1], ks[i],
                        vs[i], int8_dots=dots,
                        chunk_starts=groups if dots else None, form=form)
                torch.cuda.synchronize()
                print(f"[{name}] B2={B2} {form} form, pos {pos:3d}, cycles of "
                      "block 0: " + read_stamps(lib, name))
        del kq, vq, ks, vs
        torch.cuda.empty_cache()


def _graph_ms(fn, reps: int) -> float:
    """Device ms of one ``fn()``, replayed as a CUDA graph ``reps`` times."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


FORM_SWEEP_B2 = (4, 16, 32, 64, 128, 256)


def profile_forms(gen, out_dir: str) -> Dict[str, dict]:
    """ms a call of both forms of each decode kernel (bf16, int8, int4
    caches; the int8 x int8 kernel over the int8 cache in the flagship's 8
    groups) at H = 16, hd = 96, S = 230 over ``FORM_SWEEP_B2``, the mean
    over positions 0 .. 228 read from device memory, layers cycled over 24
    caches; written to ``out_dir/forms.json``."""
    import json

    import torch

    from vaura_tpu_torch.ops import decode_attention as da

    from vaura_tpu_torch.kernels import build

    build._libs.pop("decode_attention", None)  # the library without stamps
    H, hd, S, layers = 16, 96, 230, 24
    positions = range(S - 1)
    groups = _flagship_groups("cuda")
    pos_t = torch.arange(S, dtype=torch.int32, device="cuda")
    res: Dict[str, dict] = {}
    for B2 in FORM_SWEEP_B2:
        rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda",
                                     dtype=torch.bfloat16)
        q, kcur, vcur = rnd(B2, H, hd), rnd(B2, H, hd), rnd(B2, H, hd)
        caches = {"bf16": (rnd(layers, B2, S, H, hd), rnd(layers, B2, S, H, hd))}
        for bits in (8, 4):
            caches[bits] = (_quant_layers(gen, (layers, B2, S, H, hd), bits),
                            _quant_layers(gen, (layers, B2, S, H, hd), bits))
        for kind in ("bf16", "int8", "int4", "dots"):
            plan = da.kernel_plan(B2, H, H, S, hd, 0, True, kind=kind,
                                  groups=groups.numel())
            row = res.setdefault(kind, {}).setdefault(str(B2), {"plan": plan["form"]})
            for form in da.FORMS:
                if kind == "bf16":
                    k, v = caches["bf16"]
                    call = lambda i, p: da.decode_attention_cuda(
                        q, k[i], v[i], kcur, vcur, pos_t[p:p + 1], form=form)
                else:
                    bits = 4 if kind == "int4" else 8
                    (kq, ks), (vq, vs) = caches[bits]
                    call = lambda i, p: da.decode_attention_cuda(
                        q, kq[i], vq[i], kcur, vcur, pos_t[p:p + 1], ks[i], vs[i],
                        cache_bits=bits, int8_dots=kind == "dots",
                        chunk_starts=groups if kind == "dots" else None, form=form)

                def run():
                    for p in positions:
                        call(p % layers, p)
                row[form] = _graph_ms(run, 10) / len(positions)
            print(f"[forms] {kind:5s} B2={B2:3d}: cluster {row['cluster']:.5f} ms, "
                  f"serve {row['serve']:.5f} ms; the plan takes {row['plan']}",
                  flush=True)
        del caches
        torch.cuda.empty_cache()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "forms.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


def profile_mlp(gen, out_dir: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vaura_tpu_torch.ops import encoder_fused as ef

    lib = build_stamped("encoder_mlp", ef._MLP_SIG, out_dir)
    Bp, N, D, Dh = 8, 1568, 768, 3072
    bf = torch.bfloat16
    f32 = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    args = (f32(Bp, N, D).to(bf), 1.0 + 0.1 * f32(D), 0.1 * f32(D),
            (f32(Dh, D) * D ** -0.5).to(bf), 0.02 * f32(Dh),
            (f32(D, Dh) * Dh ** -0.5).to(bf), 0.02 * f32(D))
    plan = ef.mlp_plan(Bp * N, D, Dh)
    print(f"[encoder_mlp] {plan}")
    scratch = (torch.empty_like(args[0]),
               torch.empty(Bp * N, Dh, dtype=bf, device="cuda"),
               torch.empty_like(args[0]))
    ef._mlp_cuda(*args, eps=1e-6, scratch=scratch)
    for part in ("fc1", "fc2"):  # both are the stamped kernel: one at a time
        for _ in range(3):
            ef._mlp_cuda(*args, eps=1e-6, parts=ef.MLP_PARTS[part], scratch=scratch)
        torch.cuda.synchronize()
        print(f"[encoder_mlp] {part}, cycles of one block: "
              + read_stamps(lib, "encoder_mlp"))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ef.fused_mlp_sublayer(*args, eps=1e-6)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if "_kernel" in e.key and "at::" not in e.key:
            print(f"    {e.key[:72]:72s} {e.device_time_total / e.count:8.1f} us "
                  f"x {e.count // 10} a call")


def profile_grouped(gen, out_dir: str) -> None:
    import torch

    from vaura_tpu_torch.ops import divided_attention as ga

    lib = build_stamped("grouped_cls_attention", ga._SIG, out_dir)
    BH, hd = 96, 64
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").bfloat16()
    for axis, G, L in (("time", 196, 8), ("space", 8, 196)):
        args = (rnd(BH, G, L, hd) * hd ** -0.5, rnd(BH, G, L, hd),
                rnd(BH, G, L, hd), rnd(BH, 1, hd), rnd(BH, 1, hd))
        for _ in range(3):
            ga.grouped_cls_attention_cuda(*args)
        torch.cuda.synchronize()
        print(f"[grouped_cls_attention] {axis} axis {ga.grouped_plan(G * L, L)}, "
              "cycles of one block: " + read_stamps(lib, "grouped_cls_attention"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("which", nargs="*",
                    default=["encoder", "decode", "serve", "dots", "mlp",
                             "grouped", "forms"])
    ap.add_argument("--out", default=os.path.join("chiprun_out", "profile_kernels"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_kernels: CUDA is not available", file=sys.stderr)
        return 2
    from vaura_tpu_torch.profile_generate import nvidia_smi

    print(f"{torch.cuda.get_device_name(0)} ({nvidia_smi()})")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for which, fn in (
            ("encoder", profile_encoder), ("decode", profile_decode),
            ("serve", lambda g, o: profile_quant(g, o, "decode_serve")),
            ("dots", lambda g, o: profile_quant(g, o, "decode_dots")),
            ("mlp", profile_mlp), ("grouped", profile_grouped),
            ("forms", profile_forms)):
        if which in args.which:
            fn(gen, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
