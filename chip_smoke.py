#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``vaura_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure makes the exit code non-zero and suppresses the final
result line):

  1. build   every CUDA kernel of the port from ``csrc/`` with nvcc, one
             process per source, all at once;
  2. kernels each kernel against its plain PyTorch version at the flagship
             shapes (bf16), with its time, the plain version's time, one
             PyTorch library call's time where one computes the same
             function, and its bound (bytes over 3.35 TB/s or operations
             over 989 TFLOP/s, the H100 SXM's published peaks). Decode
             attention (one launch: the tiles of a cache are the blocks of a
             thread-block cluster) is held with ``pos`` on the host and in
             device memory, with GQA and on a 1,024-position cache, and
             timed beside an empty kernel of the same launch; its int8
             instantiation (int8 cache, per-(position, head) scales) the
             same way over positions 0..228, timed at B2 = 4 and at a
             serving B2 = 256 beside the bf16 kernel on the same values; the
             encoder attention sublayer (three launches: row statistics,
             group attention, projection) also at B' = 2 and on ragged
             packs; the MLP sublayer (three launches: layer norm, fc1, fc2)
             also on ragged row counts, with each launch timed alone; the
             grouped attention (one kernel for both axes) also at group
             lengths around its tile edges;
  3. main    the flagship path end to end through ``VauraSystem.generate``:
             frames [2, 4, 3, 16, 224, 224] -> MotionFormer -> CFG 6.0,
             top-k 128 decode of 221 tokens -> DAC -> audio [2, 1, 113152],
             seeded random weights made on the card; every kernel's launch
             counter is zeroed just before and read just after;
  4. int8    the same with the int8 KV cache (the serving default): every
             decode step through the int8 instantiation;
  5. train   the flagship training configuration (float32 parameters,
             bf16 compute, unfrozen encoder, batch 2, audio through the DAC
             encoder): three ``train_step``s and one ``eval_step``, with
             every launch counter zeroed just before and read after each
             step, and the time of forward, backward and optimizer;
  6. long    5.12 s (441 tokens) from frames [2, 8, 3, 16, 224, 224]:
             ``generate_long`` (stride 55: the carried prompts go through
             ``prefill``), ``generate_long_kv`` (window 4 x 56: chunks
             drop) and ``generate_long_kv_stream``, whose increments must
             concatenate to the one-shot run of the same seed; counters per
             run;
  7. reference  the same modules at flagship widths, cut depth, on a small
             input: the card (kernels) against the CPU (plain versions),
             for generation (bf16 and int8 caches, ``prefill``) and for the
             training loss and its gradients;
  8. action  the generate action as a user runs it (``vaura_tpu_torch.main``
             from the repo's configs, the dummy datamodule, one batch):
             ``configs/generate_vgg.yaml`` at its batch of 16 with the bf16
             cache and with ``quantize=true``, and
             ``configs/generate_vgg_sparse.yaml`` (5.12 s) with
             ``long_mode=stream_kv`` at batch 2; every clip written as a
             finite WAV of the expected length with codes in [0, 1024), the
             decode kernel (its int8 instantiation under ``quantize``) and
             both encoder kernels launched; WAVs under
             ``chiprun_out/action/``.
  9. train_action  the train and test actions as a user runs them
             (``vaura_tpu_torch.main`` from
             ``configs/experiments/flagship_smoke.yaml``: the flagship
             model, seeded random weights, the dummy datamodule): A trains
             2 epochs x 3 steps with the encoder frozen (every validation,
             predict-media and TensorBoard path on), B resumes A for a
             third epoch with async saves, C tests A's best checkpoint, D
             trains 2 steps with the encoder unfrozen; losses, steps,
             checkpoints, TensorBoard tags, the resumed early-stop state,
             C's test loss against A's and each run's launches are held;
             each run's wall, step, validation, save and restore times and
             peak memory printed (``train_action: {...}``);
 10. serve   the server as a user starts it (``action=serve`` from
             ``configs/generate_vgg.yaml``, ``make_server``, HTTP on
             127.0.0.1): with the bf16 cache, buckets [1, 8] and the
             rolling-KV stream, a lone request whose codes must equal
             ``VauraSystem.generate``'s on the same padded features and
             seed, a burst of 16 WAV requests (at most 15 batches), one
             clip through the encoder (``video_b64``, or
             ``GenerationService.frames_to_features`` where the native
             media library is missing), a stream of 440 tokens, a hot
             reload from a ``CheckpointManager`` checkpoint (the codes must
             change) and ``close()``; then a burst of 8 with
             ``quantize=cache``. Launch counters zeroed after each
             service's warm-up; the direct generations that check the
             server are not counted.
 11. finetune the finetune action as a user runs it (``action=finetune``
             on ``configs/experiments/flagship_smoke.yaml``, seeded random
             weights): L trains LoRA adapters of rank 8 for 3 steps from a
             base checkpoint of the same model (the base sampler must stay
             bit for bit, the run's checkpoint hold the adapters alone), F
             trains the whole model with the encoder unfrozen and bf16
             first moments for 2 steps; then the generate action from L's
             experiment (its merged weights held to ``W + (alpha / r) b a``,
             its codes to ``VauraSystem.generate`` of a system that holds
             the merged weights without adapters) and from the base, 1.28 s
             at batch 2, WAVs under ``chiprun_out/finetune/``;
 12. eval    ``action=eval`` on those WAVs (L's against the base's) with
             ``melstats``, ``vggish`` and ``panns`` (seeded random-weight
             ``.pth`` files written under ``chiprun_out/eval/`` and deleted
             after): finite metrics, the FAD of a set against itself within
             D sqrt(eps) of its total variance, the networks' embeddings on
             the card within 1e-3 relative of the CPU's (cuDNN at its
             defaults: the networks turn TF32 off themselves).

It prints the action runs' wall times and audio-s/s (``action: {...}``),
the train action's runs (``train_action: {...}``),
the server's burst, stream and request times (``serve: {...}``), the
finetune and generate runs' walls and peak memory (``finetune: {...}``),
the eval action's walls and metrics (``eval: {...}``),
the kernels JSON line, the card's name and power limit, and as its last
line ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``. It needs one CUDA card and exits non-zero
without one.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

HBM_BYTES_PER_S = 3.35e12   # H100 SXM published peaks (dense)
BF16_FLOP_PER_S = 989e12

# tolerances (max absolute error of the kernel against its plain version)
# decode attention: both sides float32 softmax and sums, one rounding of an
# output of magnitude < 1 to bf16 -> at most about one bf16 ulp (2^-8)
TOL_DECODE = 1e-2
# encoder sublayers: y = x + f(x) rounded to bf16 at |y| up to ~8, where one
# ulp is 2^-5; the kernel and the plain version round q/k/v and the hidden
# activation at the same points but sum in other orders, so a value may
# land one ulp apart -> two ulps at the top of the range
TOL_SUBLAYER = 6.25e-2
# grouped attention: the kernel rounds unnormalised probabilities to bf16 for
# the tensor cores and its output once; the plain version
# rounds the normalised probabilities to bf16 (2^-9 relative) before the
# value product and its output again, so the two may land one ulp apart,
# rarely two. Every shape is held to two bf16 ulps of ITS largest output
# (a long group averages ~200 values and stays small; a short one does not),
# and the kernel may be no further from the float32 evaluation than that
TOL_GROUPED_ULPS = 2
# reference phase (card vs CPU, bf16 stacks of ~20 roundings): relative to
# the largest magnitude of the output
TOL_REF_REL = 3e-2
# training loss, card vs CPU: a mean over ~150 cross entropies of bf16 logits
TOL_REF_LOSS = 2e-2
# gradients of named leaves, card vs CPU, relative to the leaf's largest
# gradient: bf16 forward and backward through the cut stack, sums in other
# orders, and the kernel's rounding against the plain version's
TOL_REF_GRAD = 6e-2
# float32 DAC on both sides (TF32 off for the check): relative RMS error
TOL_REF_AUDIO = 1e-3


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Device milliseconds of one ``fn()``: the launches are captured once
    into a CUDA graph and the graph is replayed ``reps`` times between two
    events, so host overhead between launches is not counted."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm up outside the capture
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


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
def phase_build(report):
    from vaura_tpu_torch.kernels import build

    t0 = time.time()
    targets = build.build_all()
    report["build_s"] = time.time() - t0
    report["build_logs"] = {n: build.build_log(n) for n in targets}
    log(f"[build] {len(targets)} kernels in {report['build_s']:.1f} s")
    for name in targets:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def check_decode_attention(gen):
    """Flagship decode: B2 = 2 clips x 2 (CFG), H = 16, hd = 96, S = 230,
    with ``pos`` on the host and in device memory; then GQA (H_kv = H / 4)
    and a cache of 1,024 positions (more tiles than one cluster holds)."""
    import torch
    import torch.nn.functional as F

    from vaura_tpu_torch.ops import decode_attention as da

    B, H, hd, S, L = 4, 16, 96, 230, 24
    dev, bf = "cuda", torch.bfloat16
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev, dtype=bf)

    def hold(tag, q, kc, vc, kcur, vcur, positions):
        """The kernel with ``pos`` as an int and as a device scalar against
        the plain version; the two forms must agree to the last bit."""
        pos_t = torch.arange(kc.shape[1] + 1, dtype=torch.int32, device=dev)
        worst = 0.0
        for pos in positions:
            want = da.decode_attention_plain(q, kc, vc, kcur, vcur, pos)
            got = da.decode_attention(q, kc, vc, kcur, vcur, pos)
            got_t = da.decode_attention(q, kc, vc, kcur, vcur,
                                        pos_t[pos:pos + 1])
            torch.cuda.synchronize()
            e = max(max_err(got, want), max_err(got_t, want))
            log(f"[decode_attention] {tag} pos={pos:4d} max_abs_err={e:.3e}")
            if not torch.equal(got, got_t):
                raise AssertionError(f"{tag} pos={pos}: pos on the host and "
                                     "in device memory give different outputs")
            worst = max(worst, e)
        return worst

    # one cache per layer so a sweep streams from HBM as the decode loop does
    kc, vc = rnd(L, B, S, H, hd), rnd(L, B, S, H, hd)
    q, kcur, vcur = rnd(B, H, hd), rnd(B, H, hd), rnd(B, H, hd)
    edge = (0, 1, 63, 64, 65, 128, 228, S - 1)
    err = hold("flagship", q, kc[0], vc[0], kcur, vcur, edge)
    Hkv = H // 4
    err = max(err, hold(
        f"GQA H_kv={Hkv}", q, rnd(B, S, Hkv, hd), rnd(B, S, Hkv, hd),
        rnd(B, Hkv, hd), rnd(B, Hkv, hd), edge))
    S_long = 1024
    plan = da.launch_plan(S_long, S_long, True)
    log(f"[decode_attention] S={S_long}: {plan}")
    err = max(err, hold(
        f"S={S_long}", q[:2], rnd(2, S_long, H, hd), rnd(2, S_long, H, hd),
        kcur[:2], vcur[:2], edge + (511, 512, 513, 1000, S_long)))

    # the main path's positions: one launch per step at pos = 0 .. 228,
    # layers cycled, pos read from device memory as decode_step passes it;
    # the current K/V are the cache rows at pos, so the function equals SDPA
    # over cache[:pos + 1]
    positions = list(range(S - 1))
    pos_t = torch.arange(S, dtype=torch.int32, device=dev)
    cur = [(kc[p % L][:, p].contiguous(), vc[p % L][:, p].contiguous())
           for p in positions]

    def sweep(fn, on_device=False):
        def run():
            for p, (k1, v1) in zip(positions, cur):
                fn(q, kc[p % L], vc[p % L], k1, v1,
                   pos_t[p:p + 1] if on_device else p)
        return run

    def sdpa(q_, k_, v_, k1, v1, p):
        F.scaled_dot_product_attention(
            q_[:, :, None], k_[:, :p + 1].transpose(1, 2),
            v_[:, :p + 1].transpose(1, 2))

    def empty(on_device):
        def run(q_, k_, v_, k1, v1, p):
            da.empty_launch(B, H, H, S, hd, 0 if on_device else p, on_device,
                            dev)
        return run

    n = len(positions)
    ms = cuda_ms(sweep(da.decode_attention_cuda, True), 20) / n
    ms_host_pos = cuda_ms(sweep(da.decode_attention_cuda), 20) / n
    plain_ms = cuda_ms(sweep(da.decode_attention_plain), 5) / n
    library_ms = cuda_ms(sweep(sdpa), 20) / n
    floor_ms = cuda_ms(sweep(empty(True), True), 20) / n
    floor_host_pos = cuda_ms(sweep(empty(False)), 20) / n
    bound = sum(
        max(((2 * B * H * hd + 2 * B * H * hd) + 2 * B * p * H * hd) * 2
            / HBM_BYTES_PER_S,
            4 * B * H * (p + 1) * hd / BF16_FLOP_PER_S) for p in positions
    ) / n * 1e3
    log(f"[decode_attention] ms per call: pos in device memory {ms:.5f}, pos "
        f"on the host {ms_host_pos:.5f}; an empty kernel of the same launch "
        f"{floor_ms:.5f} / {floor_host_pos:.5f}")
    return {
        "name": "decode_attention", "route": "cuda",
        "source": "vaura_tpu_torch/csrc/decode_attention.cu",
        "replaces": "vaura_tpu/ops/pallas_attention.py:165",
        "max_abs_err": err, "tol": TOL_DECODE, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": "bytes", "library_ms": library_ms,
        "library": "F.scaled_dot_product_attention",
        "ms_host_pos": ms_host_pos, "empty_launch_ms": floor_ms,
        "empty_launch_ms_host_pos": floor_host_pos,
        "launches_per_call": 1,
        "shape": f"B2={B} H={H} hd={hd} S={S}, mean over pos 0..{S - 2}, pos "
                 "read from device memory",
    }


def check_decode_attention_int8(gen):
    """The int8 instantiation of the decode-attention kernel (int8 K/V
    tiles, per-(position, KV head) float32 scales, the current position's
    K/V bf16) against its plain version at the flagship shapes over
    positions 0..228 with ``pos`` on the host and in device memory, with GQA
    and at S = 1,024; timed over the main path's positions at B2 = 4 (the
    flagship batch 2 with CFG) and at a serving batch B2 = 256, beside the
    bf16 kernel on the same values and the byte bound."""
    import torch
    import torch.nn.functional as F

    from vaura_tpu_torch.ops import decode_attention as da
    from vaura_tpu_torch.ops.quantization import quantize_kv

    H, hd, S, L = 16, 96, 230, 24
    dev, bf = "cuda", torch.bfloat16
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev, dtype=bf)

    def cache(*shape):
        """Quantized K or V of bf16 values: (int8, scales, the bf16 values),
        quantized a slice of the first axis at a time (the float32
        temporaries of a whole serving cache would take tens of GB)."""
        x = rnd(*shape)
        parts = [quantize_kv(t) for t in x.unbind(0)]
        return (torch.stack([p[0] for p in parts]),
                torch.stack([p[1] for p in parts]), x)

    def hold(tag, q, k, v, kcur, vcur, positions):
        (kq, ks, _), (vq, vs, _) = k, v
        pos_t = torch.arange(kq.shape[1] + 1, dtype=torch.int32, device=dev)
        worst = 0.0
        for pos in positions:
            want = da.decode_attention_plain(q, kq, vq, kcur, vcur, pos, ks, vs)
            got = da.decode_attention(q, kq, vq, kcur, vcur, pos, ks, vs)
            got_t = da.decode_attention(q, kq, vq, kcur, vcur,
                                        pos_t[pos:pos + 1], ks, vs)
            torch.cuda.synchronize()
            if not torch.equal(got, got_t):
                raise AssertionError(f"{tag} pos={pos}: pos on the host and "
                                     "in device memory give different outputs")
            worst = max(worst, max_err(got, want))
        log(f"[decode_attention_int8] {tag} positions {positions[0]}.."
            f"{positions[-1]} ({len(positions)}): max_abs_err={worst:.3e}")
        return worst

    B = 4
    q, kcur, vcur = rnd(B, H, hd), rnd(B, H, hd), rnd(B, H, hd)
    err = hold("flagship", q, cache(B, S, H, hd), cache(B, S, H, hd), kcur,
               vcur, list(range(S - 1)) + [S])
    Hkv = H // 4
    err = max(err, hold(f"GQA H_kv={Hkv}", q, cache(B, S, Hkv, hd),
                        cache(B, S, Hkv, hd), rnd(B, Hkv, hd), rnd(B, Hkv, hd),
                        [0, 1, 63, 64, 65, 128, 228, 229]))
    err = max(err, hold("S=1024", q[:2], cache(2, 1024, H, hd),
                        cache(2, 1024, H, hd), kcur[:2], vcur[:2],
                        [0, 64, 511, 512, 513, 1000, 1024]))

    positions = list(range(S - 1))
    n = len(positions)
    pos_t = torch.arange(S, dtype=torch.int32, device=dev)

    def timings(B2, with_plain):
        """ms per call over the main path's positions (layers cycled over L
        caches so that a sweep streams from device memory): the int8 kernel,
        the bf16 kernel on the same values, SDPA on them, and the bound."""
        qb, k1, v1 = rnd(B2, H, hd), rnd(B2, H, hd), rnd(B2, H, hd)
        k8, ks, kb = cache(L, B2, S, H, hd)
        v8, vs, vb = cache(L, B2, S, H, hd)

        def sweep(fn):
            def run():
                for p in positions:
                    fn(p % L, p)
            return run

        int8 = lambda i, p: da.decode_attention_cuda(
            qb, k8[i], v8[i], k1, v1, pos_t[p:p + 1], ks[i], vs[i])
        bf16 = lambda i, p: da.decode_attention_cuda(
            qb, kb[i], vb[i], k1, v1, pos_t[p:p + 1])
        plain = lambda i, p: da.decode_attention_plain(
            qb, k8[i], v8[i], k1, v1, p, ks[i], vs[i])
        sdpa = lambda i, p: F.scaled_dot_product_attention(
            qb[:, :, None], kb[i][:, :p + 1].transpose(1, 2),
            vb[i][:, :p + 1].transpose(1, 2))
        empty = lambda i, p: da.empty_launch(B2, H, H, S, hd, 0, True, dev,
                                             int8=True)
        out = {"ms": cuda_ms(sweep(int8), 20) / n,
               "bf16_ms": cuda_ms(sweep(bf16), 20) / n,
               "sdpa_bf16_ms": cuda_ms(sweep(sdpa), 20) / n,
               "empty_launch_ms": cuda_ms(sweep(empty), 20) / n}
        if with_plain:
            out["plain_ms"] = cuda_ms(sweep(plain), 3) / n
        io = (2 * B2 * H * hd + 2 * B2 * H * hd) * 2  # q, k/v_cur in, out
        out["bound_ms"] = sum(
            (io + 2 * B2 * p * H * (hd + 4)) / HBM_BYTES_PER_S
            for p in positions) / n * 1e3
        out["bf16_bound_ms"] = sum(
            (io + 2 * B2 * p * H * hd * 2) / HBM_BYTES_PER_S
            for p in positions) / n * 1e3
        del k8, v8, kb, vb, ks, vs
        torch.cuda.empty_cache()
        return out

    small, serving = timings(B, True), timings(256, False)
    for tag, t in (("B2=4", small), ("B2=256", serving)):
        log(f"[decode_attention_int8] {tag} ms per call: int8 {t['ms']:.5f}, "
            f"bf16 kernel {t['bf16_ms']:.5f}, SDPA on the bf16 values "
            f"{t['sdpa_bf16_ms']:.5f}, an empty launch {t['empty_launch_ms']:.5f}; "
            f"bound int8 {t['bound_ms']:.5f}, bf16 {t['bf16_bound_ms']:.5f}")
    return {
        "name": "decode_attention_int8", "route": "cuda",
        "source": "vaura_tpu_torch/csrc/decode_attention.cu",
        # no Pallas kernel: the JAX package's int8 cache is einsums
        "replaces": "vaura_tpu/models/sampler.py:296",
        "max_abs_err": err, "tol": TOL_DECODE, "ms": small["ms"],
        "plain_ms": small["plain_ms"], "bound_ms": small["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "b2_4": small, "b2_256": serving,
        "shape": f"B2=4 (and 256) H={H} hd={hd} S={S} int8 cache, mean over "
                 f"pos 0..{S - 2}, pos read from device memory",
    }


def _sublayer_inputs(gen, Bp=8, N=1568, D=768):
    import torch

    dev, bf = "cuda", torch.bfloat16
    f32 = lambda *s: torch.randn(*s, generator=gen, device=dev)
    return dict(
        x_tok=f32(Bp, N, D).to(bf), x_cls=f32(Bp, 1, D).to(bf),
        ln_scale=1.0 + 0.1 * f32(D), ln_bias=0.1 * f32(D),
        wqkv=(f32(3 * D, D) * D ** -0.5).to(bf), bqkv=0.02 * f32(3 * D),
        wproj=(f32(D, D) * D ** -0.5).to(bf), bproj=0.02 * f32(D),
    )


def _attention_cost(Bp, N, D, L):
    bytes_ = (2 * Bp * N * D + 2 * Bp * D + 4 * D * D) * 2 + (4 * D + 2 * D) * 4
    flops = (2 * Bp * (N + 1) * D * 4 * D      # q/k/v and output projections
             + 4 * Bp * N * (L + 1) * D        # group attention + CLS column
             + 4 * Bp * (N + 1) * D)           # CLS query over all rows
    return bytes_, flops


def check_encoder_attention(gen):
    """Both geometries of one block, time (L = t = 8) and space (L = 196),
    at B' = 8 (timed) and B' = 2; then packs of several groups whose last
    pack ends ragged (N not a multiple of the pack's rows)."""
    from vaura_tpu_torch.ops import encoder_fused as ef

    def hold(tag, kw, L):
        args = dict(kw, num_heads=12, L=L, eps=1e-6)
        got = ef.fused_attention_sublayer(**args)
        want = ef.fused_attention_sublayer_plain(**args)
        e = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
        mean_e = float((got[0].float() - want[0].float()).abs().mean())
        plan = ef.attention_plan(kw["x_tok"].shape[1], L)
        log(f"[encoder_attention] {tag} L={L} max_abs_err={e:.3e} "
            f"mean_abs_err={mean_e:.3e} packs {plan['n_packs']} x "
            f"{plan['rows_per_pack']} rows, last {plan['last_pack_rows']}")
        return e, args

    kw = _sublayer_inputs(gen)
    Bp, N, D = kw["x_tok"].shape
    err, ms, plain_ms, bound, axis_ms = 0.0, 0.0, 0.0, 0.0, {}
    for axis, L in (("time", 8), ("space", 196)):
        e, args = hold(f"{axis} B'={Bp}", kw, L)
        err = max(err, e)
        axis_ms[axis] = cuda_ms(lambda: ef.fused_attention_sublayer(**args), 10)
        ms += axis_ms[axis]
        plain_ms += cuda_ms(lambda: ef.fused_attention_sublayer_plain(**args), 3)
        b, f = _attention_cost(Bp, N, D, L)
        bound += max(b / HBM_BYTES_PER_S, f / BF16_FLOP_PER_S) * 1e3
    log(f"[encoder_attention] ms per sublayer: time {axis_ms['time']:.4f}, "
        f"space {axis_ms['space']:.4f}")
    small = _sublayer_inputs(gen, Bp=2)
    for axis, L in (("time", 8), ("space", 196)):
        err = max(err, hold(f"{axis} B'=2", small, L)[0])
    # 7 groups of 40 rows: packs of 240, 40 (ragged), query tiles that
    # straddle two groups; 13 groups of 32: packs of 256, 160
    for N_r, L in ((280, 40), (416, 32)):
        err = max(err, hold("ragged", _sublayer_inputs(gen, Bp=2, N=N_r), L)[0])
    return {
        "name": "encoder_attention", "route": "cuda",
        "source": "vaura_tpu_torch/csrc/encoder_attention.cu",
        "replaces": "vaura_tpu/ops/encoder_fused.py:193",
        "max_abs_err": err, "tol": TOL_SUBLAYER, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "operations",
        "library_ms": None, "ms_time_axis": axis_ms["time"],
        "ms_space_axis": axis_ms["space"],
        "launches_per_call": ef.ATTENTION_LAUNCHES_PER_CALL,
        "shape": f"B'={Bp} N={N} D={D} H=12, time + space sublayer of one block",
    }


def check_encoder_mlp(gen):
    """The MLP sublayer at the flagship shape (timed: the call, each of its
    launches alone, fc2 on hidden rows that are in L2 and on hidden rows that
    are not, and the two products alone as ``torch.matmul``), then at B' = 2
    and on ragged row counts."""
    import torch

    from vaura_tpu_torch.ops import encoder_fused as ef

    D, Dh = 768, 3072
    dev, bf = "cuda", torch.bfloat16
    f32 = lambda *s: torch.randn(*s, generator=gen, device=dev)

    def inputs(Bp, N):
        return (f32(Bp, N, D).to(bf), 1.0 + 0.1 * f32(D), 0.1 * f32(D),
                (f32(Dh, D) * D ** -0.5).to(bf), 0.02 * f32(Dh),
                (f32(D, Dh) * Dh ** -0.5).to(bf), 0.02 * f32(D))

    def hold(args):
        Bp, N, _ = args[0].shape
        got = ef.fused_mlp_sublayer(*args, eps=1e-6)
        want = ef.fused_mlp_sublayer_plain(*args, eps=1e-6)
        torch.cuda.synchronize()
        e = max_err(got, want)
        mean_e = float((got.float() - want.float()).abs().mean())
        plan = ef.mlp_plan(Bp * N, D, Dh)
        log(f"[encoder_mlp] B'={Bp} N={N} max_abs_err={e:.3e} mean_abs_err="
            f"{mean_e:.3e} blocks fc1 {plan['fc1_blocks']}, fc2 "
            f"{plan['fc2_blocks']}")
        return e

    Bp, N = 8, 1568
    args = inputs(Bp, N)
    err = hold(args)
    M = Bp * N
    plan = ef.mlp_plan(M, D, Dh)
    log(f"[encoder_mlp] plan {plan}")
    ms = cuda_ms(lambda: ef.fused_mlp_sublayer(*args, eps=1e-6), 10)
    plain_ms = cuda_ms(lambda: ef.fused_mlp_sublayer_plain(*args, eps=1e-6), 3)

    # each launch alone, on the scratch of a full call
    scratch = (torch.empty_like(args[0]),
               torch.empty(M, Dh, dtype=bf, device=dev),
               torch.empty_like(args[0]))
    ef._mlp_cuda(*args, eps=1e-6, scratch=scratch)
    part_ms = {
        name: cuda_ms(lambda: ef._mlp_cuda(*args, eps=1e-6, parts=bit,
                                           scratch=scratch), 10)
        for name, bit in ef.MLP_PARTS.items()}

    # does the hidden activation's trip through device memory cost? fc2 of
    # 4,224 rows (33 row tiles: its 132 blocks are one wave) whose hidden rows
    # are in L2 (one tensor of 26 MB, read again and again) against one whose
    # hidden rows are not (six such tensors in turn); x, y and the weights are
    # the same tensors in both
    rows = 33 * 128
    part = (args[0].reshape(1, M, D)[:, :rows].contiguous(),) + args[1:]
    hiddens = [torch.randn(rows, Dh, generator=gen, device=dev).to(bf)
               for _ in range(6)]
    x_ln_part, y_part = torch.empty_like(part[0]), torch.empty_like(part[0])

    def fc2_over(which):
        def run():
            for h in which:
                ef._mlp_cuda(*part, eps=1e-6, parts=ef.MLP_PARTS["fc2"],
                             scratch=(x_ln_part, h, y_part))
        return run

    fc2_l2 = cuda_ms(fc2_over(hiddens[:1] * 6), 10) / 6
    fc2_hbm = cuda_ms(fc2_over(hiddens), 10) / 6

    # the two products alone, as torch.matmul on the same tensors: a
    # yardstick for the GEMMs, not a library call of the sublayer
    x_ln, hid, w1, w2 = scratch[0].reshape(M, D), scratch[1], args[3], args[5]
    matmul_ms = (cuda_ms(lambda: torch.matmul(x_ln, w1.t()), 10)
                 + cuda_ms(lambda: torch.matmul(hid, w2.t()), 10))
    del hiddens
    log(f"[encoder_mlp] ms per call {ms:.4f} ({plan['launches']} launches); "
        f"alone: layer norm {part_ms['layernorm']:.4f}, fc1 "
        f"{part_ms['fc1']:.4f}, fc2 {part_ms['fc2']:.4f}; fc2 of {rows} rows "
        f"with its hidden rows in L2 {fc2_l2:.4f}, from device memory "
        f"{fc2_hbm:.4f}; the two products as torch.matmul {matmul_ms:.4f}")

    for Bp_r, N_r in ((2, 1568), (2, 1571), (3, 1571)):
        err = max(err, hold(inputs(Bp_r, N_r)))
    bytes_ = 2 * M * D * 2 + 2 * D * Dh * 2 + (Dh + 3 * D) * 4
    flops = 4 * M * D * Dh
    return {
        "name": "encoder_mlp", "route": "cuda",
        "source": "vaura_tpu_torch/csrc/encoder_mlp.cu",
        "replaces": "vaura_tpu/ops/encoder_fused.py:366",
        "max_abs_err": err, "tol": TOL_SUBLAYER, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3,
        "bound_by": "operations", "library_ms": None,
        "launches_per_call": plan["launches"], 
        "ms_layernorm": part_ms["layernorm"], "ms_fc1": part_ms["fc1"],
        "ms_fc2": part_ms["fc2"], "ms_fc2_4224_rows_hidden_in_l2": fc2_l2,
        "ms_fc2_4224_rows_hidden_in_hbm": fc2_hbm, "matmul_ms": matmul_ms,
        "shape": f"M={M} D={D} Dh={Dh}",
    }


def check_grouped_cls_attention(gen):
    """Both axes of one unfused block at the flagship shapes: BH = 8
    segments x 12 heads, hd = 64; time G = 196, L = 8; space G = 8,
    L = 196."""
    import torch
    import torch.nn.functional as F

    from vaura_tpu_torch.ops import divided_attention as ga

    BH, hd = 96, 64
    dev, bf = "cuda", torch.bfloat16
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    err, tol, ms, plain_ms, library_ms, bound = 0.0, 0.0, 0.0, 0.0, 0.0, 0.0
    sum_b = sum_f = 0.0
    axis_ms = {}

    def hold(tag, got, args):
        """The kernel's output against the plain version and against the
        float32 evaluation, both within TOL_GROUPED_ULPS bf16 ulps of the
        largest output of this shape."""
        nonlocal err, tol
        want = ga.grouped_cls_attention_plain(*args)
        exact = ga.grouped_cls_attention_plain(*(t.float() for t in args))
        top = float(exact.abs().max())
        t = TOL_GROUPED_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)
        e, e32 = max_err(got, want), max_err(got, exact)
        log(f"[grouped_cls_attention] {tag} max_abs_err={e:.3e} (tol {t:.3e}, "
            f"|out| max {top:.3f}) mean_abs_err="
            f"{float((got.float() - want.float()).abs().mean()):.3e}; against "
            f"float32: kernel {e32:.3e}, plain {max_err(want, exact):.3e}")
        if not (e <= t and e32 <= t):
            raise AssertionError(f"{tag}: max_abs_err {e} / {e32} against "
                                 f"float32 exceed {t}")
        err, tol = max(err, e), max(tol, t)
        return exact

    def inputs(bh, G, L):
        q = (rnd(bh, G, L, hd) * hd ** -0.5).to(bf)
        return (q, rnd(bh, G, L, hd).to(bf), rnd(bh, G, L, hd).to(bf),
                rnd(bh, 1, hd).to(bf), rnd(bh, 1, hd).to(bf))

    # group lengths around the edges of the kernel's tiles (16 query rows,
    # chunks of 16 and 64 keys, the longest group), each with a ragged last
    # pack: errors only
    for G, L in ((21, 8), (11, 15), (9, 16), (9, 17), (3, 63), (3, 64),
                 (3, 65), (2, 196), (2, ga.MAX_GROUP_LEN)):
        args = inputs(6, G, L)
        plan = ga.grouped_plan(G * L, L)
        hold(f"G={G} L={L} packs {plan['n_packs']} x {plan['rows_per_pack']} "
             f"rows, last {plan['last_pack_rows']}",
             ga.grouped_cls_attention(*args), args)
    try:  # a longer group is off contract: the wrapper raises
        ga.grouped_cls_attention(*inputs(2, 2, ga.MAX_GROUP_LEN + 1))
    except ValueError:
        pass
    else:
        raise AssertionError("a group longer than MAX_GROUP_LEN did not raise")
    for axis, G, L in (("time", 196, 8), ("space", 8, 196)):
        args = q, k, v, ck, cv = inputs(BH, G, L)
        log(f"[grouped_cls_attention] {axis} plan {ga.grouped_plan(G * L, L)}")
        got = ga.grouped_cls_attention(*args)
        torch.cuda.synchronize()
        exact = hold(f"{axis} G={G} L={L}", got, args)

        # the autograd.Function on the card against autograd through the
        # plain version (its backward IS the plain version's, so the two
        # agree to the last bit) and against float32
        go = rnd(BH, G, L, hd).to(bf)
        leaves = lambda dt: [t.detach().to(dt).requires_grad_(True) for t in args]
        a, b, c = leaves(bf), leaves(bf), leaves(torch.float32)
        g_fn = torch.autograd.grad(ga.grouped_cls_attention(*a), a, go)
        g_plain = torch.autograd.grad(ga.grouped_cls_attention_plain(*b), b, go)
        g_exact = torch.autograd.grad(ga.grouped_cls_attention_plain(*c), c,
                                      go.float())
        d_plain = max(max_err(x, y) for x, y in zip(g_fn, g_plain))
        d_exact = max(max_err(x, y) / float(y.abs().max())
                      for x, y in zip(g_fn, g_exact))
        log(f"[grouped_cls_attention] {axis} gradients of q, k, v, cls_k, "
            f"cls_v: max abs diff to autograd of the plain version "
            f"{d_plain:.3e}, to float32 {d_exact:.3e} of the largest")
        if d_plain != 0.0 or not d_exact < 5e-2:
            raise AssertionError(f"{axis}: gradient mismatch {d_plain} "
                                 f"{d_exact}")

        # one library call computing the same function: SDPA over
        # [BH*G, 1, L, hd] queries against keys and values with the CLS row
        # concatenated. The concatenation is made here, OUTSIDE the timed
        # region; SDPA scales by 1/sqrt(hd) itself, so it gets q unscaled
        q4 = (q.float() * hd ** 0.5).to(bf).reshape(BH * G, 1, L, hd)
        cat = lambda c, t: torch.cat(
            [c[:, None].expand(BH, G, 1, hd), t], dim=2
        ).reshape(BH * G, 1, L + 1, hd).contiguous()
        k4, v4 = cat(ck, k), cat(cv, v)
        lib = F.scaled_dot_product_attention(q4, k4, v4).reshape(BH, G, L, hd)
        log(f"[grouped_cls_attention] {axis} SDPA against float32: "
            f"{max_err(lib, exact):.3e}")
        ms_axis = cuda_ms(lambda: ga.grouped_cls_attention_cuda(*args), 20)
        plain_axis = cuda_ms(lambda: ga.grouped_cls_attention_plain(*args), 5)
        lib_axis = cuda_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4), 20)
        # what the caller (models/motionformer.py::DividedAttention) pays
        # around the op for its group-major layout: q, k and v gathered out
        # of the qkv projection's [B, 1 + f*n, 3, H, hd] and the output
        # scattered back to [B, f*n, D]: four copies a call
        B_, f_, n_ = BH // 12, 8, 196
        qkv = rnd(B_, 1 + f_ * n_, 3, 12, hd).to(bf)
        perm, inv = (((0, 3, 2, 1, 4), (0, 3, 2, 1, 4)) if axis == "time"
                     else ((0, 3, 1, 2, 4), (0, 2, 3, 1, 4)))

        def layout_copies():
            for t in qkv.unbind(2):
                t[:, 1:].reshape(B_, f_, n_, 12, hd).permute(perm).reshape(
                    BH, G, L, hd)
            got.reshape(B_, 12, G, L, hd).permute(inv).reshape(
                B_, f_ * n_, 12 * hd)

        copies_axis = cuda_ms(layout_copies, 20)
        bytes_ = (4 * BH * G * L * hd + 2 * BH * hd) * 2
        flops = 4 * BH * G * L * (L + 1) * hd
        t_b, t_f = bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
        sum_b, sum_f = sum_b + t_b, sum_f + t_f
        log(f"[grouped_cls_attention] {axis} ms {ms_axis:.4f} plain "
            f"{plain_axis:.4f} library {lib_axis:.4f} bound "
            f"{max(t_b, t_f) * 1e3:.4f} ({bytes_ / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP); the caller's four layout copies "
            f"{copies_axis:.4f}")
        ms, plain_ms = ms + ms_axis, plain_ms + plain_axis
        library_ms, bound = library_ms + lib_axis, bound + max(t_b, t_f) * 1e3
        axis_ms[axis] = {"ms": ms_axis, "plain_ms": plain_axis,
                         "library_ms": lib_axis,
                         "layout_copies_ms": copies_axis}
    return {
        "name": "grouped_cls_attention", "route": "cuda",
        "source": "vaura_tpu_torch/csrc/grouped_cls_attention.cu",
        "replaces": "vaura_tpu/ops/divided_attention.py:126",
        "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": "bytes" if sum_b >= sum_f else "operations",
        "library_ms": library_ms, "library": "F.scaled_dot_product_attention",
        "axes": axis_ms,
        "shape": f"BH={BH} hd={hd}, time (G=196, L=8) + space (G=8, L=196) "
                 "of one block",
    }


# ---------------------------------------------------------------------------
def _counters():
    from vaura_tpu_torch.ops import decode_attention as da
    from vaura_tpu_torch.ops import divided_attention as ga
    from vaura_tpu_torch.ops import encoder_fused as ef

    return {"decode_attention": da.launches - da.int8_launches,
            "decode_attention_int8": da.int8_launches,
            "encoder_attention": ef.attention_launches,
            "encoder_mlp": ef.mlp_launches,
            "grouped_cls_attention": ga.launches}


def _zero_counters():
    from vaura_tpu_torch.ops import decode_attention as da
    from vaura_tpu_torch.ops import divided_attention as ga
    from vaura_tpu_torch.ops import encoder_fused as ef

    da.launches = ef.attention_launches = ef.mlp_launches = ga.launches = 0
    da.device_pos_launches = da.int8_launches = 0


def phase_main(gen, report):
    import torch

    from vaura_tpu_torch.flagship import GENERATE_KW, flagship_system, random_frames

    system = flagship_system("cuda", gen)
    frames = random_frames(2, gen, "cuda")
    n_steps = system.prepare_generation(GENERATE_KW["max_new_tokens"])[2] - 1
    expected = {
        "decode_attention": system.sampler_config.num_layers * n_steps,
        "encoder_attention": 2 * system.encoder.cfg.depth,
        "encoder_mlp": system.encoder.cfg.depth,
    }
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.time()
    out = system.generate(frames, seed=0, **GENERATE_KW)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _counters()
    from vaura_tpu_torch.ops import decode_attention as da
    device_pos = da.device_pos_launches
    expected["grouped_cls_attention"] = 0  # inference takes the fused blocks
    expected["decode_attention_int8"] = 0
    codes, audio = out["codes"], out["audio"]
    report["main"] = {
        "wall_s": wall, "stage_ms": out["stage_ms"], "launches": launches,
        "expected_launches": expected,
        "decode_attention_device_pos_launches": device_pos,
        "codes_shape": list(codes.shape),
        "audio_shape": list(audio.shape),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    log(f"[main] wall {wall:.2f} s, stages (ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in out["stage_ms"].items()))
    log(f"[main] launches {launches} expected {expected}; decode attention "
        f"launches with pos in device memory: {device_pos}")
    log(f"[main] codes {tuple(codes.shape)} in [{int(codes.min())}, "
        f"{int(codes.max())}], audio {tuple(audio.shape)} "
        f"rms {float(audio.float().pow(2).mean().sqrt()):.4f}")
    problems = []
    if tuple(codes.shape) != (2, 9, 221):
        problems.append(f"codes shape {tuple(codes.shape)}")
    if int(codes.min()) < 0 or int(codes.max()) > 1024:
        problems.append("codes outside [0, 1024]")
    if tuple(audio.shape) != (2, 1, 113152):
        problems.append(f"audio shape {tuple(audio.shape)}")
    if not bool(torch.isfinite(audio).all()):
        problems.append("audio not finite")
    for name, n in expected.items():
        if launches[name] != n:
            problems.append(f"{name}: {launches[name]} launches, expected {n}")
    if device_pos != expected["decode_attention"]:
        problems.append(f"decode_attention: {device_pos} launches took pos "
                        "from device memory, expected all")
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


def _check_generation(tag, out, codes_shape, problems):
    """Codes of ``codes_shape`` in [0, 1024] and finite audio of as many
    samples as codes times the hop."""
    import torch

    codes, audio = out["codes"], out["audio"]
    log(f"[{tag}] codes {tuple(codes.shape)} in [{int(codes.min())}, "
        f"{int(codes.max())}], audio {tuple(audio.shape)} rms "
        f"{float(audio.float().pow(2).mean().sqrt()):.4f}")
    if tuple(codes.shape) != codes_shape:
        problems.append(f"{tag}: codes shape {tuple(codes.shape)}")
    if int(codes.min()) < 0 or int(codes.max()) > 1024:
        problems.append(f"{tag}: codes outside [0, 1024]")
    if tuple(audio.shape) != (codes_shape[0], 1, codes_shape[2] * 512):
        problems.append(f"{tag}: audio shape {tuple(audio.shape)}")
    if not bool(torch.isfinite(audio).all()):
        problems.append(f"{tag}: audio not finite")


def phase_int8(gen, report):
    """The flagship generation with the int8 KV cache (bf16 weights, the
    JAX package's serving default): every decode step of every layer through
    the kernel's int8 instantiation, ``pos`` from device memory."""
    import torch

    from vaura_tpu_torch.flagship import GENERATE_KW, flagship_system, random_frames
    from vaura_tpu_torch.ops import decode_attention as da

    system = flagship_system("cuda", gen,
                             sampler_overrides={"quantize_cache": True})
    frames = random_frames(2, gen, "cuda")
    n_steps = system.prepare_generation(GENERATE_KW["max_new_tokens"])[2] - 1
    depth = system.encoder.cfg.depth
    expected = {"decode_attention": 0,
                "decode_attention_int8": system.sampler_config.num_layers * n_steps,
                "encoder_attention": 2 * depth, "encoder_mlp": depth,
                "grouped_cls_attention": 0}
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.time()
    out = system.generate(frames, seed=0, **GENERATE_KW)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, device_pos = _counters(), da.device_pos_launches
    report["int8"] = {"wall_s": wall, "stage_ms": out["stage_ms"],
                      "launches": launches, "expected_launches": expected,
                      "decode_attention_device_pos_launches": device_pos}
    log(f"[int8] wall {wall:.2f} s, stages (ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in out["stage_ms"].items()))
    log(f"[int8] launches {launches} expected {expected}; with pos in device "
        f"memory: {device_pos}")
    problems = []
    _check_generation("int8", out, (2, 9, 221), problems)
    if launches != expected:
        problems.append(f"launches {launches}, expected {expected}")
    if device_pos != expected["decode_attention_int8"]:
        problems.append(f"{device_pos} decode launches took pos from device "
                        "memory, expected all")
    del system
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


def phase_long(gen, report):
    """5.12 s (441 tokens) from frames [2, 8, 3, 16, 224, 224] at flagship
    width: ``generate_long`` at a stride of 55 tokens (chunks of 221 whose
    166-token prompts go through ``prefill``), ``generate_long_kv`` with a
    window of 4 x 56 steps (chunks drop), and ``generate_long_kv_stream``
    under the seed of that run, whose increments must concatenate to it
    (the DAC in float32 for that comparison). Counters zeroed before and
    read after each run."""
    import torch

    from vaura_tpu_torch.flagship import (
        GENERATE_KW,
        LONG_KV_KW,
        LONG_SAMPLER,
        flagship_system,
        random_frames,
    )
    from vaura_tpu_torch.ops import decode_attention as da

    torch.cuda.empty_cache()
    system = flagship_system("cuda", gen, sampler_overrides=LONG_SAMPLER)
    frames = random_frames(2, gen, "cuda", segments=8)
    total, stride, max_tokens = 441, 55, 221
    L, depth = system.sampler_config.num_layers, system.encoder.cfg.depth
    sampling = {k: GENERATE_KW[k] for k in ("cfg_scale", "top_k",
                                            "tokens_per_frame")}
    problems, res = [], {}

    # decode steps of generate_long: a chunk of n tokens has S = n + 9
    # steps; the first starts at step 1, the others at the step of the
    # prompt's first timestep to generate (+ 1 for the BOS row)
    sizes = system.long_chunk_schedule(total, stride, max_tokens)
    steps, prompt = 0, 0
    for n_new in sizes:
        S = system.prepare_generation(n_new + prompt)[2]
        steps += S - (1 if prompt == 0 else prompt + 1)
        prompt = max(0, n_new + prompt - stride)
    encoder_launches = {"encoder_attention": 2 * depth, "encoder_mlp": depth,
                        "grouped_cls_attention": 0,
                        "decode_attention_int8": 0}

    def drive(tag, fn, expect_decode, **kw):
        torch.cuda.synchronize()
        _zero_counters()
        t0 = time.time()
        out = fn(frames, **sampling, **kw)
        if not isinstance(out, dict):
            out = list(out)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = _counters()
        want = dict(encoder_launches, decode_attention=expect_decode)
        res[tag] = {"wall_s": wall, "launches": launches,
                    "expected_launches": want,
                    "device_pos_launches": da.device_pos_launches}
        if isinstance(out, dict):
            res[tag]["stage_ms"] = out["stage_ms"]
        log(f"[long] {tag}: wall {wall:.2f} s, launches {launches}")
        if launches != want:
            problems.append(f"{tag}: launches {launches}, expected {want}")
        if da.device_pos_launches != expect_decode:
            problems.append(f"{tag}: {da.device_pos_launches} decode launches "
                            "took pos from device memory")
        return out

    # one prefill of a chunk (B2 = 4 with CFG, 230 positions), warm: its
    # time between two events and on the host's clock
    toks = torch.randint(0, 1024, (4, 9, 230), generator=gen, device="cuda")
    cond = torch.randn(4, 230, system.sampler_config.cond_dim, generator=gen,
                       device="cuda", dtype=torch.bfloat16)
    system.sampler.prefill(toks, cond)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t0 = time.time()
    ev[0].record()
    system.sampler.prefill(toks, cond)
    ev[1].record()
    torch.cuda.synchronize()
    res["prefill"] = {"ms": ev[0].elapsed_time(ev[1]),
                      "wall_ms": (time.time() - t0) * 1e3}
    log(f"[long] one prefill of 230 positions at B2=4: {res['prefill']}")
    del toks, cond

    out = drive("generate_long", system.generate_long, L * steps, seed=0,
                total_tokens=total, stride_tokens=stride,
                model_max_tokens=max_tokens)
    _check_generation("long generate_long", out, (2, 9, total), problems)
    del out

    S_kv = system.prepare_generation(total)[2]
    kv = dict(LONG_KV_KW, total_tokens=total, seed=1)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        one = drive("generate_long_kv", system.generate_long_kv,
                    L * (S_kv - 1), **kv)
        chunks = drive("generate_long_kv_stream",
                       system.generate_long_kv_stream, L * (S_kv - 1), **kv)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    _check_generation("long generate_long_kv", one, (2, 9, total), problems)
    codes = torch.cat([c["codes"] for c in chunks], dim=-1)
    audio = torch.cat([c["audio"] for c in chunks], dim=-1)
    want = one["audio"].reshape(audio.shape[0], -1)
    starts_ok, n = True, 0
    for c in chunks:
        starts_ok &= c["token_start"] * 512 == n
        n += c["audio"].shape[-1]
    same_codes = torch.equal(codes, one["codes"])
    rel = (float((audio - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
           if audio.shape == want.shape else float("inf"))
    res["stream"] = {"increments": len(chunks), "codes_equal": same_codes,
                     "audio_rel_rms": rel, "token_starts_line_up": starts_ok,
                     "audio_max_abs": max_err(audio, want)
                     if audio.shape == want.shape else None}
    log(f"[long] stream: {len(chunks)} increments, codes equal {same_codes}, "
        f"audio rel rms {rel:.3e} (tol {TOL_REF_AUDIO}), token_start lines up "
        f"{starts_ok}")
    if not (same_codes and rel <= TOL_REF_AUDIO and starts_ok
            and len(chunks) >= 2):
        problems.append(f"stream against one-shot: {res['stream']}")
    report["long"] = res
    del system, one, chunks
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))


def phase_train(gen, report):
    """Three training steps and one eval step of the flagship training
    configuration on one seeded batch."""
    import torch

    from vaura_tpu_torch.flagship import (
        flagship_system,
        flagship_train_state,
        random_train_batch,
    )
    from vaura_tpu_torch.train.steps import make_eval_step, make_train_step
    from vaura_tpu_torch.utils import StageClock

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    system = flagship_system("cuda", gen, training=True)
    state = flagship_train_state(system)
    batch = random_train_batch(2, gen, "cuda")
    train_step, eval_step = make_train_step(system), make_eval_step(system)
    n_trainable = sum(p.numel() for p in state.params.values())
    depth = system.encoder.cfg.depth

    # a cheap fingerprint of every leaf (float64 sum and sum of magnitudes):
    # equal fingerprints for an untouched leaf, different ones after any
    # update that is not a pure permutation
    mark = lambda: {k: (float(p.detach().double().sum()),
                        float(p.detach().double().abs().sum()))
                    for k, p in system.named_parameters()}
    before = mark()
    problems, steps, launches = [], [], dict.fromkeys(_counters(), 0)
    for i in range(3):
        torch.cuda.synchronize()
        _zero_counters()
        clock = StageClock(system.device)
        clock.mark("start")
        t0 = time.time()
        state, metrics = train_step(state, batch, gen, clock=clock)
        ms = clock.ms()
        wall = (time.time() - t0) * 1e3
        seen = _counters()
        steps.append({"loss": float(metrics["loss"]), "wall_ms": wall, **ms,
                      "launches": seen})
        log(f"[train] step {i}: loss {steps[-1]['loss']:.5f} wall {wall:.1f} "
            f"ms (forward {ms['forward']:.1f}, backward {ms['backward']:.1f}, "
            f"optimizer {ms['optimizer']:.1f}) launches {seen}")
        want = {"grouped_cls_attention": 2 * depth, "encoder_attention": 0,
                "encoder_mlp": 0, "decode_attention": 0,
                "decode_attention_int8": 0}
        if seen != want:
            problems.append(f"step {i}: launches {seen}, expected {want}")
        for k, n in seen.items():
            launches[k] += n
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    after = mark()

    _zero_counters()
    ev = eval_step(batch)
    torch.cuda.synchronize()
    ev_seen = _counters()
    log(f"[train] eval_step loss {float(ev['loss']):.5f} launches {ev_seen}")
    if (ev_seen["encoder_attention"], ev_seen["encoder_mlp"],
            ev_seen["grouped_cls_attention"]) != (2 * depth, depth, 0):
        problems.append(f"eval_step launches {ev_seen}")

    losses = [s["loss"] for s in steps] + [float(ev["loss"])]
    if not all(math.isfinite(x) for x in losses):
        problems.append(f"losses not finite: {losses}")
    if abs(losses[0] - math.log(1024)) > 1e-2:
        problems.append(f"first loss {losses[0]} is not ln 1024")
    # the steps' own losses carry three different sets of dropout masks
    # (noise of about 2e-3 here, as large as three warm-up steps' gain), so
    # learning is read where no mask enters: the eval loss after the steps
    # against the first loss (ln 1024 by the zero-initialised head)
    if not losses[3] < losses[0] - 1e-3:
        problems.append(f"loss did not fall: {losses}")
    unchanged = [k for k in state.params
                 if after[k] == before[k] and not k.endswith("uncond_embedding")]
    moved = [k for k in after if after[k] != before[k]
             and (k.startswith("dac.") or k.endswith("uncond_embedding"))]
    if unchanged:
        problems.append(f"{len(unchanged)} trainable leaves unchanged: "
                        f"{unchanged[:5]}")
    if moved:
        problems.append(f"frozen leaves changed: {moved[:5]}")
    report["train"] = {
        "steps": steps, "eval_loss": float(ev["loss"]), "eval_launches": ev_seen,
        "peak_mem_gib": peak, "trainable_parameters": n_trainable,
        "trainable_leaves": len(state.params), "batch": 2,
    }
    log(f"[train] {n_trainable / 1e9:.3f} G trainable parameters in "
        f"{len(state.params)} leaves; peak memory {peak:.2f} GiB")
    del state, system
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


def _reference_train(gen, res):
    """``train_forward`` at flagship widths and cut depth, every stochastic
    rate 0, from ``codes=`` (the RVQ's argmax may flip between two devices):
    loss and the gradients of a few named leaves, card against CPU."""
    import torch

    from vaura_tpu_torch.flagship import flagship_system

    kw = dict(sampler_layers=2, encoder_depth=1, training=True,
              sampler_overrides={"dropout": 0.0, "class_dropout_prob": 0.0},
              encoder_overrides={"drop_path_rate": 0.0})
    card = flagship_system("cuda", gen, **kw)
    # the zero-initialised head would make every other gradient zero
    with torch.no_grad():
        card.sampler.lm_head.weight.normal_(0.0, 0.02, generator=gen)
    cpu = flagship_system("cpu", **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    frames = torch.randn(1, 1, 3, 16, 224, 224, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
    codes = torch.randint(0, 1024, (1, 9, 24), generator=gen, device="cuda")
    leaves = ["sampler.lm_head.weight", "sampler.layers.0.attention.wqkv.weight",
              "sampler.cls_embeddings.fc1.weight",
              "encoder.blocks.0.timeattn.qkv.weight",
              "encoder.blocks.0.attn.proj.weight",
              "encoder.blocks.0.mlp.fc1.weight", "encoder.patch_embed_3d.weight"]

    def run(system, f, c):
        named = dict(system.named_parameters())
        loss, _ = system.train_forward(f, None, None, train=True, codes=c)
        grads = torch.autograd.grad(loss, [named[k] for k in leaves])
        return float(loss.detach()), [g.float().cpu() for g in grads]

    la, ga_ = run(card, frames, codes)
    lb, gb = run(cpu, frames.cpu(), codes.cpu())
    res["train_loss"] = [la, lb]
    res["train_grad_rel"] = {
        k: max_err(a, b) / float(b.abs().max()) for k, a, b in zip(leaves, ga_, gb)}
    log(f"[reference] train_forward loss card {la:.5f} cpu {lb:.5f} (tol "
        f"{TOL_REF_LOSS}); gradient error relative to the leaf's largest "
        f"(tol {TOL_REF_GRAD}): "
        + ", ".join(f"{k} {v:.2e}" for k, v in res["train_grad_rel"].items()))

    # the DAC encoder's latent in full float32 (TF32 off), relative RMS
    audio = 0.3 * torch.randn(1, 1, 16 * 512, generator=gen, device="cuda")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        za = card.dac.encode_latent(audio).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    zb = cpu.dac.encode_latent(audio.cpu())
    res["latent_rel_rms"] = float((za - zb).pow(2).mean().sqrt()
                                  / zb.pow(2).mean().sqrt())
    log(f"[reference] DAC encoder latent rel rms err "
        f"{res['latent_rel_rms']:.3e} (tol {TOL_REF_AUDIO})")
    if not (abs(la - lb) <= TOL_REF_LOSS
            and all(v <= TOL_REF_GRAD for v in res["train_grad_rel"].values())
            and res["latent_rel_rms"] <= TOL_REF_AUDIO):
        raise AssertionError(f"card and CPU disagree in training: {res}")


def _reference_int8(gen, res):
    """The int8 cache at flagship widths and cut depth, card against CPU:
    ``prefill`` over 80 positions of a prompt (the card runs its plain
    PyTorch attention, as the JAX package runs einsums), then decode steps
    at positions 70..79 over the int8 cache it made (the card through the
    kernel's int8 instantiation, the CPU through the plain version)."""
    import torch

    from vaura_tpu_torch.flagship import flagship_system

    kw = dict(sampler_layers=2, encoder_depth=1,
              sampler_overrides={"quantize_cache": True})
    card = flagship_system("cuda", gen, **kw)
    cpu = flagship_system("cpu", **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    cfg = card.sampler_config
    T, P, B2 = 80, 70, 2
    toks = torch.randint(0, cfg.d_codebook, (B2, cfg.num_codebooks, T),
                         generator=gen, device="cuda")
    cond = torch.randn(B2, T, cfg.cond_dim, generator=gen, device="cuda",
                       dtype=cfg.dtype)
    rel = lambda a, b: max_err(a.cpu(), b) / float(b.float().abs().max())
    la, ca = card.sampler.prefill(toks, cond)
    lb, cb = cpu.sampler.prefill(toks.cpu(), cond.cpu())
    res["prefill_logits"] = rel(la, lb)
    worst = 0.0
    for pos in range(P, T):
        a = card.sampler.decode_step(toks[:, :, pos:pos + 1],
                                     cond[:, pos:pos + 1], ca, pos)
        b = cpu.sampler.decode_step(toks[:, :, pos:pos + 1].cpu(),
                                    cond[:, pos:pos + 1].cpu(), cb, pos)
        worst = max(worst, rel(a, b))
    res["int8_logits"] = worst
    log(f"[reference] prefill logits rel err {res['prefill_logits']:.3e}, "
        f"int8-cache decode logits rel err {worst:.3e} (tol {TOL_REF_REL})")
    if not (res["prefill_logits"] <= TOL_REF_REL and worst <= TOL_REF_REL):
        raise AssertionError(f"card and CPU disagree on the int8 cache: {res}")


def phase_reference(gen, report):
    """Flagship widths, 2 sampler layers and 1 encoder block, one segment:
    the card (kernels) against the CPU (plain versions), same weights."""
    import torch

    from vaura_tpu_torch.flagship import flagship_system

    card = flagship_system("cuda", gen, sampler_layers=2, encoder_depth=1)
    cpu = flagship_system("cpu", sampler_layers=2, encoder_depth=1)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    res = {}

    frames = torch.randn(1, 1, 3, 16, 224, 224, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
    fa, fb = card.visual_features(frames), cpu.visual_features(frames.cpu())
    res["features"] = max_err(fa.cpu(), fb) / float(fb.float().abs().max())

    # teacher-forced decode over 70 positions (crosses the 64-position tile)
    cfg = card.sampler_config
    T, B2 = 70, 2
    toks = torch.randint(0, cfg.d_codebook, (B2, cfg.num_codebooks, T),
                         generator=gen, device="cuda")
    cond = torch.randn(B2, T, cfg.cond_dim, generator=gen, device="cuda",
                       dtype=cfg.dtype)
    ca, cb = card.sampler.init_cache(B2, T), cpu.sampler.init_cache(B2, T)
    worst = 0.0
    for pos in range(T):
        la = card.sampler.decode_step(toks[:, :, pos:pos + 1],
                                      cond[:, pos:pos + 1], ca, pos)
        lb = cpu.sampler.decode_step(toks[:, :, pos:pos + 1].cpu(),
                                     cond[:, pos:pos + 1].cpu(), cb, pos)
        worst = max(worst, max_err(la.cpu(), lb) / float(lb.float().abs().max()))
    res["logits"] = worst

    # the DAC in full float32 (TF32 off for the check), relative RMS error:
    # with random weights its output is saturated by the final tanh and its
    # ~30 Snake layers (gain up to 2 each) magnify any rounding difference
    # near a zero crossing, so the largest single-sample difference says
    # little; TF32's 1e-3 relative rounding, the cuDNN default the main
    # path keeps, is reported beside it
    codes = torch.randint(0, 1024, (1, 9, 16), generator=gen, device="cuda")
    ab = cpu.decode_audio(codes.cpu())
    rel_rms = lambda a: float((a.cpu() - ab).pow(2).mean().sqrt()
                              / ab.pow(2).mean().sqrt())
    res["audio_rel_rms_tf32"] = rel_rms(card.decode_audio(codes))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        aa = card.decode_audio(codes)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    res["audio_rel_rms"] = rel_rms(aa)
    res["audio_max_abs"] = max_err(aa.cpu(), ab)
    report["reference"] = res
    log(f"[reference] features rel err {res['features']:.3e}, logits rel err "
        f"{res['logits']:.3e} (tol {TOL_REF_REL}); audio rel rms err "
        f"{res['audio_rel_rms']:.3e} (tol {TOL_REF_AUDIO}; max abs "
        f"{res['audio_max_abs']:.3e}; with TF32 rel rms "
        f"{res['audio_rel_rms_tf32']:.3e})")
    if not (res["features"] <= TOL_REF_REL and res["logits"] <= TOL_REF_REL
            and res["audio_rel_rms"] <= TOL_REF_AUDIO):
        raise AssertionError(f"card and CPU disagree: {res}")
    del card, cpu
    _reference_train(gen, res)
    _reference_int8(gen, res)


# the generate action's runs: (tag, config, extra CLI arguments, batch,
# tokens); every run takes the dummy datamodule, one batch, and writes its
# WAV and codes files under chiprun_out/action/<tag>
ACTION_RUNS = (
    ("vgg_bf16", "configs/generate_vgg.yaml", [], 16, int(2.56 * 86)),
    ("vgg_int8", "configs/generate_vgg.yaml", ["quantize=true"], 16,
     int(2.56 * 86)),
    ("sparse_stream_kv", "configs/generate_vgg_sparse.yaml",
     ["long_mode=stream_kv", "dataloader.batch_size=2",
      "dataloader.video_length=5.12", "dataloader.num_clips=8"], 2,
     int(5.12 * 86)),
)


def phase_action(gen, report):
    """The generate action as a user runs it, ``vaura_tpu_torch.main`` from
    the repo's configs (the flagship model of ``configs/vaura_defaults.yaml``
    with seeded random weights, the dummy datamodule): ``generate_vgg.yaml``
    at its own batch of 16 with the bf16 cache and with ``quantize=true``,
    and ``generate_vgg_sparse.yaml`` (5.12 s) with ``long_mode=stream_kv`` at
    batch 2. Counters zeroed before and read after each run; each run must
    generate its whole batch, write finite WAVs of the expected length and
    codes in [0, 1024), and launch its decode kernel and both encoder
    kernels."""
    import shutil

    import numpy as np
    import torch

    from vaura_tpu_torch.main import main
    from vaura_tpu_torch.ops.audio import read_wav
    from vaura_tpu_torch.ops.patterns import DelayedPatternProvider

    root = os.path.join(OUT_DIR, "action")
    shutil.rmtree(root, ignore_errors=True)
    res, problems, total = {}, [], {}
    for tag, config, extra, batch, tokens in ACTION_RUNS:
        out_dir = os.path.join(root, tag)
        argv = [f"config={os.path.join(ROOT, config)}",
                "dataloader.dataset_type=dummy", "dataloader.num_workers=0",
                "max_batches=1", "return_sampled_indices=true",
                f"output_dir={out_dir}", *extra]
        steps = DelayedPatternProvider(9).get_pattern(tokens)._build_seq_tables(
            tokens)[1].shape[1] - 1
        decode = "decode_attention_int8" if "quantize=true" in extra else \
            "decode_attention"
        want = {"decode_attention": 0, "decode_attention_int8": 0,
                "encoder_attention": 24, "encoder_mlp": 12,
                "grouped_cls_attention": 0}
        want[decode] = 24 * steps
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        _zero_counters()
        t0 = time.time()
        result = main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = _counters()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        audio_s = batch * tokens / 86
        stage_ms = result.get("stage_ms", {})
        res[tag] = {"config": config, "extra": extra, "batch": batch,
                    "tokens": tokens, "wall_s": wall,
                    "audio_s_per_s": audio_s / wall, "stage_ms": stage_ms,
                    "decode_loop_share": stage_ms.get("decode_loop", 0.0)
                    / 1e3 / wall,
                    "num_generated": result["num_generated"],
                    "launches": launches, "expected_launches": want}
        log(f"[action] {tag}: {config} {' '.join(extra)}: "
            f"{result['num_generated']} clips, wall {wall:.2f} s, "
            f"{audio_s / wall:.3f} audio-s/s, stages (ms) "
            + ", ".join(f"{k} {v:.1f}" for k, v in stage_ms.items())
            + f", launches {launches}")
        if result["num_generated"] != batch:
            problems.append(f"{tag}: {result['num_generated']} clips of "
                            f"{batch}")
        if launches != want:
            problems.append(f"{tag}: launches {launches}, expected {want}")
        for i in range(batch):
            wav_path = os.path.join(out_dir, f"{i}.wav")
            codes_path = os.path.join(out_dir, f"{i}.codes.npy")
            if not (os.path.exists(wav_path) and os.path.exists(codes_path)):
                problems.append(f"{tag}: clip {i} not written")
                continue
            wav, sr = read_wav(wav_path)
            codes = np.load(codes_path)
            if (sr != 44100 or wav.shape != (1, tokens * 512)
                    or not np.isfinite(wav).all() or float(wav.std()) == 0.0):
                problems.append(f"{tag}: clip {i} wav {wav.shape} at {sr} Hz, "
                                f"std {float(wav.std())}")
            if codes.shape != (9, tokens) or codes.min() < 0 or codes.max() >= 1024:
                problems.append(f"{tag}: clip {i} codes {codes.shape} in "
                                f"[{codes.min()}, {codes.max()}]")
    res["launches"] = total
    report["action"] = res
    print("action: " + json.dumps({t: {k: res[t][k] for k in (
        "batch", "tokens", "wall_s", "audio_s_per_s", "decode_loop_share")}
        for t, *_ in ACTION_RUNS}), flush=True)
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))
    return total


# the train action's runs (``configs/experiments/flagship_smoke.yaml``: the
# full encoder, the 24-layer sampler, the 44.1 kHz codec, bf16 compute,
# the dummy datamodule): A trains two epochs of 3 steps with a frozen
# encoder, as the main experiment does, with the predict media of every
# epoch and a validation after each of the first two steps (every scalar tag
# of the Trainer); B resumes A's `last` for a third epoch with async saves;
# C tests A's best checkpoint; D trains 2 steps with the encoder unfrozen
TRAIN_CONFIG = "configs/experiments/flagship_smoke.yaml"
TRAIN_A = ["trainer.fast_dev_run=false", "trainer.max_epochs=2",
           "trainer.limit_train_batches=3", "trainer.limit_val_batches=2",
           "trainer.limit_test_batches=2", "trainer.val_check_interval=0.5",
           "model.predict_at_val_start=true",
           "model.plot_distr_of_pred_indices=true",
           "model.return_attention_weights=true",
           "model.flatten_vis_feats=true"]
TRAIN_D = ["trainer.fast_dev_run=false", "trainer.max_epochs=1",
           "trainer.limit_train_batches=2", "trainer.limit_val_batches=1",
           "trainer.limit_test_batches=1",
           "model.freeze_feature_extractor=false"]
# C against A: the same restored parameters through the same kernels on one
# card, so the losses (means of float32 cross entropies of bf16 logits) are
# expected equal; 1e-3 is a thirtieth of a bf16 ulp at ln 1024 (2^-5)
# (measured: 0.0)
TOL_TEST_LOSS = 1e-3


def _train_run(tag, argv, log_dir, want, res, total, problems):
    """One train or test action through ``vaura_tpu_torch.main``, counters
    zeroed before and read after; its wall, step, validation, save and
    restore times, peak memory and launches go into ``res[tag]``."""
    import torch

    from vaura_tpu_torch.main import main

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.time()
    out = main([f"config={os.path.join(ROOT, TRAIN_CONFIG)}",
                f"trainer.log_dir={log_dir}", *argv])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _counters()
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    stats = out.get("stats", {})
    steps = stats.get("step_ms", [])
    mean = lambda xs: sum(xs) / len(xs) if xs else None
    parts = ("forward", "backward", "optimizer")
    # a run's first step carries the first use of every library and
    # allocation; the mean is over the steps after it
    r = {"wall_s": wall, "launches": launches, "expected_launches": want,
         "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
         "steps": len(steps),
         "first_step_ms": {k: steps[0][k] for k in parts} if steps else {},
         "step_ms": {k: mean([s[k] for s in steps[1:]]) for k in parts},
         "val_ms": mean(stats.get("val_ms", [])),
         "media_s": stats.get("media_s", []),
         "save_s": stats.get("save_s", []),
         "restore_s": stats.get("restore_s", [])}
    r["test_loss"] = (out["metrics"] if "metrics" in out else out)["test_loss"]
    r["root"] = _glob_one(log_dir, "*")
    res[tag] = r
    log(f"[train_action] {tag}: wall {wall:.2f} s, {len(steps)} steps: "
        "first " + ", ".join(f"{k} {v:.1f}" for k, v in
                             r["first_step_ms"].items())
        + " ms, then a mean of "
        + ", ".join(f"{k} {v:.1f}" for k, v in r["step_ms"].items() if v)
        + f" ms, validation {r['val_ms'] or 0:.1f} ms, predict media "
        f"{[round(x, 2) for x in r['media_s']]} s, saves "
        f"{[round(x, 2) for x in r['save_s']]} s, restores "
        f"{[round(x, 2) for x in r['restore_s']]} s, peak "
        f"{r['peak_mem_gib']:.2f} GiB, test loss {r['test_loss']:.5f}, "
        f"launches {launches}")
    if launches != want:
        problems.append(f"{tag}: launches {launches}, expected {want}")


def _glob_one(root, pattern):
    import glob

    (path,) = glob.glob(os.path.join(root, pattern))
    return path


def _epoch_checkpoints(root):
    ck = os.path.join(root, "checkpoints")
    return sorted(n.split("-val_loss=")[0] for n in os.listdir(ck)
                  if n.startswith("epoch="))


def phase_train_action(gen, report):
    """The train and test actions as a user runs them (runs A-D above, at
    flagship width with seeded random weights). Checks: finite losses, the
    first step's loss ``ln 1024``, the steps and epochs of each run, the
    checkpoints and every TensorBoard tag the Trainer logs (read back with
    the port's own reader), the resumed early-stop state, C's test loss
    equal to A's, and every kernel's launches: both encoder kernels once per
    encoder forward (each train, validation and test step, each predict
    generation and its attention forward), decode attention 24 x the decode
    steps of each predict generation, ``grouped_cls_attention`` 24 per
    unfrozen training step and never with the encoder frozen. The run
    directories are deleted at the end."""
    import shutil
    import tempfile

    from vaura_tpu_torch.ops.patterns import DelayedPatternProvider
    from vaura_tpu_torch.utils.experiment import resolve_best_checkpoint
    from vaura_tpu_torch.utils.tb import read_events

    tmp = tempfile.mkdtemp(prefix="train_action_")
    res, problems, total = {}, [], {}
    # 221 predict tokens (flatten_vis_feats) over the 9-codebook delay
    pred_steps = DelayedPatternProvider(9).get_pattern(221)._build_seq_tables(
        221)[1].shape[1] - 1

    def want(fwd, decode_gens=0, grouped_steps=0):
        return {"decode_attention": 24 * pred_steps * decode_gens,
                "decode_attention_int8": 0, "encoder_attention": 24 * fwd,
                "encoder_mlp": 12 * fwd,
                "grouped_cls_attention": 24 * grouped_steps}

    try:
        # A: 6 steps, 2 x (2 mid-epoch + 1 end) validations of 2 batches,
        # 2 test batches, 2 predict generations and attention forwards
        _train_run("A", TRAIN_A, os.path.join(tmp, "A"),
                   want(6 + 12 + 2 + 2 + 2, decode_gens=2), res, total,
                   problems)
        a_root = res["A"]["root"]
        ev = read_events(_glob_one(a_root, "events.out.tfevents.*"))
        tags = {e["tag"] for e in ev}
        need = {"train_loss_step", "lr", "train_loss_epoch", "val_loss_step",
                "val_loss_epoch", "test_loss_epoch", "generated_audio/0",
                "conditioned_frames/0", "sampled_indices/0",
                "s_attention_weights/0", "custom_scalars__config__"}
        need |= {f"{s}_loss_per_codebook_{i}" for s in ("val", "test")
                 for i in range(9)}
        if need - tags:
            problems.append(f"A: TensorBoard tags missing: {sorted(need - tags)}")
        steps = [(e["step"], e["value"]) for e in ev
                 if e["tag"] == "train_loss_step"]
        losses = [e["value"] for e in ev
                  if e["kind"] == "scalar" and "loss" in e["tag"]]
        res["A"]["train_loss_step"] = steps
        if [s for s, _ in steps] != list(range(1, 7)):
            problems.append(f"A: train_loss_step at steps {[s for s, _ in steps]}")
        if not all(math.isfinite(x) for x in losses):
            problems.append("A: losses not finite")
        if not steps or abs(steps[0][1] - math.log(1024)) > 1e-2:
            problems.append(f"A: first loss {steps[:1]} is not ln 1024")
        if _epoch_checkpoints(a_root) != ["epoch=0-step=3", "epoch=1-step=6"]:
            problems.append(f"A: checkpoints {_epoch_checkpoints(a_root)}")
        ck = os.path.join(a_root, "checkpoints")
        if not (os.path.islink(os.path.join(ck, "last"))
                and os.path.isdir(os.path.join(ck, "frozen"))):
            problems.append("A: `last` or the frozen save is missing")
        with open(os.path.join(ck, "last", "meta.json")) as f:
            a_meta = json.load(f)
        shutil.copy(_glob_one(a_root, "events.out.tfevents.*"),
                    os.path.join(OUT_DIR, "train_action_A.tfevents"))

        # B: resume A's last for epoch 2 only (3 steps, 3 validations, the
        # test, 1 predict generation)
        _train_run("B", TRAIN_A + ["trainer.max_epochs=3",
                                   "trainer.async_checkpointing=true",
                                   f"trainer.ckpt_path={ck}/last"],
                   os.path.join(tmp, "B"),
                   want(3 + 6 + 2 + 1 + 1, decode_gens=1), res, total,
                   problems)
        b_root = res["B"]["root"]
        ev = read_events(_glob_one(b_root, "events.out.tfevents.*"))
        b_steps = [e["step"] for e in ev if e["tag"] == "train_loss_step"]
        if b_steps != [7, 8, 9]:
            problems.append(f"B: train_loss_step at steps {b_steps}")
        if _epoch_checkpoints(b_root) != ["epoch=2-step=9"]:
            problems.append(f"B: checkpoints {_epoch_checkpoints(b_root)}")
        with open(os.path.join(b_root, "checkpoints", "last", "meta.json")) as f:
            b_meta = json.load(f)
        # the early-stop state B started from is A's: B's epoch either
        # improved on A's best or counted one more epoch after A's count
        (b_val,) = [e["value"] for e in ev if e["tag"] == "val_loss_epoch"]
        if b_val < a_meta["early_stop_best"]:
            want_es = (b_val, 0)
        else:
            want_es = (a_meta["early_stop_best"], a_meta["early_stop_count"] + 1)
        got_es = (b_meta["early_stop_best"], b_meta["early_stop_count"])
        res["B"]["early_stop"] = {"A": [a_meta["early_stop_best"],
                                        a_meta["early_stop_count"]],
                                  "B": list(got_es)}
        if got_es[1] != want_es[1] or abs(got_es[0] - want_es[0]) > 1e-6:
            problems.append(f"B: early stop {got_es}, expected {want_es}")
        shutil.rmtree(b_root, ignore_errors=True)

        # C: test A's best checkpoint (2 test batches), the one A's own
        # test restored
        best = resolve_best_checkpoint(ck)
        _train_run("C", ["action=test", "trainer.limit_test_batches=2",
                         f"trainer.ckpt_path={best}"],
                   os.path.join(tmp, "C"), want(2), res, total, problems)
        res["C"]["ckpt"] = best.name
        res["C"]["test_loss_vs_A"] = abs(res["C"]["test_loss"]
                                         - res["A"]["test_loss"])
        if not res["C"]["test_loss_vs_A"] <= TOL_TEST_LOSS:
            problems.append(f"C: test loss {res['C']['test_loss']} against "
                            f"A's {res['A']['test_loss']}")
        shutil.rmtree(a_root, ignore_errors=True)

        # D: the encoder unfrozen, 2 steps through the grouped attention,
        # then 1 validation and 1 test batch through the fused kernels
        _train_run("D", TRAIN_D, os.path.join(tmp, "D"),
                   want(2, grouped_steps=2), res, total, problems)
        if not math.isfinite(res["D"]["test_loss"]):
            problems.append("D: test loss not finite")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["launches"] = total
    report["train_action"] = res
    print("train_action: " + json.dumps({t: {k: res[t][k] for k in (
        "wall_s", "steps", "first_step_ms", "step_ms", "val_ms", "media_s",
        "save_s", "restore_s", "peak_mem_gib", "test_loss")} for t in "ABCD"
        if t in res}),
        flush=True)
    if problems:
        raise AssertionError("; ".join(problems))
    return total


# the finetune phase's runs (``configs/experiments/flagship_smoke.yaml``,
# ``action=finetune``, which assembles the experiment file alone, as the JAX
# ``main.py`` does: no learning-rate schedule): L trains LoRA adapters of
# rank 8 for 3 steps from a base checkpoint of the same model (lr 1e-2, so
# that the adapters move the bf16 weights they merge into), F trains the
# whole model with the encoder unfrozen and bf16 first moments for 2 steps;
# then the generate action from L's experiment and from the base, 1.28 s
# (110 tokens: one VGGish example a clip) at batch 2
FT_COMMON = ["action=finetune", "trainer.fast_dev_run=false",
             "trainer.max_epochs=1", "trainer.limit_val_batches=1",
             "trainer.limit_test_batches=1"]
FT_LORA = FT_COMMON + ["trainer.limit_train_batches=3",
                       "finetune.lora_rank=8", "model.learning_rate=1e-2"]
FT_FULL = FT_COMMON + ["trainer.limit_train_batches=2",
                       "finetune.unfreeze_encoder=true",
                       "model.adam_mu_dtype=bfloat16"]
FT_GEN = ["action=generate", "dataloader.batch_size=2", "max_batches=1",
          "duration=1.28", "return_sampled_indices=true"]
FT_GEN_TOKENS = 110


def _ft_want(encoder_fwd=0, grouped_steps=0, decode_steps=0):
    return {"decode_attention": 24 * decode_steps, "decode_attention_int8": 0,
            "encoder_attention": 24 * encoder_fwd,
            "encoder_mlp": 12 * encoder_fwd,
            "grouped_cls_attention": 24 * grouped_steps}


def phase_finetune(gen, report):
    """The finetune action as a user runs it (runs L and F above, at
    flagship width with seeded random weights) and the generate action
    from L's experiment. Checks: L leaves every base-sampler weight bit for
    bit as ``init_from`` gave it, its checkpoint holds the adapters alone,
    its test loss is finite; F stores its first moments in bf16 and runs
    the grouped attention in each step; the generate action loads L's base
    and adapters, its merged weights equal ``W + (alpha / r) b a`` computed
    here in float32 (within the two bf16 roundings of the merge), and its
    codes equal
    ``VauraSystem.generate`` of a system without adapters that holds those
    merged weights, under the same generator state; every run's launches.
    The WAVs of L's experiment and of the base go to
    ``chiprun_out/finetune/`` for the eval phase; the run directories are
    deleted."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    import vaura_tpu_torch.models.vaura as tvaura
    import vaura_tpu_torch.train.loop as tloop
    from vaura_tpu_torch.main import get_config, main
    from vaura_tpu_torch.models.factory import build_system
    from vaura_tpu_torch.ops.audio import read_wav
    from vaura_tpu_torch.ops.patterns import DelayedPatternProvider
    from vaura_tpu_torch.train.checkpoint import load_state
    from vaura_tpu_torch.train.lora import lora_pairs, merge_lora
    from vaura_tpu_torch.utils import seeded_init_

    config = f"config={os.path.join(ROOT, TRAIN_CONFIG)}"
    tmp = tempfile.mkdtemp(prefix="finetune_")
    wav_root = os.path.join(OUT_DIR, "finetune")
    shutil.rmtree(wav_root, ignore_errors=True)
    res, problems, total = {}, [], {}
    seen = {}
    fit, generate = tloop.Trainer.fit, tvaura.VauraSystem.generate

    def fit_spy(self, *a, **k):
        seen["system"] = self.system
        out = fit(self, *a, **k)
        seen["fit"] = out
        return out

    def generate_spy(self, *a, **k):
        g = k.get("generator")
        seen["call"] = (self, a, dict(k), None if g is None else g.get_state())
        return generate(self, *a, **k)

    def run(tag, argv, want):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        _zero_counters()
        t0 = time.time()
        out = main([config, *argv])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = _counters()
        for key, v in launches.items():
            total[key] = total.get(key, 0) + v
        r = {"wall_s": wall, "launches": launches, "expected_launches": want,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        stats = (out or {}).get("stats") or {}
        if "metrics" in out:
            r["test_loss"] = out["metrics"]["test_loss"]
            r["step_ms"] = stats.get("step_ms", [])
            r["save_s"] = stats.get("save_s", [])
        res[tag] = r
        log(f"[finetune] {tag}: wall {wall:.2f} s, peak "
            f"{r['peak_mem_gib']:.2f} GiB, test loss {r.get('test_loss')}, "
            f"launches {launches}")
        if launches != want:
            problems.append(f"{tag}: launches {launches}, expected {want}")
        return out

    tvaura.VauraSystem.generate = generate_spy
    tloop.Trainer.fit = fit_spy
    try:
        # the base: the flagship sampler from another seed, the LM head
        # random (a zero head passes no gradient to the adapters), in bf16
        t0 = time.time()
        model_cfg = get_config([config, "action=finetune"])["model"]
        base_sys = seeded_init_(build_system(model_cfg, device="cuda"),
                                torch.Generator("cuda").manual_seed(1))
        base = {k: v.detach().to(torch.bfloat16).cpu()
                for k, v in base_sys.named_parameters()
                if k.startswith("sampler.")}
        del base_sys
        base_dir = os.path.join(tmp, "base")
        os.makedirs(base_dir)
        torch.save({"params": base}, os.path.join(base_dir, "state.pt"))
        res["base_s"] = time.time() - t0

        # L: LoRA, 3 steps, 1 validation and 1 test batch through the
        # fused encoder kernels (a frozen encoder)
        out = run("L", FT_LORA + [f"trainer.log_dir={tmp}/L",
                                  f"finetune.init_from={base_dir}"],
                  _ft_want(encoder_fwd=3 + 1 + 1))
        system = seen.pop("system")
        changed = [k for k, v in system.named_parameters()
                   if k.startswith("sampler.")
                   and not torch.equal(v.detach().cpu(), base[k].float())]
        if changed:
            problems.append(f"L: base sampler changed: {changed[:3]}")
        l_root = str(out["dirs"]["root"])
        ckpts = [n for n in os.listdir(os.path.join(l_root, "checkpoints"))
                 if n.startswith("epoch=")]
        names = set(load_state(os.path.join(l_root, "checkpoints",
                                            ckpts[0]))["params"])
        res["L"]["checkpoint_params"] = len(names)
        if len(ckpts) != 1 or not names or any(
                not k.startswith("lora_sampler.") for k in names):
            problems.append(f"L: checkpoints {ckpts} hold {sorted(names)[:3]}")
        if not math.isfinite(res["L"]["test_loss"]):
            problems.append("L: test loss not finite")
        res["L"]["adapter_params"] = sum(p.numel() for p in
                                         system.lora_sampler.parameters())
        del system, out
        seen.clear()

        # F: the whole model, the encoder unfrozen, bf16 first moments:
        # 2 steps through the grouped attention, then the fused kernels
        run("F", FT_FULL + [f"trainer.log_dir={tmp}/F",
                            f"finetune.init_from={base_dir}"],
            _ft_want(encoder_fwd=1 + 1, grouped_steps=2))
        mu = seen.pop("fit")["state"].opt_state.mu
        res["F"]["mu_dtypes"] = sorted({str(v.dtype) for v in mu.values()})
        if res["F"]["mu_dtypes"] != ["torch.bfloat16"]:
            problems.append(f"F: first moments {res['F']['mu_dtypes']}")
        if not math.isfinite(res["F"]["test_loss"]):
            problems.append("F: test loss not finite")
        seen.clear()
        shutil.rmtree(os.path.join(tmp, "F"), ignore_errors=True)

        # the generate action from L's experiment, then from the base
        steps = DelayedPatternProvider(9).get_pattern(
            FT_GEN_TOKENS)._build_seq_tables(FT_GEN_TOKENS)[1].shape[1] - 1
        want = _ft_want(encoder_fwd=1, decode_steps=steps)
        lora_wavs = os.path.join(wav_root, "lora")
        run("generate_lora", FT_GEN + [f"experiment_path={l_root}",
                                       f"output_dir={lora_wavs}"], want)
        system, args, kwargs, g_state = seen.pop("call")
        merged = merge_lora(system.sampler, system.lora_sampler,
                            system.lora_alpha)
        # the port rounds delta to bf16, then W + delta: each element within
        # half a bf16 ulp of each, 2^-8 (|delta| + |merged|), of the float32
        # W + delta; and the change it applied, merged - W, within a quarter
        # of delta's magnitude of delta in sum (rounding noise: 2^-8 |W| an
        # element; a missing or mis-scaled delta: all of it)
        worst, off, size = 0.0, 0.0, 0.0
        for name, pair in lora_pairs(system.lora_sampler).items():
            W = system.sampler.get_submodule(name).weight.float()
            scale = (system.lora_alpha or pair.lora_a.shape[0]) \
                / pair.lora_a.shape[0]
            delta = scale * (pair.lora_b.float() @ pair.lora_a.float())
            m = merged[name].float()
            bound = 2.0 ** -8 * (delta.abs() + m.abs())
            worst = max(worst, float(((m - (W + delta)).abs()
                                      / bound.clamp_min(1e-30)).max()))
            off += float((m - W - delta).abs().sum())
            size += float(delta.abs().sum())
        res["generate_lora"]["merged_err_of_bound"] = worst
        res["generate_lora"]["applied_delta_rel_err"] = off / size
        moved = sum(int((merged[n] != system.sampler.get_submodule(n).weight)
                        .sum()) for n in merged)
        res["generate_lora"]["merged_elements_changed"] = moved
        if not (worst <= 1.01 and off / size <= 0.25 and moved > 0):
            problems.append(f"generate_lora: merged weights {worst} of the "
                            f"rounding bound from W + (alpha/r) b a, the "
                            f"applied change {off / size} of delta off it, "
                            f"{moved} changed")
        # the same call on a system without adapters holding the merged
        # weights
        codes = np.stack([np.load(os.path.join(lora_wavs, f"{i}.codes.npy"))
                          for i in range(2)])
        lora = system.lora_sampler
        with torch.no_grad():
            for name, w in merged.items():
                system.sampler.get_submodule(name).weight.copy_(w)
        system.lora_sampler = None
        g = torch.Generator("cuda")
        g.set_state(g_state)
        replay = generate(system, *args, **dict(kwargs, generator=g))
        replay_codes = replay["codes"].cpu().numpy()
        res["generate_lora"]["replay_equal"] = bool(
            np.array_equal(replay_codes, codes))
        if not res["generate_lora"]["replay_equal"]:
            problems.append("generate_lora: codes differ from the merged "
                            "system's generate")
        del system, lora, merged, replay
        seen.clear()
        base_wavs = os.path.join(wav_root, "base")
        run("generate_base", FT_GEN + [f"ckpt_path={base_dir}",
                                       f"output_dir={base_wavs}"], want)
        seen.clear()
        base_codes = np.stack([np.load(os.path.join(base_wavs,
                                                    f"{i}.codes.npy"))
                               for i in range(2)])
        res["generate_lora"]["codes_differ_from_base"] = int(
            (base_codes != codes).sum())
        for d in (lora_wavs, base_wavs):
            for i in range(2):
                wav, sr = read_wav(os.path.join(d, f"{i}.wav"))
                if (sr != 44100 or wav.shape != (1, FT_GEN_TOKENS * 512)
                        or not np.isfinite(wav).all()):
                    problems.append(f"{d}: clip {i} {wav.shape} at {sr} Hz")
    finally:
        tvaura.VauraSystem.generate = generate
        tloop.Trainer.fit = fit
        seen.clear()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    res["train_action_D_peak_mem_gib"] = (
        report.get("train_action", {}).get("D", {}).get("peak_mem_gib"))
    res["launches"] = total
    res["wav_dirs"] = {"lora": lora_wavs, "base": base_wavs}
    report["finetune"] = res
    print("finetune: " + json.dumps(
        {t: {k: res[t].get(k) for k in ("wall_s", "peak_mem_gib",
                                        "test_loss")}
         for t in ("L", "F", "generate_lora", "generate_base") if t in res}
        | {"base_s": res.get("base_s"), "train_action_D_peak_mem_gib":
           res["train_action_D_peak_mem_gib"]}), flush=True)
    if problems:
        raise AssertionError("; ".join(problems))
    return total


# eval: the eval action on the finetune phase's WAVs (L's experiment against
# the base) with each embedder; the networks from seeded random weights
# (N(0, 1/fan_in), zero biases: the published files are not in the repo)
# written as .pth files under chiprun_out/eval/ and deleted after the phase
# (each is several hundred MB). Card against CPU: float32 embeddings of
# the same clips, as the embedders compute them (their networks turn TF32
# off themselves), within 1e-3 of the largest magnitude. The FAD
# of a set against itself: within D sqrt(eps) of the set's total variance
# (the trace of its covariance, the scale of each term of the distance;
# D the embedding's width, eps float64's). Two clips give a covariance of
# rank 1, and the eigh square roots turn the rounding noise of its D - 1
# zero eigenvalues into up to about D sqrt(eps) lambda_max, which exceeds
# an absolute 1e-6 at a variance of order 10: such a bound would hold the
# metric's own numerics, not the port
TOL_EMBED_REL = 1e-3


def phase_eval(gen, report):
    """``action=eval`` as a user runs it on the finetune phase's WAVs, with
    ``melstats``, ``vggish`` and ``panns``: finite metrics (``fad_*``,
    ``kld_panns``), the FAD of the LoRA set against itself within D
    sqrt(eps) of the set's total variance, and each network's embeddings
    (and Cnn14's
    posteriors) of the LoRA clips on the card within 1e-3 relative of the
    CPU's."""
    import shutil

    import numpy as np
    import torch

    from vaura_tpu_torch.main import main
    from vaura_tpu_torch.ops.audio import read_wav
    from vaura_tpu_torch.ops.panns import Cnn14
    from vaura_tpu_torch.ops.vggish import VGGish
    from vaura_tpu_torch.scripts.eval_metrics import make_embedder
    from vaura_tpu_torch.utils import seeded_init_

    dirs = report["finetune"]["wav_dirs"]
    root = os.path.join(OUT_DIR, "eval")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    res, problems = {}, []
    # cuDNN's flags stay at their defaults (TF32 convolutions allowed): the
    # embedders run their networks in full float32 themselves, and the card
    # against CPU check below holds what a user's action=eval computes
    try:
        ckpts = {}
        for name, cls, seed in (("vggish", VGGish, 5), ("panns", Cnn14, 6)):
            ckpts[name] = os.path.join(root, f"{name}.pth")
            net = seeded_init_(cls("cpu"), torch.Generator().manual_seed(seed))
            sd = net.state_dict()
            torch.save({"model": sd} if name == "panns" else sd, ckpts[name])
        for embedder in ("melstats", "vggish", "panns"):
            extra = ([f"embedder_ckpt={ckpts[embedder]}"]
                     if embedder in ckpts else [])
            t0 = time.time()
            report_ = main(["config=" + os.path.join(ROOT, TRAIN_CONFIG),
                            "action=eval", f"generated_dir={dirs['lora']}",
                            f"reference_dir={dirs['base']}", "fad=true",
                            f"embedder={embedder}", *extra])
            wall = time.time() - t0
            self_ = main(["config=" + os.path.join(ROOT, TRAIN_CONFIG),
                          "action=eval", f"generated_dir={dirs['lora']}",
                          f"reference_dir={dirs['lora']}", "fad=true",
                          f"embedder={embedder}", *extra])
            mean = report_["mean"]
            r = {"wall_s": wall, "n": report_["n"], "mean": mean,
                 "self_fad": self_["mean"].get(f"fad_{embedder}")}
            bad = [k for k, v in mean.items() if not math.isfinite(v)]
            if report_["n"] != 2 or bad or f"fad_{embedder}" not in mean:
                problems.append(f"{embedder}: n {report_['n']}, metrics "
                                f"{mean}")
            on_card = make_embedder(embedder, ckpts.get(embedder), "cuda")
            on_cpu = make_embedder(embedder, ckpts.get(embedder), "cpu")
            rows, err = [], 0.0
            for i in range(2):
                wav, sr = read_wav(os.path.join(dirs["lora"], f"{i}.wav"))
                a = np.atleast_2d(on_card(wav[0], sr))
                rows.append(a)
                if embedder not in ckpts:
                    continue  # melstats: numpy, no device
                b = np.atleast_2d(on_cpu(wav[0], sr))
                err = max(err, float(np.abs(a - b).max())
                          / max(float(np.abs(b).max()), 1e-30))
                if embedder == "panns":
                    p, q = on_card.last_probs, on_cpu.last_probs
                    err = max(err, float(np.abs(p - q).max())
                              / float(np.abs(q).max()))
            del on_card, on_cpu
            rows = np.concatenate(rows).astype(np.float64)
            r["variance"] = float(np.trace(np.atleast_2d(
                np.cov(rows, rowvar=False))))
            r["self_fad_tol"] = (rows.shape[1] * float(np.sqrt(np.finfo(
                np.float64).eps)) * r["variance"])
            if r["self_fad"] is None or not abs(r["self_fad"]) <= \
                    r["self_fad_tol"]:
                problems.append(f"{embedder}: FAD of a set against itself "
                                f"{r['self_fad']} (variance "
                                f"{r['variance']})")
            if embedder in ckpts:
                r["card_vs_cpu_rel"] = err
                if not err <= TOL_EMBED_REL:
                    problems.append(f"{embedder}: card against CPU {err}")
            res[embedder] = r
            log(f"[eval] {embedder}: wall {wall:.2f} s, {mean}, self FAD "
                f"{r['self_fad']} (variance {r['variance']:.4g}), card vs "
                f"CPU {r.get('card_vs_cpu_rel')}")
    finally:
        for path in os.listdir(root):
            if path.endswith(".pth"):
                os.remove(os.path.join(root, path))
        torch.cuda.empty_cache()
    report["eval"] = res
    print("eval: " + json.dumps({k: {"wall_s": v["wall_s"], **v["mean"]}
                                 for k, v in res.items()}), flush=True)
    if problems:
        raise AssertionError("; ".join(problems))


# the server's runs: service A serves the flagship model of
# configs/generate_vgg.yaml (seeded random weights) with the bf16 cache,
# buckets [1, 8] and the rolling-KV stream of 5.12 s; service B the same
# with the int8 KV cache (quantize=cache) and one bucket of 8
SERVE_A = ["batch=8", "batch_buckets=1", "duration=2.56", "stream_mode=kv",
           "stream_duration=5.12"]
SERVE_B = ["batch=8", "duration=2.56", "quantize=cache"]
SERVE_CONFIG = "configs/generate_vgg.yaml"


def _decode_steps(service, tokens: int) -> int:
    return service.system.prepare_generation(tokens)[2] - 1


def _start_server(extra):
    """``make_server`` from ``SERVE_CONFIG`` with ``action=serve`` and
    ``extra``, on a free port of 127.0.0.1, serving in a thread."""
    import threading

    from vaura_tpu_torch.main import get_config
    from vaura_tpu_torch.scripts.serve import make_server

    cfg = get_config([f"config={os.path.join(ROOT, SERVE_CONFIG)}",
                      "action=serve", "port=0", *extra])
    service, server = make_server(cfg)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return service, server, f"http://127.0.0.1:{server.server_address[1]}"


def _post_npy(url, arr, timeout=600):
    import io
    import urllib.request

    import numpy as np

    buf = io.BytesIO()
    np.save(buf, np.asarray(arr, np.float32))
    req = urllib.request.Request(url, data=buf.getvalue(), headers={
        "Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _post_json(url, payload, timeout=600):
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _metrics(base):
    import urllib.request

    text = urllib.request.urlopen(base + "/metrics", timeout=60).read().decode()
    return {line.split()[0]: float(line.split()[1]) for line in
            text.splitlines() if line and not line.startswith("#")}


def _check_wav(body, service, problems, tag):
    """A 44.1 kHz WAV of the service's tokens times the hop, not silent."""
    import io
    import wave

    import numpy as np

    samples = service.tokens * service.system.dac.cfg.hop_length
    with wave.open(io.BytesIO(body)) as w:
        sr, n = w.getframerate(), w.getnframes()
        pcm = np.frombuffer(w.readframes(n), dtype="<i2")
    if sr != 44100 or n != samples or float(pcm.std()) == 0.0:
        problems.append(f"{tag}: wav of {n} samples at {sr} Hz (expected "
                        f"{samples}), std {float(pcm.std())}")


def _burst(service, base, n, rng, problems, tag):
    """``n`` concurrent WAV requests of seeded random features: wall,
    request latencies, the batches and fill ratio they took (/metrics)."""
    import concurrent.futures

    import numpy as np

    feats = [rng.standard_normal((service.tv, service.cond_dim)).astype(
        np.float32) for _ in range(n)]

    def one(f):
        t0 = time.time()
        body = _post_npy(base + "/generate", f)
        return body, time.time() - t0

    before = _metrics(base)
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(feats)) as ex:
        results = [fut.result() for fut in
                   [ex.submit(one, f) for f in feats]]
    wall = time.time() - t0
    after = _metrics(base)
    for i, (body, _) in enumerate(results):
        _check_wav(body, service, problems, f"{tag} request {i}")
    lat = np.array([dt for _, dt in results])
    batches = int(after["vaura_batches_total"] - before["vaura_batches_total"])
    slots = len(feats)
    capacity = sum(
        int(after[k] - before[k]) * int(k.split('"')[1])
        for k in after if k.startswith("vaura_bucket_batches_total"))
    res = {"requests": slots, "wall_s": wall, "batches": batches,
           "fill_ratio": slots / max(capacity, 1),
           "latency_p50_s": float(np.percentile(lat, 50)),
           "latency_p95_s": float(np.percentile(lat, 95)),
           "audio_s_per_s": slots * service.tokens / 86 / wall}
    log(f"[serve] {tag}: {slots} requests in {wall:.3f} s, {batches} batches, "
        f"fill {res['fill_ratio']:.3f}, latency p50 {res['latency_p50_s']:.3f}"
        f" p95 {res['latency_p95_s']:.3f} s, {res['audio_s_per_s']:.3f} "
        "audio-s/s")
    return res


def phase_serve(gen, report):
    """The server as a user starts it (``action=serve`` from
    ``configs/generate_vgg.yaml``, seeded random weights, HTTP on
    127.0.0.1). Service A (bf16 cache, buckets [1, 8], rolling-KV stream of
    5.12 s): a lone ``raw=codes`` request held to ``VauraSystem.generate``
    of the same padded features and seed; a burst of 16 WAV requests; one
    clip through the encoder (``video_b64`` where the native media library
    can write and decode MP4, else the decoded-frames half of it); one
    stream of 440 tokens; ``/reload`` from a ``CheckpointManager``
    checkpoint of differently seeded sampler weights, after which a lone
    request's codes differ from the old weights' at the same seed;
    ``close()``. Service B (``quantize=cache``): a burst of 8. The counters
    are zeroed after each service's warm-up and read after its last
    request; the direct generations that check the server are not
    counted."""
    import base64
    import io
    import shutil
    import tempfile
    import urllib.request

    import numpy as np
    import torch

    from vaura_tpu_torch.data import media
    from vaura_tpu_torch.models.sampler import Sampler
    from vaura_tpu_torch.train.checkpoint import CheckpointManager
    from vaura_tpu_torch.train.state import TrainState, make_optimizer
    from vaura_tpu_torch.utils import seeded_init_

    problems, res, total, uncounted = [], {}, {}, {}
    rng = np.random.default_rng(0)

    def direct(system, feats, seed):
        """Codes of ``VauraSystem.generate`` outside the server (its
        launches are taken out of the counts)."""
        before = _counters()
        with torch.inference_mode():
            out = system.generate(
                vis_feats=torch.from_numpy(feats[None]).to(service.device),
                generator=torch.Generator(service.device).manual_seed(seed),
                max_new_tokens=service.tokens, tokens_per_frame=7,
                decode_to_audio=False, **service.sampling)
        for k, v in _counters().items():
            uncounted[k] = uncounted.get(k, 0) + v - before[k]
        return out["codes"].cpu().numpy()[0]

    def lone_codes(feats):
        seed = service._next_seed
        body = _post_npy(base + "/generate?raw=codes", feats)
        return np.asarray(json.loads(body)["codes"]), seed

    # ---- service A ------------------------------------------------------
    t0 = time.time()
    service, server, base = _start_server(SERVE_A)
    res["a_startup_s"] = time.time() - t0
    log(f"[serve] A: started and warmed up in {res['a_startup_s']:.1f} s")
    steps = _decode_steps(service, service.tokens)
    stream_steps = _decode_steps(service, service.stream_tokens)
    layers = service.system.sampler_config.num_layers
    try:
        if service.device.type == "cuda":
            torch.cuda.synchronize()
        _zero_counters()
        # 1. a lone request against the direct generation
        feats = rng.standard_normal((service.tv, service.cond_dim)).astype(
            np.float32)
        t0 = time.time()
        codes, seed = lone_codes(feats)
        res["lone_request_s"] = time.time() - t0
        want = direct(service.system, feats, seed)
        res["lone_codes_equal_direct"] = bool(np.array_equal(codes, want))
        log(f"[serve] lone request {res['lone_request_s']:.3f} s, codes "
            f"{codes.shape} equal to VauraSystem.generate: "
            f"{res['lone_codes_equal_direct']}")
        if not res["lone_codes_equal_direct"]:
            problems.append("lone request codes differ from the direct "
                            f"generation at {int((codes != want).sum())} of "
                            f"{codes.size}")
        # 2. a burst of 16
        res["burst16"] = _burst(service, base, 16, rng, problems,
                                "A burst of 16")
        if res["burst16"]["batches"] > 15:
            problems.append(f"burst of 16 took {res['burst16']['batches']} "
                            "batches")
        # 3. one clip through the encoder, sent alone (the encoder's launch
        # counters are plain integers, incremented by one thread at a time)
        before = _counters()
        # one frame past the duration, as a decoder may drop the last
        n_frames = int(service.duration * 25) + 1
        frames = rng.integers(0, 256, (n_frames, 224, 224, 3), dtype=np.uint8)
        t0 = time.time()
        if media.available():
            with tempfile.TemporaryDirectory() as d:
                path = os.path.join(d, "clip.mp4")
                media.write_video(path, frames, fps=25.0)
                with open(path, "rb") as f:
                    video = base64.b64encode(f.read()).decode()
            body = _post_json(base + "/generate", {"video_b64": video})
            res["video_route"] = "video_b64"
        else:
            # without libav no MP4 can be written or decoded: the
            # server's encoder half runs on the frames
            log("[serve] the native media library is unavailable: the clip "
                "goes through GenerationService.frames_to_features, then "
                "/generate as features")
            body = _post_npy(base + "/generate",
                             service.frames_to_features(frames))
            res["video_route"] = "frames_to_features"
        res["video_request_s"] = time.time() - t0
        _check_wav(body, service, problems, "video request")
        enc = {k: v - before[k] for k, v in _counters().items()}
        log(f"[serve] clip via {res['video_route']} in "
            f"{res['video_request_s']:.3f} s, launches {enc}")
        depth = service.system.encoder.cfg.depth
        if service.device.type == "cuda" and (
                enc["encoder_attention"] != 2 * depth
                or enc["encoder_mlp"] != depth):
            problems.append(f"video request: encoder launches {enc}")
        # 4. one stream
        seg = rng.standard_normal((service.stream_segments, service.stream_t,
                                   service.cond_dim)).astype(np.float32)
        buf = io.BytesIO()
        np.save(buf, seg)
        req = urllib.request.Request(
            base + "/generate_long", data=buf.getvalue(),
            headers={"Content-Type": "application/octet-stream"})
        t0 = time.time()
        with urllib.request.urlopen(req, timeout=600) as r:
            header = r.read(44)  # sent with the first increment
            first = time.time() - t0
            pcm = r.read()
        hop = service.system.dac.cfg.hop_length
        res["stream"] = {"tokens": service.stream_tokens,
                         "time_to_first_increment_s": first,
                         "wall_s": time.time() - t0,
                         "samples": len(pcm) // 2}
        log(f"[serve] stream of {service.stream_tokens} tokens: first "
            f"increment after {first:.3f} s, {len(pcm) // 2} samples in "
            f"{res['stream']['wall_s']:.3f} s")
        if header[:4] != b"RIFF" or len(pcm) // 2 != service.stream_tokens * hop:
            problems.append(f"stream: header {header[:4]!r}, "
                            f"{len(pcm) // 2} samples")
        # 5. hot reload from a checkpoint of differently seeded sampler
        # weights (and the served encoder's), a TrainState as training
        # saves it
        ckdir = tempfile.mkdtemp()
        try:
            old = service.system
            sampler = Sampler(old.sampler_config, service.device)
            seeded_init_(sampler,
                         torch.Generator(service.device).manual_seed(1))
            params = {f"sampler.{k}": v for k, v in
                      sampler.named_parameters()}
            params.update({k: v for k, v in old.named_parameters()
                           if k in service._trainable_like
                           and not k.startswith("sampler.")})
            state = TrainState.create(params, make_optimizer(1e-4))
            t0 = time.time()
            path = CheckpointManager(ckdir).save(state, epoch=0, step=1,
                                                 val_loss=1.0)
            res["checkpoint_save_s"] = time.time() - t0
            del sampler, params, state
            t0 = time.time()
            info = json.loads(_post_json(base + "/reload",
                                         {"ckpt_path": str(path)}))
            res["reload_s"] = time.time() - t0
            codes, seed = lone_codes(feats)
            res["reload_codes_changed"] = bool(
                not np.array_equal(codes, direct(old, feats, seed)))
            reloads = _metrics(base)["vaura_reloads_total"]
            log(f"[serve] checkpoint saved in {res['checkpoint_save_s']:.1f}"
                f" s, reload {info} in {res['reload_s']:.1f} s; codes changed:"
                f" {res['reload_codes_changed']}; vaura_reloads_total "
                f"{reloads}")
            if not (info.get("reloaded") and res["reload_codes_changed"]
                    and reloads == 1):
                problems.append(f"reload: {info}, codes changed "
                                f"{res['reload_codes_changed']}, reloads "
                                f"{reloads}")
            del old
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
        a_batches = int(_metrics(base)["vaura_batches_total"])
        # 6. close: drain and end the worker
        server.shutdown()
        res["close_drained"] = service.close(timeout=60)
        if not res["close_drained"] or service._worker.is_alive():
            problems.append("close() did not drain and end the worker")
    finally:
        server.shutdown()
        server.server_close()
        service.close(timeout=60)
    launches = {k: v - uncounted.get(k, 0) for k, v in _counters().items()}
    want = {"decode_attention": layers * (steps * a_batches + stream_steps),
            "decode_attention_int8": 0, "encoder_attention": 2 * depth,
            "encoder_mlp": depth, "grouped_cls_attention": 0}
    res["a_launches"], res["a_expected_launches"] = launches, want
    log(f"[serve] A: launches {launches}, expected {want} ({a_batches} "
        "batches and one stream)")
    if service.device.type == "cuda" and launches != want:
        problems.append(f"A: launches {launches}, expected {want}")
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    del service, server

    # ---- service B: the int8 KV cache -----------------------------------
    service, server, base = _start_server(SERVE_B)
    try:
        if service.device.type == "cuda":
            torch.cuda.synchronize()
        _zero_counters()
        res["b_burst8"] = _burst(service, base, 8, rng, problems,
                                 "B (int8 cache) burst of 8")
        b_batches = int(_metrics(base)["vaura_batches_total"])
    finally:
        server.shutdown()
        server.server_close()
        service.close(timeout=60)
    launches = _counters()
    want = {"decode_attention": 0,
            "decode_attention_int8": layers * steps * b_batches,
            "encoder_attention": 0, "encoder_mlp": 0,
            "grouped_cls_attention": 0}
    res["b_launches"], res["b_expected_launches"] = launches, want
    log(f"[serve] B: launches {launches}, expected {want}")
    if service.device.type == "cuda" and launches != want:
        problems.append(f"B: launches {launches}, expected {want}")
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    del service, server
    res["launches"] = total
    report["serve"] = res
    print("serve: " + json.dumps({
        "A_burst16": res["burst16"], "B_int8_cache_burst8": res["b_burst8"],
        "stream_kv": res["stream"], "lone_request_s": res["lone_request_s"],
        "video_request_s": res["video_request_s"],
        "video_route": res["video_route"]}), flush=True)
    if problems:
        raise AssertionError("; ".join(problems))
    return total


# ---------------------------------------------------------------------------
def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import vaura_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not next to this script ({e})",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"device": torch.cuda.get_device_name(0)}
    failed = []

    def run(name, fn, *a):
        t0 = time.time()
        try:
            r = fn(*a)
            log(f"[{name}] ok in {time.time() - t0:.1f} s")
            return r
        except Exception:  # every phase runs; any failure fails the script
            failed.append(name)
            log(f"[{name}] FAILED")
            traceback.print_exc()
            return None

    gen = torch.Generator(device="cuda").manual_seed(0)
    run("build", phase_build, report)
    kernels = []
    checks = (check_decode_attention, check_decode_attention_int8,
              check_encoder_attention, check_encoder_mlp,
              check_grouped_cls_attention)
    for check in checks:
        entry = run(check.__name__, check, gen)
        if entry is None:
            continue
        kernels.append(entry)
        log(f"[{entry['name']}] max_abs_err {entry['max_abs_err']:.3e} "
            f"(tol {entry['tol']}) ms {entry['ms']:.4f} plain {entry['plain_ms']:.4f} "
            f"bound {entry['bound_ms']:.4f} library {entry['library_ms']}")
        if not entry["max_abs_err"] <= entry["tol"]:
            failed.append(f"{entry['name']} tolerance")
    launches = run("main", phase_main, gen, report) or {}
    int8_launches = run("int8", phase_int8, gen, report) or {}
    train_launches = run("train", phase_train, gen, report) or {}
    run("long", phase_long, gen, report)
    run("reference", phase_reference, gen, report)
    action_launches = run("action", phase_action, gen, report) or {}
    train_action_launches = run("train_action", phase_train_action, gen,
                                report) or {}
    serve_launches = run("serve", phase_serve, gen, report) or {}
    finetune_launches = run("finetune", phase_finetune, gen, report) or {}
    if "finetune" in report:
        run("eval", phase_eval, gen, report)
    else:
        failed.append("eval")

    # each kernel's count on the main paths that run it: generation for the
    # decode and fused encoder kernels, generation with the int8 cache for
    # the int8 decode kernel, the three training steps for the grouped
    # attention, the generate action's three runs and the server's requests
    for entry in kernels:
        name = entry["name"]
        entry["launches"] = (
            launches.get(name, 0) + train_launches.get(name, 0)
            + (int8_launches.get(name, 0) if name == "decode_attention_int8"
               else 0) + action_launches.get(name, 0)
            + train_action_launches.get(name, 0)
            + serve_launches.get(name, 0)
            + finetune_launches.get(name, 0))
    report["kernels"] = kernels
    report["failed"] = failed
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in kernels]}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: {smi.stderr.strip()}")
    if failed or len(kernels) != len(checks):
        print(f"chip_smoke: FAILED phases: {failed}", file=sys.stderr)
        return 1
    for e in kernels:
        if not (e["launches"] > 0 and all(
                isinstance(e[k], float) and math.isfinite(e[k])
                for k in ("ms", "plain_ms", "bound_ms", "max_abs_err"))):
            print(f"chip_smoke: incomplete kernel entry {e}", file=sys.stderr)
            return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
