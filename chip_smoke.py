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
             attention (one launch, in the form the plan picks from the
             shapes: the tiles of a cache as the blocks of a thread-block
             cluster, or one block per (batch row, KV head) at serving
             batches) is held in both forms with ``pos`` on the host and in
             device memory, with GQA and on a 1,024-position cache, and
             timed beside an empty kernel of the same launch; its int8
             instantiation (int8 cache, per-(position, head) scales) the
             same way over positions 0..228, timed at B2 = 4 and at a
             serving B2 = 256 beside the bf16 kernel on the same values; its
             int4 instantiation (packed nibble tiles) and the int8 x int8
             kernel (over the int8 and the int4 cache, in one quantization
             group and in the flagship's 8) the same way, beside the int8 and
             bf16 kernels, SDPA on the bf16 values and an empty launch; each
             decode kernel's two forms also timed at B2 = 4, 32, 64, 256; the
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
             counter is zeroed just before and read just after, the
             decode steps replayed from the CUDA graph of the step counted
             (all but ``GRAPH_WARMUP_STEPS``);
  3b. decode_graph  the decode loop replayed from a CUDA graph against
             the eager loop on one seed, from features, at batch 2 (bf16
             cache) and at batch 64 (int8 cache, as the benchmark serves):
             the share of equal tokens (all), the steps replayed and run
             eagerly, the launches of each run (a replay counts what its
             recording launched), the host ms of the recording, of a
             replayed step and of an eager step, the decode loop's ms and
             the memory the graph's pool reserved (``decode_graph:
             {...}``);
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
             1 epoch x 3 steps with the encoder frozen (every validation,
             predict-media and TensorBoard path on), B resumes A for a
             second epoch with async saves (no predict media), C tests A's
             best checkpoint, D
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
             ``quantize=cache``. The ``mesh`` phase runs the first
             service's config under ``torchrun``. Launch counters zeroed
             after each service's warm-up; the direct generations that
             check the server are not counted.
 10b. aot   serving from exported graphs as a user runs it: the server of
             ``configs/experiments/flagship_smoke.yaml`` (flagship, seeded
             weights, batch 8, 2.56 s) started with ``aot_export=`` with
             the bf16 cache and with ``quantize=cache`` (the warm-up, then
             ``torch.export`` of the prologue, the device-position decode
             step and the epilogue, timed), one eager batch of seeded
             features through ``_generate``; the served state saved once;
             then a fresh process (``chip_smoke.py --aot-load``) that
             imports nothing of ``vaura_tpu_torch.models`` loads the state
             and each artifact and answers the same batch and seed (bf16
             twice): its codes equal to the eager server's, the mode's decode
             kernel launched 24 x 228 times an answer, 24 decode-attention
             operators in the exported step, the artifact under 1% of the
             state's bytes (``aot: {...}``);
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
             at batch 2, WAVs under ``chiprun_out/finetune/``; L's
             experiment is kept for the ``mesh`` phase;
 12. eval    ``action=eval`` on those WAVs (L's against the base's) with
             ``melstats``, ``vggish`` and ``panns`` (seeded random-weight
             ``.pth`` files written under ``chiprun_out/eval/`` and deleted
             after): finite metrics, the FAD of a set against itself within
             D sqrt(eps) of its total variance, the networks' embeddings on
             the card within 1e-3 relative of the CPU's (cuDNN at its
             defaults: the networks turn TF32 off themselves).
 13. encoder_variants  the encoder layouts and heads at full ViT-B/16
             width and depth (seeded bf16 weights, frames [2, 4, 3, 16,
             224, 224]): (a) the exact trajectory encoder into the flagship
             generation (221 tokens, CFG 6.0, top-k 128, bf16 cache) down to
             audio, decode-attention launches counted; (b) the Nystrom,
             Orthoformer and Performer trajectory encoders (128 landmarks or
             features) and the joint one, finite features [2, 4, 8, 768];
             (c) the int8 encoder against the bf16 one on the same weights
             (relative error < 0.05, cosine > 0.995), block 0's int8 MLP
             products through ``torch._int_mm`` equal to float64 products of
             the same values, and its 24 grouped-attention launches a
             forward; (d) the temporal and global heads, average pooling and
             unfactorised output, by shape; (e) two flagship training steps
             at each ``remat_policy`` (None twice), both losses equal bit
             for bit, the updated leaves that differ counted; (f) each variant at one block, card against CPU
             within ``TOL_REF_REL`` (the CPU's orthoformer replays the
             card's greedy landmark choice). Each forward's ms and peak
             memory printed (``encoder_variants: {...}``).
 14. quant_modes  the last sampler modes at full width and depth, batch 2:
             generation with the int4 cache, with the int8 x int8
             products and with both (5,496 launches of the mode's kernel,
             no other decode kernel, all in the cluster form), the products
             at a serving batch of 8 clips (every launch in the serving
             form), a 150-token prompt through
             ``prefill`` and ``generate_long_kv`` (5.12 s, window 4 x 56,
             one sink chunk) under int4 + products, the generate action
             from a config written to a temporary directory
             (``generate_vgg.yaml`` with the flagship model and
             ``cache_bits: 4``) with ``quantize=true``, and each mode's
             decode logits card against CPU at cut depth within
             ``TOL_REF_REL``, the card's two forms on one cache within
             ``TOL_DECODE`` (``quant_modes: {...}``; WAVs under
             ``chiprun_out/quant_modes/``).
 15. quant_quality  ``scripts/int8_margin_check.py`` (int4 cache + int8
             products) and ``scripts/quant_quality_fad.py`` at ``--mid``
             with 30 steps and 4 clips: the overfit loss below ``ln 1024``
             and every printed number finite.
 16. mesh    the multi-device path on this card through ``torchrun``
             with NCCL at 1 x 1 x 1: the flagship dry run and the generate
             action (batch 16, greedy) against one process; the demo from
             a ``--frames`` file; the server as a user starts it on several
             cards (each rank ``chip_smoke.py --rank``: ``main`` with its
             launch counters written out): a clip through
             ``frames_to_features`` (a job of every rank) whose features
             equal this process's, a lone request whose codes equal
             ``VauraSystem.generate``'s here, a burst of 16, a stream, a
             hot reload (the codes must change), SIGTERM (exit 0); the
             generate action from the finetune phase's LoRA run (codes
             equal to the one-process run's); the train action with LoRA
             adapters of rank 8 on the flagship (2 steps, frozen encoder,
             bf16; the base FSDP2-wrapped and frozen, each adapter merged
             per block into its gathered weight) against the same action
             here: losses within ``MESH_LOSS_REL``, the saved adapters
             within ``TOL_MESH_ADAPTERS``, the base sampler bit for bit
             its start, a checkpoint of the adapters alone; the decode
             kernels at the head counts a model axis of 2 and 4 leaves a
             rank. The dry run, both generate actions and the LoRA train
             action on the mesh run in one ``torchrun`` launch
             (``chip_smoke.py --rank-jobs``).
 17. bench   the benchmark entry points as a user runs them
             (``vaura_tpu_torch.bench``'s ``main`` in this process, each
             JSON line parsed): generate mode at its defaults (B=128, the
             int8 cache, the DAC in bf16; its peak memory), ``--no-int8
             --with-encoder`` (B=32), encoder mode with the int8 encoder,
             long mode at B=8 over 5.12 s, train mode (B=12); exact launch
             counts for the first four (the warm-up call and one timed
             call each); the burst bench as a subprocess (16 requests at
             batch 8, no error) and the codes precompute tool on the dummy
             datamodule. Every value finite and positive under the JAX
             bench's metric names, with the card's name
             (``bench: {...}``).
 18. mla_moe the DeepSeek-V3 sampler (Moonlight-16B-A3B's block) at its
             published widths (``port_bench/configs/vaura_moonlight16b.json``;
             the latent-attention kernel against its plain version is a
             kernel check, ``check_mla_decode_attention``): 2 clips
             prefilled and decoded through the latent cache, eagerly and
             replayed from a CUDA graph, every position's logits against
             the float32 reference following the program's routing (with
             the float8-cache control beside); one B=512 generation (steps
             replayed, wall, the kernel's launches held to one a layer and
             step); the generate action from
             ``configs/generate_vgg_moonlight.yaml``, its launches held the
             same way (``mla_moe: {...}``).
 19. snake   the DAC's Snake kernel (``csrc/snake.cu``) against its plain
             version (the eager formula) at the decoder's five levels of a
             32-clip slice and the encoder's five at 48 clips, in float32
             (within 2 ulps) and bf16 (within 1), each level's device ms
             beside its byte bound and the plain version's (at least 75% of
             the bound at ``[32, 96, 113152]``); its launches in one
             512-clip generation (464) and in one training step (29);
             that generation's waveform against the eager formula's
             decode of its codes (``snake: {...}``).

``python3 chip_smoke.py --phase <name>`` runs the one phase
``phase_<name>`` alone, without the kernel checks.

It prints the action runs' wall times and audio-s/s (``action: {...}``),
the train action's runs (``train_action: {...}``),
the server's burst, stream and request times (``serve: {...}``; on the
mesh in ``mesh: {...}``), the export, load and batch times of the exported
graphs (``aot: {...}``), the
finetune and generate runs' walls and peak memory (``finetune: {...}``),
the eval action's walls and metrics (``eval: {...}``), the encoder
variants' forwards, remat steps and card-vs-CPU errors
(``encoder_variants: {...}``), the benchmark's numbers (``bench:
{...}``), the kernels JSON line, the card's name and power limit, and as its last
line ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``. It needs one CUDA card and exits non-zero
without one.
"""

from __future__ import annotations

import contextlib
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


def check_decode_attention(gen, H=16, timed=True):
    """Flagship decode: B2 = 2 clips x 2 (CFG), H = 16 (or a model rank's
    ``H``), hd = 96, S = 230, with ``pos`` on the host and in device memory;
    then GQA (H_kv = H / 4) and a cache of 1,024 positions (more tiles than
    one cluster holds); with ``timed``, timed over the main path's
    positions."""
    import torch
    import torch.nn.functional as F

    from vaura_tpu_torch.ops import decode_attention as da

    B, hd, S, L = 4, 96, 230, 24
    dev, bf = "cuda", torch.bfloat16
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev, dtype=bf)

    def hold(tag, q, kc, vc, kcur, vcur, positions):
        """The kernel in each form with ``pos`` as an int and as a device
        scalar against the plain version; ``pos`` on the host and in device
        memory must agree to the last bit."""
        pos_t = torch.arange(kc.shape[1] + 1, dtype=torch.int32, device=dev)
        worst = 0.0
        for form in da.FORMS:
            for pos in positions:
                want = da.decode_attention_plain(q, kc, vc, kcur, vcur, pos)
                got = da.decode_attention_cuda(q, kc, vc, kcur, vcur, pos,
                                               form=form)
                got_t = da.decode_attention_cuda(q, kc, vc, kcur, vcur,
                                                 pos_t[pos:pos + 1], form=form)
                torch.cuda.synchronize()
                e = max(max_err(got, want), max_err(got_t, want))
                log(f"[decode_attention] {tag} {form} pos={pos:4d} "
                    f"max_abs_err={e:.3e}")
                if not torch.equal(got, got_t):
                    raise AssertionError(
                        f"{tag} {form} pos={pos}: pos on the host and in "
                        "device memory give different outputs")
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
    if not timed:
        return {"max_abs_err": err}

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
    del kc, vc, cur
    torch.cuda.empty_cache()
    form_ms = _form_times(gen, "bf16", FORM_B2)
    return {
        "name": "decode_attention", "route": "cuda",
        "source": "vaura_tpu_torch/csrc/decode_attention.cu",
        "replaces": "vaura_tpu/ops/pallas_attention.py:165",
        "max_abs_err": err, "tol": TOL_DECODE, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": "bytes", "library_ms": library_ms,
        "library": "F.scaled_dot_product_attention",
        "ms_host_pos": ms_host_pos, "empty_launch_ms": floor_ms,
        "empty_launch_ms_host_pos": floor_host_pos, "form_ms": form_ms,
        "launches_per_call": 1,
        "shape": f"B2={B} H={H} hd={hd} S={S}, mean over pos 0..{S - 2}, pos "
                 "read from device memory",
    }


# the batches at which both forms of each decode kernel are timed (the plan
# picks the cluster form at the first, the serving form at the last)
FORM_B2 = (4, 32, 64, 256)


def _form_times(gen, kind, b2s, H=16, hd=96, S=230, L=24):
    """ms a call of both forms of one decode kernel (``bf16``, ``int8``,
    ``int4`` or ``dots``: the int8 x int8 kernel over the int8 cache in the
    flagship's 8 groups) at each B2 of ``b2s``, the mean over the main path's
    positions 0 .. 228 read from device memory, layers cycled over ``L``
    caches: ``{B2: {"plan": form, "cluster": ms, "serve": ms}}``."""
    import torch

    from vaura_tpu_torch.ops import decode_attention as da

    groups8 = torch.tensor(dots_groups_s230(), dtype=torch.int32,
                           device="cuda")
    pos_t = torch.arange(S, dtype=torch.int32, device="cuda")
    positions = range(S - 1)
    bits = {"bf16": "bf16", "int8": 8, "int4": 4, "dots": 8}[kind]
    out = {}
    for B2 in b2s:
        rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda",
                                     dtype=torch.bfloat16)
        q, k1, v1 = rnd(B2, H, hd), rnd(B2, H, hd), rnd(B2, H, hd)
        widths = () if bits == "bf16" else (bits,)
        kc = _quant_caches(gen, (L, B2, S, H, hd), widths)
        vc = _quant_caches(gen, (L, B2, S, H, hd), widths)
        plan = da.kernel_plan(B2, H, H, S, hd, 0, True, kind=kind,
                              groups=groups8.numel())
        row = {"plan": plan["form"]}
        for form in da.FORMS:
            if bits == "bf16":
                call = lambda i, p: da.decode_attention_cuda(
                    q, kc["bf16"][i], vc["bf16"][i], k1, v1, pos_t[p:p + 1],
                    form=form)
            else:
                call = lambda i, p: da.decode_attention_cuda(
                    q, kc[bits][0][i], vc[bits][0][i], k1, v1, pos_t[p:p + 1],
                    kc[bits][1][i], vc[bits][1][i], cache_bits=bits,
                    int8_dots=kind == "dots",
                    chunk_starts=groups8 if kind == "dots" else None,
                    form=form)

            def run():
                for p in positions:
                    call(p % L, p)
            row[form] = cuda_ms(run, 10) / len(positions)
        out[str(B2)] = row
        log(f"[{kind} forms] B2={B2:3d}: cluster {row['cluster']:.5f} ms, "
            f"serve {row['serve']:.5f} ms; the plan takes {row['plan']}")
        del kc, vc
        torch.cuda.empty_cache()
    return out


def check_decode_attention_int8(gen):
    """The int8 instantiation (int8 K/V tiles, per-(position, KV head)
    float32 scales, the current position's K/V bf16) against its plain
    version; see ``_check_quant_decode``."""
    entry = _check_quant_decode(gen, "decode_attention_int8", 8, False)
    return {"name": "decode_attention_int8",
            # no Pallas kernel: the JAX package's int8 cache is einsums
            "replaces": "vaura_tpu/models/sampler.py:296", **entry,
            "shape": "B2=4 (and 256) H=16 hd=96 S=230 int8 cache, mean over "
                     "pos 0..228, pos read from device memory"}


# the int8 x int8 products quantize each attention probability p to an int8
# step of its group (p8 = round(p * v_scale / p_s), p_s the group's largest
# p * v_scale over 127): a p on the edge of a step may round the other way
# on the card (device exp, other sum orders) than in the plain version,
# which moves an output by p_s times the value's integer (at most 127; 7 in
# an int4 cache): one p8 step, at most the row's largest p * v_scale (times
# 7 / 127 for int4). Every output is held to TOL_DECODE; an output may pass
# it only by no more than one p8 step of its (batch row, head) plus one bf16
# ulp of the output (both sides round to bf16). One such flip moves a clump
# of the (batch row, head, pos) outputs at once, so the flips are counted as
# edge events, one a distinct (values, batch row, head, pos) over both forms
# (which read the same values), and one check may hold at most
# DOTS_EDGE_EVENTS of them, however large its sweep (on the H100: at most
# one in each of 18 sweeps of 0.7-2.8 million outputs over 6 seeds at 16, 8
# and 4 heads)
DOTS_EDGE_EVENTS = 4
# and the check must see the groups and the quantization of p: over every
# sweep, the kernel's mean distance from the plain version with other groups
# (one group against 8) and from the plain int8 (or int4) cache without the
# products must be DOTS_SEPARATION times its mean distance from its own
# plain version, or more (a kernel that ignored the groups or did not
# quantize p would sit as near the control as the control sits to the truth)
DOTS_SEPARATION = 10.0


def dots_groups_s230() -> list:
    """The flagship's quantization groups (S = 230, decode_buckets 8), as
    ``generate_tokens`` hands them to the kernel."""
    from vaura_tpu_torch.models.vaura import chunk_bounds

    return chunk_bounds(230, 8)[:-1]


def _quant_caches(gen, shape, bits_list=(8, 4)):
    """bf16 values of ``shape`` and their int8 / int4 caches, quantized a
    slice of the first axis at a time (the float32 temporaries of a whole
    serving cache would take tens of GB): ``{"bf16": x, 8: (q, s), 4: (q,
    s)}``."""
    import torch

    from vaura_tpu_torch.ops.quantization import quantize_kv, quantize_kv4

    x = torch.randn(*shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    out = {"bf16": x}
    for bits in bits_list:
        fn = quantize_kv4 if bits == 4 else quantize_kv
        parts = [fn(t) for t in x.unbind(0)]
        out[bits] = (torch.stack([p[0] for p in parts]),
                     torch.stack([p[1] for p in parts]))
    return out


def _p8_step(q, kq, vs, kcur, ks, pos, cbits):
    """One p8 step of the int8 x int8 products for each (batch row, head)
    at ``pos``, ``[B, H, 1]``: its largest p * v_scale over the cache rows
    (the scale p_s of the group that holds it) times the largest value
    integer."""
    import torch

    from vaura_tpu_torch.ops import decode_attention as da
    from vaura_tpu_torch.ops.quantization import unpack_int4

    if pos == 0:
        return torch.zeros(q.shape[0], q.shape[1], 1, device=q.device)
    k8 = unpack_int4(kq) if cbits == 4 else kq
    probs = da.dots_probs(q, k8, kcur, pos, ks)[..., :pos]
    rep = q.shape[1] // kq.shape[2]
    vsr = vs[:, :pos].float().repeat_interleave(rep, 2).transpose(1, 2)
    p_s = ((probs * vsr).amax(-1, keepdim=True) / 127).clamp_min(1e-8)
    return p_s * (7 if cbits == 4 else 127)


def _check_quant_decode(gen, tag, bits, dots, H=16, timed=True):
    """One quantized instantiation of decode attention (``bits`` 4 or 8
    cache, ``dots``: the int8 x int8 kernel), in each form (cluster,
    serving), against its plain version at the flagship shapes (``H``
    query heads: 16, or a model rank's) over positions 0..228 and 230 with
    ``pos`` on the host and in device memory, with GQA and at S = 1,024
    (with ``dots``: one group and the flagship's 8 groups, and over both
    cache widths); with ``timed``, timed in the plan's form at B2 = 4 and
    256 beside the int8 and bf16 kernels on the same values, SDPA on the
    bf16 values, an empty launch and the byte bound, and in both forms at
    each B2 of ``FORM_B2``."""
    import torch
    import torch.nn.functional as F

    from vaura_tpu_torch.ops import decode_attention as da

    hd, S, L = 96, 230, 24
    dev, bf = "cuda", torch.bfloat16
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev, dtype=bf)
    groups8 = torch.tensor(dots_groups_s230(), dtype=torch.int32, device=dev)
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    res = {"over_tol_decode": 0, "outputs": 0, "separation": {},
           "max_err_limit": TOL_DECODE}
    events = set()  # (values, batch row, head, pos) of the flips

    def hold(name, q, kv, kcur, vcur, positions, cbits, starts, form):
        """The kernel in ``form`` against its plain version at
        ``positions``; with ``dots`` also against the two controls
        (``DOTS_SEPARATION``)."""
        k, v = kv
        (kq, ks), (vq, vs) = k[cbits], v[cbits]
        kw = dict(cache_bits=cbits, int8_dots=dots, chunk_starts=starts)
        pos_t = torch.arange(kq.shape[1] + 1, dtype=torch.int32, device=dev)
        worst = 0.0
        dist = {"own": 0.0, "other_groups": 0.0, "no_products": 0.0}
        for pos in positions:
            want = da.decode_attention_plain(q, kq, vq, kcur, vcur, pos, ks,
                                             vs, **kw)
            got = da.decode_attention_cuda(q, kq, vq, kcur, vcur, pos, ks, vs,
                                           form=form, **kw)
            got_t = da.decode_attention_cuda(q, kq, vq, kcur, vcur,
                                             pos_t[pos:pos + 1], ks, vs,
                                             form=form, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, got_t):
                raise AssertionError(f"{tag} {name} pos={pos}: pos on the host "
                                     "and in device memory give different "
                                     "outputs")
            diff = (got.float() - want.float()).abs()
            over = diff > TOL_DECODE
            res["over_tol_decode"] += int(over.sum())
            res["outputs"] += diff.numel()
            worst = max(worst, float(diff.max()))
            if not dots:
                continue
            if over.any():
                ulp = torch.exp2(torch.floor(torch.log2(
                    want.float().abs().clamp_min(2.0 ** -126))) - 7)
                limit = TOL_DECODE + _p8_step(q, kq, vs, kcur, ks, pos,
                                              cbits) + ulp
                res["max_err_limit"] = max(res["max_err_limit"],
                                           float(limit[over].max()))
                if (diff > limit).any():
                    raise AssertionError(
                        f"{tag} {name} pos={pos}: an output "
                        f"{float(diff.max()):.3e} from the plain version, "
                        "more than 1e-2 plus one p8 step and one bf16 ulp")
                rows = {tuple(i[:2]) for i in over.nonzero().tolist()}
                values = name.rsplit(" ", 1)[0]  # the name less the form
                events.update((values, b, h, pos) for b, h in rows)
                log(f"[{tag}] {name} pos={pos}: {int(over.sum())} outputs "
                    f"past {TOL_DECODE} in (batch row, head) {sorted(rows)}, "
                    f"at most {float(diff.max()):.3e}, each within one p8 "
                    "step and one bf16 ulp")
            other = da.decode_attention_plain(
                q, kq, vq, kcur, vcur, pos, ks, vs, cache_bits=cbits,
                int8_dots=True, chunk_starts=one if starts.numel() > 1
                else groups8)
            plain_cache = da.decode_attention_plain(
                q, kq, vq, kcur, vcur, pos, ks, vs, cache_bits=cbits)
            dist["own"] += float(diff.sum())
            dist["other_groups"] += float(
                (got.float() - other.float()).abs().sum())
            dist["no_products"] += float(
                (got.float() - plain_cache.float()).abs().sum())
        log(f"[{tag}] {name} positions {positions[0]}..{positions[-1]} "
            f"({len(positions)}): max_abs_err={worst:.3e}")
        if not dots and not worst <= TOL_DECODE:
            raise AssertionError(f"{tag} {name}: max_abs_err {worst:.3e} over "
                                 f"{TOL_DECODE}")
        if dots:
            n_out = len(positions) * q.numel()
            mean = {key: d / n_out for key, d in dist.items()}
            res["separation"][name] = mean
            log(f"[{tag}] {name} mean distance of the kernel from its plain "
                f"version {mean['own']:.3e}, from the plain version of the "
                f"other groups {mean['other_groups']:.3e}, from the plain "
                f"int{cbits} cache without the products "
                f"{mean['no_products']:.3e}")
            for key in ("other_groups", "no_products"):
                if not mean[key] > DOTS_SEPARATION * mean["own"]:
                    raise AssertionError(
                        f"{tag} {name}: the kernel is {mean['own']:.3e} from "
                        f"its plain version and {mean[key]:.3e} from the "
                        f"control {key}: under {DOTS_SEPARATION}x apart")
        return worst

    B = 4
    widths = (8, 4) if dots else (bits,)
    kv = lambda *shape: (_quant_caches(gen, shape, widths),
                         _quant_caches(gen, shape, widths))
    q, kcur, vcur = rnd(B, H, hd), rnd(B, H, hd), rnd(B, H, hd)
    Hkv = H // 4
    flag, gqa, long = kv(B, S, H, hd), kv(B, S, Hkv, hd), kv(2, 1024, H, hd)
    edge = [0, 1, 30, 31, 32, 63, 64, 65, 87, 128, 207, 228, 229]
    err = 0.0
    group_sets = ((one, "one group"), (groups8, "8 groups")) if dots else \
        ((None, ""),)
    gqa_cur = (rnd(B, Hkv, hd), rnd(B, Hkv, hd))
    for form in da.FORMS:
        for cbits in widths:
            for starts, gname in group_sets:
                sfx = f" int{cbits} {gname}".rstrip() + f" {form}"
                err = max(err, hold("flagship" + sfx, q, flag, kcur, vcur,
                                    list(range(S - 1)) + [S], cbits, starts,
                                    form))
                err = max(err, hold(f"GQA H_kv={Hkv}" + sfx, q, gqa,
                                    *gqa_cur, edge, cbits, starts, form))
            long_starts = (torch.tensor([0, 100, 513], dtype=torch.int32,
                                        device=dev) if dots else None)
            err = max(err, hold(f"S=1024 int{cbits} {form}", q[:2], long,
                                kcur[:2], vcur[:2],
                                [0, 64, 511, 512, 513, 1000, 1024], cbits,
                                long_starts, form))
    limit = DOTS_EDGE_EVENTS if dots else 0
    log(f"[{tag}] outputs beyond {TOL_DECODE}: {res['over_tol_decode']} of "
        f"{res['outputs']}, in {len(events)} edge events (at most {limit})")
    if len(events) > limit or (not dots and res["over_tol_decode"]):
        raise AssertionError(f"{tag}: {len(events)} edge events beyond "
                             f"{TOL_DECODE}, more than {limit}")
    res["edge_events"], res["edge_event_limit"] = len(events), limit
    del flag, gqa, long
    torch.cuda.empty_cache()
    if not timed:
        return {"max_abs_err": err, **res}

    positions = list(range(S - 1))
    n = len(positions)
    pos_t = torch.arange(S, dtype=torch.int32, device=dev)
    kind = "dots" if dots else f"int{bits}"

    def timings(B2, with_plain):
        """ms per call over the main path's positions (layers cycled over L
        caches so that a sweep streams from device memory)."""
        qb, k1, v1 = rnd(B2, H, hd), rnd(B2, H, hd), rnd(B2, H, hd)
        kc = _quant_caches(gen, (L, B2, S, H, hd), (8, bits) if bits != 8 else (8,))
        vc = _quant_caches(gen, (L, B2, S, H, hd), (8, bits) if bits != 8 else (8,))
        kw = dict(cache_bits=bits, int8_dots=dots,
                  chunk_starts=groups8 if dots else None)

        def sweep(fn):
            def run():
                for p in positions:
                    fn(p % L, p)
            return run

        kq, ks = kc[bits]
        vq, vs = vc[bits]
        mine = lambda i, p: da.decode_attention_cuda(
            qb, kq[i], vq[i], k1, v1, pos_t[p:p + 1], ks[i], vs[i], **kw)
        int8 = lambda i, p: da.decode_attention_cuda(
            qb, kc[8][0][i], vc[8][0][i], k1, v1, pos_t[p:p + 1], kc[8][1][i],
            vc[8][1][i])
        bf16 = lambda i, p: da.decode_attention_cuda(
            qb, kc["bf16"][i], vc["bf16"][i], k1, v1, pos_t[p:p + 1])
        # the plain version reads the groups from the host (a device tensor
        # cannot be read back inside a CUDA graph's capture)
        plain = lambda i, p: da.decode_attention_plain(
            qb, kq[i], vq[i], k1, v1, p, ks[i], vs[i],
            **dict(kw, chunk_starts=dots_groups_s230() if dots else None))
        sdpa = lambda i, p: F.scaled_dot_product_attention(
            qb[:, :, None], kc["bf16"][i][:, :p + 1].transpose(1, 2),
            vc["bf16"][i][:, :p + 1].transpose(1, 2))
        empty = lambda i, p: da.empty_launch(
            B2, H, H, S, hd, 0, True, dev, kind=kind,
            groups=groups8.numel() if dots else 1)
        # the form the plan picks at this batch (shapes only)
        form = da.kernel_plan(B2, H, H, S, hd, 0, True, kind=kind,
                              groups=groups8.numel())["form"]
        out = {"form": form, "ms": cuda_ms(sweep(mine), 20) / n}
        if kind != "int8":
            out["int8_ms"] = cuda_ms(sweep(int8), 20) / n
        out.update({"bf16_ms": cuda_ms(sweep(bf16), 20) / n,
               "sdpa_bf16_ms": cuda_ms(sweep(sdpa), 20) / n,
               "empty_launch_ms": cuda_ms(sweep(empty), 20) / n})
        if with_plain:
            out["plain_ms"] = cuda_ms(sweep(plain), 3) / n
        io = (2 * B2 * H * hd + 2 * B2 * H * hd) * 2  # q, k/v_cur in, out
        row = hd // 2 if bits == 4 else hd  # bytes of a cached row
        out["bound_ms"] = sum(
            (io + 2 * B2 * p * H * (row + 4)) / HBM_BYTES_PER_S
            for p in positions) / n * 1e3
        del kc, vc
        torch.cuda.empty_cache()
        return out

    small, serving = timings(B, True), timings(256, False)
    for t_tag, t in (("B2=4", small), ("B2=256", serving)):
        log(f"[{tag}] {t_tag} ms per call: {t['ms']:.5f} ({t['form']} form), "
            f"int8 kernel {t.get('int8_ms', t['ms']):.5f}, bf16 kernel "
            f"{t['bf16_ms']:.5f}, SDPA on the bf16 values "
            f"{t['sdpa_bf16_ms']:.5f}, an empty launch "
            f"{t['empty_launch_ms']:.5f}; bound {t['bound_ms']:.5f}")
    form_ms = _form_times(gen, kind, FORM_B2)
    return {
        "route": "cuda", "source": "vaura_tpu_torch/csrc/decode_attention.cu",
        "max_abs_err": err, "tol": TOL_DECODE, "ms": small["ms"],
        "plain_ms": small["plain_ms"], "bound_ms": small["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "b2_4": small,
        "b2_256": serving, "form_ms": form_ms, **res,
    }


def check_decode_attention_int4(gen):
    """The int4 instantiation (packed nibble tiles, the int8 scales) against
    its plain version; see ``_check_quant_decode``."""
    entry = _check_quant_decode(gen, "decode_attention_int4", 4, False)
    return {"name": "decode_attention_int4",
            # no Pallas kernel: the JAX package unpacks, then its einsums
            "replaces": "vaura_tpu/models/sampler.py:317", **entry,
            "shape": "B2=4 (and 256) H=16 hd=96 S=230 int4 cache, mean over "
                     "pos 0..228, pos read from device memory"}


def check_decode_attention_int8_dots(gen):
    """The int8 x int8 kernel over the int8 cache (held over the int4 cache
    too) against its plain version, in one group and in the flagship's 8;
    timed over the int8 cache in 8 groups; see ``_check_quant_decode``."""
    entry = _check_quant_decode(gen, "decode_attention_int8_dots", 8, True)
    return {"name": "decode_attention_int8_dots",
            # no Pallas kernel: the JAX package's int8_dots einsums
            "replaces": "vaura_tpu/models/sampler.py:306", **entry,
            "shape": "B2=4 (and 256) H=16 hd=96 S=230 int8 cache, 8 groups "
                     "(decode_buckets 8), mean over pos 0..228, pos read "
                     "from device memory"}


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
    from vaura_tpu_torch.dryrun import launch_counts

    return launch_counts()


def _differs(launches, want) -> bool:
    """Whether two launch-count dicts differ, a missing kernel counting 0
    (the expectations name the kernels a path launches)."""
    return any(launches.get(k, 0) != want.get(k, 0)
               for k in set(launches) | set(want))


def _zero_counters():
    from vaura_tpu_torch.ops import decode_attention as da
    from vaura_tpu_torch.ops import decode_block as db
    from vaura_tpu_torch.ops import divided_attention as ga
    from vaura_tpu_torch.ops import encoder_fused as ef
    from vaura_tpu_torch.ops import mla_decode_attention as mla
    from vaura_tpu_torch.ops import snake

    da.launches = ef.attention_launches = ef.mlp_launches = ga.launches = 0
    mla.launches = snake.launches = 0
    for name in db.launches:
        db.launches[name] = 0
    da.device_pos_launches = da.int8_launches = 0
    da.int4_launches = da.int8_dots_launches = 0
    for form in da.form_launches:
        da.form_launches[form] = 0


def _form_counts() -> dict:
    """The decode kernels' launches in each form since the counters were
    zeroed."""
    from vaura_tpu_torch.ops import decode_attention as da

    return dict(da.form_launches)


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
    from vaura_tpu_torch.models import vaura as V
    steps = V.replayed_steps, V.eager_steps
    t0 = time.time()
    out = system.generate(frames, seed=0, **GENERATE_KW)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, forms = _counters(), _form_counts()
    from vaura_tpu_torch.ops import decode_attention as da
    device_pos = da.device_pos_launches
    replayed, eager = V.replayed_steps - steps[0], V.eager_steps - steps[1]
    expected["grouped_cls_attention"] = 0  # inference takes the fused blocks
    expected["decode_attention_int8"] = 0
    codes, audio = out["codes"], out["audio"]
    report["main"] = {
        "wall_s": wall, "stage_ms": out["stage_ms"], "launches": launches,
        "expected_launches": expected, "form_launches": forms,
        "decode_attention_device_pos_launches": device_pos,
        "replayed_steps": replayed, "eager_steps": eager,
        "codes_shape": list(codes.shape),
        "audio_shape": list(audio.shape),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    log(f"[main] wall {wall:.2f} s, stages (ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in out["stage_ms"].items()))
    log(f"[main] launches {launches} expected {expected}; decode attention "
        f"launches with pos in device memory: {device_pos}, by form {forms}")
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
    if forms != {"cluster": expected["decode_attention"], "serve": 0}:
        problems.append(f"decode_attention at batch 2: launches by form "
                        f"{forms}, expected the cluster form only")
    if (replayed, eager) != (n_steps - V.GRAPH_WARMUP_STEPS,
                             V.GRAPH_WARMUP_STEPS):
        problems.append(f"{replayed} decode steps replayed, {eager} eager, "
                        f"expected all but {V.GRAPH_WARMUP_STEPS} of "
                        f"{n_steps} replayed")
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


def _graph_or_eager(system, feats, eager: bool) -> dict:
    """One generation from features (no codec, seed 0, the flagship's
    sampling) with the graph loop, or with the eager loop (``eager``: no
    loop reaches ``GRAPH_MIN_STEPS`` then); its codes, decode-loop ms,
    steps replayed and run eagerly, launches and the host ms of its spans
    by name."""
    import torch

    from vaura_tpu_torch.flagship import GENERATE_KW
    from vaura_tpu_torch.models import vaura as V
    from vaura_tpu_torch.utils.spans import recording

    torch.cuda.synchronize()
    _zero_counters()
    steps = V.replayed_steps, V.eager_steps
    reserved = torch.cuda.memory_reserved()
    min_steps = V.GRAPH_MIN_STEPS
    if eager:
        V.GRAPH_MIN_STEPS = 1 << 30
    try:
        with recording() as records:
            out = system.generate(vis_feats=feats, seed=0,
                                  decode_to_audio=False, **GENERATE_KW)
            torch.cuda.synchronize()
    finally:
        V.GRAPH_MIN_STEPS = min_steps
    spans = {}
    for name, _, a, b in records:
        d = spans.setdefault(name, [0, 0.0])
        d[0] += 1
        d[1] += (b - a) / 1e6
    return {"codes": out["codes"],
            "decode_loop_ms": out["stage_ms"]["decode_loop"],
            "replayed_steps": V.replayed_steps - steps[0],
            "eager_steps": V.eager_steps - steps[1],
            "launches": _counters(), "form_launches": _form_counts(),
            "block_launches": _block_counts(),
            "reserved_growth_mib": (torch.cuda.memory_reserved()
                                    - reserved) / 2 ** 20,
            "span_host_ms": {n: {"count": c, "mean_ms": ms / c}
                             for n, (c, ms) in spans.items()}}


def _block_case(name, got, want, fn, plain, bytes_, timed) -> dict:
    """One decode-block kernel case: each output against the plain path's
    (ulps of a float output, equality of an int8 one), and where ``timed``
    the device ms of the kernel and of the plain path and the byte
    bound."""
    import torch

    outs = []
    for g, w in zip(got, want):
        if g.dtype.is_floating_point:
            outs.append({"dtype": str(g.dtype).split(".")[-1],
                         "ulps": _max_ulps(g, w),
                         "bit_equal": bool(torch.equal(g, w))})
        else:
            outs.append({"dtype": str(g.dtype).split(".")[-1], "ulps": None,
                         "bit_equal": bool(torch.equal(g, w))})
    e = {"name": name, "outputs": outs,
         "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3}
    if timed:
        e["ms"] = cuda_ms(fn, 50)
        e["plain_ms"] = cuda_ms(plain, 50)
        e["bound_share"] = e["bound_ms"] / e["ms"]
    return e


def _decode_block_kernels(gen) -> list:
    """The decode block's kernels (``csrc/decode_block.cu``) against their
    plain paths (on the card: the eager ops they replace): the norm with
    and without the residual at d 1536 and 2048, RoPE with and without the
    int8 store at three positions, SwiGLU at 4096, 2816 and 11264, each at
    B2 = 1,024 rows in bf16 (timed, beside the plain path and the byte
    bound), once in float32, and on the scalar paths (widths that are no
    multiple of a 16-byte vector)."""
    import torch

    from vaura_tpu_torch.ops import decode_block as db
    from vaura_tpu_torch.ops.rope import precompute_freqs_cis

    R, H, hd, L = DECODE_BLOCK_ROWS, 16, 96, 24
    cases = []

    def rand(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(dtype)

    for D, dtype, timed in ((1536, torch.bfloat16, True),
                            (2048, torch.bfloat16, True),
                            (1536, torch.float32, False),
                            (1004, torch.bfloat16, False)):
        x, a = rand(R, 1, D, dtype=dtype), rand(R, 1, D, dtype=dtype)
        w = torch.empty(D, device="cuda").uniform_(0.5, 1.5, generator=gen)
        tag = f"d{D}_{str(dtype).split('.')[-1]}"
        el = x.element_size()
        cases.append(_block_case(
            f"add_rmsnorm_{tag}", db.add_rmsnorm_cuda(x, a, w, 1e-5),
            db.add_rmsnorm_plain(x, a, w, 1e-5),
            lambda: db.add_rmsnorm_cuda(x, a, w, 1e-5),
            lambda: db.add_rmsnorm_plain(x, a, w, 1e-5),
            4 * R * D * el + 4 * D, timed))
        cases.append(_block_case(
            f"rmsnorm_{tag}", (db.rmsnorm_cuda(x, w, 1e-5),),
            (db.rmsnorm_plain(x, w, 1e-5),),
            lambda: db.rmsnorm_cuda(x, w, 1e-5),
            lambda: db.rmsnorm_plain(x, w, 1e-5),
            2 * R * D * el + 4 * D, timed and D == 1536))

    table = torch.as_tensor(precompute_freqs_cis(256, hd), device="cuda")
    for pos, dtype, head_dim, timed in ((0, torch.bfloat16, hd, False),
                                        (100, torch.bfloat16, hd, False),
                                        (228, torch.bfloat16, hd, True),
                                        (228, torch.float32, hd, False),
                                        (57, torch.bfloat16, 20, False)):
        cs = (table if head_dim == hd else torch.as_tensor(
            precompute_freqs_cis(256, head_dim), device="cuda"))[pos:pos + 1]
        N = 3 * H * head_dim
        qkv = rand(R, 1, N, dtype=dtype, scale=2.0)
        tag = f"pos{pos}_hd{head_dim}_{str(dtype).split('.')[-1]}"
        bufs = [[torch.zeros(L, R, H, head_dim, dtype=torch.int8,
                             device="cuda") for _ in range(2)]
                + [torch.zeros(L, R, H, device="cuda") for _ in range(2)]
                for _ in range(2)]
        got = db.rope_qkv_store_cuda(qkv, cs, H, H, *bufs[0], layer=5)
        want = db.rope_qkv_store_plain(qkv, cs, H, H, *bufs[1], layer=5)
        el = qkv.element_size()
        cases.append(_block_case(
            f"rope_qkv_store_{tag}", got + tuple(bufs[0]),
            want + tuple(bufs[1]),
            lambda: db.rope_qkv_store_cuda(qkv, cs, H, H, *bufs[0], layer=5),
            lambda: db.rope_qkv_store_plain(qkv, cs, H, H, *bufs[1],
                                            layer=5),
            R * (2 * N * el + 2 * H * head_dim + 8 * H) + head_dim * 4,
            timed))
        cases.append(_block_case(
            f"rope_qkv_{tag}", db.rope_qkv_store_cuda(qkv, cs, H, H),
            db.rope_qkv_store_plain(qkv, cs, H, H),
            lambda: db.rope_qkv_store_cuda(qkv, cs, H, H),
            lambda: db.rope_qkv_store_plain(qkv, cs, H, H),
            R * 2 * N * el + head_dim * 4, False))

    for rows, n, dtype, timed in ((R, 4096, torch.bfloat16, True),
                                  (R, 2816, torch.bfloat16, True),
                                  (R, 11264, torch.bfloat16, True),
                                  (R, 4096, torch.float32, False),
                                  (R - 1, 4095, torch.bfloat16, False)):
        g, u = (rand(rows, 1, n, dtype=dtype, scale=3.0),
                rand(rows, 1, n, dtype=dtype, scale=3.0))
        cases.append(_block_case(
            f"swiglu_{n}_{str(dtype).split('.')[-1]}",
            (db.swiglu_cuda(g, u),), (db.swiglu_plain(g, u),),
            lambda: db.swiglu_cuda(g, u), lambda: db.swiglu_plain(g, u),
            3 * rows * n * g.element_size(), timed))
    torch.cuda.empty_cache()
    return cases


def _block_counts() -> dict:
    from vaura_tpu_torch.ops import decode_block as db

    return dict(db.launches)


def phase_decode_graph(_gen, report):
    """The decode loop replayed from a CUDA graph against the eager loop
    on one seed: batch 2 with the bf16 cache (``phase_main``'s flagship)
    and batch 64 with the int8 cache (as the benchmark serves), with the
    decode block's kernel launches a step (``ops/decode_block.py``: 2 L + 1
    norms, L RoPEs, L SwiGLUs); first each of those kernels against its
    plain path (``_decode_block_kernels``). Weights, features and inputs
    come from a generator of its own, so the phases after it draw from the
    shared one what they drew before this phase was added."""
    import torch

    from vaura_tpu_torch.flagship import GENERATE_KW, flagship_system
    from vaura_tpu_torch.models import vaura as V

    gen = torch.Generator(device="cuda").manual_seed(21)
    res, problems = {}, []
    res["kernels"] = _decode_block_kernels(
        torch.Generator(device="cuda").manual_seed(25))
    for e in res["kernels"]:
        tol = (TOL_NORM_ULPS[e["outputs"][-1]["dtype"]]
               if "rmsnorm" in e["name"] else 0)
        ulps = [o["ulps"] for o in e["outputs"] if o["ulps"] is not None]
        exact = [o["bit_equal"] for o in e["outputs"]
                 if o["ulps"] is None]
        timing = (f"{e['ms']:.4f} ms ({100 * e['bound_share']:.1f}% of "
                  f"{e['bound_ms']:.4f}), plain {e['plain_ms']:.4f} ms"
                  if "ms" in e else "")
        log(f"[decode_graph] {e['name']}: ulps {ulps}, int8 equal {exact} "
            f"{timing}")
        # the norm's last output may differ (its sum's order), its h not
        if "rmsnorm" in e["name"]:
            ulps, last = ulps[:-1], ulps[-1]
            if last > tol:
                problems.append(f"{e['name']}: {last} ulps")
        if any(u != 0 for u in ulps) or not all(exact):
            problems.append(f"{e['name']}: not bit for bit ({e['outputs']})")
    for tag, batch, overrides, kernel in (
            ("b2_bf16", 2, {}, "decode_attention"),
            ("b64_int8", 64, {"quantize_cache": True},
             "decode_attention_int8")):
        system = flagship_system("cuda", gen, sampler_overrides=overrides,
                                 encoder=False)
        cfg = system.sampler_config
        feats = torch.randn(batch, 32, cfg.cond_in_dim, generator=gen,
                            device="cuda")
        n_steps = system.prepare_generation(
            GENERATE_KW["max_new_tokens"])[2] - 1
        want = {kernel: cfg.num_layers * n_steps}
        want_block = {"add_rmsnorm": (2 * cfg.num_layers + 1) * n_steps,
                      "rope_qkv_store": cfg.num_layers * n_steps,
                      "swiglu": cfg.num_layers * n_steps}
        _graph_or_eager(system, feats, False)  # the path warmed up
        graph = _graph_or_eager(system, feats, False)
        eager = _graph_or_eager(system, feats, True)
        equal = float((graph["codes"] == eager["codes"]).float().mean())
        r = {"batch": batch, "steps": n_steps, "equal_token_share": equal,
             "expected_launches": want,
             "expected_block_launches": want_block,
             "block_launches_a_step": {
                 k: v / n_steps for k, v in graph["block_launches"].items()}}
        for side, run in (("graph", graph), ("eager", eager)):
            r[side] = {k: v for k, v in run.items() if k != "codes"}
        res[tag] = r
        log(f"[decode_graph] {tag}: equal tokens {100 * equal:.4f}%; graph "
            f"{graph['replayed_steps']} replayed + {graph['eager_steps']} "
            f"eager steps, loop {graph['decode_loop_ms']:.1f} ms; eager "
            f"loop {eager['decode_loop_ms']:.1f} ms; spans (host ms) "
            f"{graph['span_host_ms']}; pool reserved "
            f"{graph['reserved_growth_mib']:.1f} MiB")
        if equal != 1.0:
            problems.append(f"{tag}: {100 * equal:.4f}% of the replayed "
                            "tokens equal the eager loop's")
        if (graph["replayed_steps"], graph["eager_steps"]) != (
                n_steps - V.GRAPH_WARMUP_STEPS, V.GRAPH_WARMUP_STEPS):
            problems.append(f"{tag}: {graph['replayed_steps']} replayed, "
                            f"{graph['eager_steps']} eager steps")
        if (eager["replayed_steps"], eager["eager_steps"]) != (0, n_steps):
            problems.append(f"{tag}: the eager loop replayed "
                            f"{eager['replayed_steps']} steps")
        for side, run in (("graph", graph), ("eager", eager)):
            if _differs(run["launches"], want):
                problems.append(f"{tag} {side}: launches {run['launches']}, "
                                f"expected {want}")
            if run["block_launches"] != want_block:
                problems.append(f"{tag} {side}: decode block launches "
                                f"{run['block_launches']}, expected "
                                f"{want_block}")
        del system
        torch.cuda.empty_cache()
    report["decode_graph"] = res
    print("decode_graph: " + json.dumps(res, default=str))
    if problems:
        raise AssertionError("; ".join(problems))


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
                      "decode_attention_device_pos_launches": device_pos,
                      "form_launches": _form_counts()}
    log(f"[int8] wall {wall:.2f} s, stages (ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in out["stage_ms"].items()))
    log(f"[int8] launches {launches} expected {expected}; with pos in device "
        f"memory: {device_pos}")
    problems = []
    _check_generation("int8", out, (2, 9, 221), problems)
    if _differs(launches, expected):
        problems.append(f"launches {launches}, expected {expected}")
    if device_pos != expected["decode_attention_int8"]:
        problems.append(f"{device_pos} decode launches took pos from device "
                        "memory, expected all")
    del system
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


def _long_decode_steps(system, total, stride, max_tokens) -> int:
    """Decode steps of ``generate_long`` (each of every layer): a chunk of n
    tokens has S = n + 9 steps; the first starts at step 1, the others at
    the step of the prompt's first timestep to generate (+ 1 for the BOS
    row); the prompts go through ``prefill``."""
    sizes = system.long_chunk_schedule(total, stride, max_tokens)
    steps, prompt = 0, 0
    for n_new in sizes:
        S = system.prepare_generation(n_new + prompt)[2]
        steps += S - (1 if prompt == 0 else prompt + 1)
        prompt = max(0, n_new + prompt - stride)
    return steps


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

    steps = _long_decode_steps(system, total, stride, max_tokens)
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
        if _differs(launches, want):
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

    # a host copy of every leaf, compared element for element after the
    # steps: a fingerprint such as the float64 sum can miss a change, since
    # the warm-up updates (about 1e-6, of either sign) on a norm scale of
    # ones may sum to exactly zero over its elements
    mark = lambda: {k: p.detach().cpu()
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
        if _differs(seen, want):
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
    same = {k: torch.equal(after[k], before[k]) for k in after}
    del before, after
    unchanged = [k for k in state.params
                 if same[k] and not k.endswith("uncond_embedding")]
    moved = [k for k in same if not same[k]
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


# latent attention: the kernel's output against its plain version (same
# bf16 inputs, float32 outputs of about 1-5): the plain version rounds the
# probabilities to bf16 against the global maximum, the kernel against
# each tile's running one, and sums in another order (measured ~3e-3)
TOL_MLA = 1e-2
# the DeepSeek-V3 sampler at published widths in bf16 against the float32
# reference following its routing: the relative L2 error of each
# position's logits [K, V] (27 layers of bf16 weights and activations:
# 1.9% over a whole forward, 2.3% at the worst of 96 positions, measured)
# and the widest route gap (the program's choices below the reference's
# own top-k, in sigmoid-score units: bf16 scores at near-ties, 0.011
# measured over 96 positions and 26 layers; a missing expert reads 1)
TOL_MLA_MOE_REL = 4e-2
TOL_MLA_MOE_ROUTE = 3e-2
MOONLIGHT = os.path.join("port_bench", "configs", "vaura_moonlight16b.json")


def check_mla_decode_attention(gen, B=1024, H=16, S=230, R=512, r=64):
    """The latent-attention decode kernel (``ops/mla_decode_attention.py``,
    Triton) at the Moonlight cell's shapes (B = 512 clips x 2 for CFG, 16
    heads, a 230-row cache of 512 + 64 values), ``pos`` in device memory,
    at positions 0 .. 229 in steps of 13 against its plain version, then
    timed at the last position (the bound: the cache's bytes over 3.35
    TB/s), beside SDPA on the rows expanded to every head."""
    import torch
    import torch.nn.functional as F

    from vaura_tpu_torch.ops import mla_decode_attention as M

    q = torch.randn(B, H, R + r, device="cuda", generator=gen).bfloat16()
    c = torch.randn(B, S, R, device="cuda", generator=gen).bfloat16()
    pe = torch.randn(B, S, r, device="cuda", generator=gen).bfloat16()
    cn = torch.randn(B, R, device="cuda", generator=gen).bfloat16()
    pn = torch.randn(B, r, device="cuda", generator=gen).bfloat16()
    scale = (128 + r) ** -0.5
    err = 0.0
    for p in list(range(0, S, 13)) + [S - 1]:
        pos = torch.full((1,), p, dtype=torch.int32, device="cuda")
        got = M.mla_decode_attention(q, c, pe, cn, pn, pos, scale)
        want = M.mla_decode_attention_plain(q, c, pe, cn, pn, pos, scale)
        err = max(err, max_err(got, want))
    pos = torch.full((1,), S - 1, dtype=torch.int32, device="cuda")
    ms = cuda_ms(lambda: M.mla_decode_attention(q, c, pe, cn, pn, pos, scale), 50)
    plain_ms = cuda_ms(lambda: M.mla_decode_attention_plain(
        q, c, pe, cn, pn, pos, scale), 5)
    keys = torch.cat([c, pe], -1)[:, None].expand(B, H, S, R + r)
    vals = c[:, None].expand(B, H, S, R)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], keys[:, :, :S - 1], vals[:, :, :S - 1], scale=scale), 20)
    bytes_ = B * ((S - 1) * (R + r) * 2 + H * (R + r) * 2 + (R + r) * 2
                  + H * R * 4)
    entry = {"name": "mla_decode_attention",
             "route": "Triton, ops/mla_decode_attention.py, 1 launch a call",
             "source": "vaura_tpu_torch/ops/mla_decode_attention.py",
             "replaces": "none (the JAX package has no latent attention)",
             "max_abs_err": err, "tol": TOL_MLA, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bytes_ / 3.35e12 * 1e3,
             "bound_by": "bytes", "library_ms": lib}
    log(f"[mla_decode_attention] B={B} S={S}: max err {err:.3e}, "
        f"{ms:.4f} ms (bound {entry['bound_ms']:.4f}, plain {plain_ms:.3f}, "
        f"SDPA {lib:.4f})")
    return entry


def _moonlight(seed: int):
    """The Moonlight sampler as the benchmark builds it (its weights from
    the seed, one copy), and the configuration."""
    import torch

    from port_bench.traffic import generate_mla_moe

    config = json.loads(open(os.path.join(ROOT, MOONLIGHT)).read())
    system, made = generate_mla_moe.build(config, torch.device("cuda"), seed)
    return system, made, config


def phase_mla_moe(gen, report):
    """The DeepSeek-V3 sampler at published widths (Moonlight-16B-A3B's
    block, ``port_bench/configs/vaura_moonlight16b.json``), bf16:
    (a) 2 clips of 48 positions: ``prefill`` of 16, then decode steps
    through the latent cache (host positions, eager) and the same steps
    replayed from a CUDA graph of the device-position step, every
    position's logits against the float32 reference's full forward, which
    follows the program's routing (``route_gap`` judges the choices); the
    latent cache rounded through float8 (a control) beside; (b) one
    generation at B = 512 from features (CFG 6, top-k 128, 221 tokens):
    the steps replayed, the kernel's launches, the wall; (c) the generate
    action from ``configs/generate_vgg_moonlight.yaml`` at its batch of 16
    (the dummy datamodule, seeded weights): WAVs written."""
    import shutil

    import torch

    from port_bench import check
    from port_bench.reference import sampler_mla_moe as ref
    from vaura_tpu_torch.main import main as port_main
    from vaura_tpu_torch.models import vaura as V
    from vaura_tpu_torch.models.sampler import MoEFeedForward
    from vaura_tpu_torch.ops import mla_decode_attention as M
    from vaura_tpu_torch.ops.patterns import DelayedPatternProvider

    res, problems = {}, []
    system, made, config = _moonlight(7)
    s, scfg = system.sampler, config["sampler"]
    L = system.sampler_config.moe_layers
    B, K, T, P = 2, 9, 48, 16
    g = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, 1024, (B, K, T), device="cuda", generator=g)
    feats = torch.randn(B, 32, 768, device="cuda", generator=g)
    cond = s.build_cond_seq(s.embed_cond(feats), T, 7)
    moe = [l.feed_forward for l in s.layers
           if isinstance(l.feed_forward, MoEFeedForward)]

    def decode(rounding=None, graph=False):
        """Logits [B, K, T] of prefill + decode, and the routes [T, L, B, k]."""
        store = s._store
        if rounding:
            s._store = lambda k_, v_: {n: t.to(rounding).to(t.dtype)
                                       for n, t in store(k_, v_).items()}
        try:
            with torch.no_grad():
                logits, pre = s.prefill(tokens[:, :, :P], cond[:, :P])
                routes = torch.full((T, L, B, 6), 255, dtype=torch.uint8,
                                    device="cuda")
                routes[:P] = torch.stack([ff.routed_choice.reshape(B, P, 6)
                                          for ff in moe], 1).permute(2, 1, 0, 3)
                cache = s.init_cache(B, T)
                for n in ("c", "k_pe"):
                    cache[n][:, :, :P] = pre[n]
                s.expert_choices = routes
                out = [logits[:, :, p] for p in range(P)]
                if not graph:
                    for p in range(P, T):
                        out.append(s.decode_step(tokens[:, :, p:p + 1],
                                                 cond[:, p:p + 1], cache, p))
                else:
                    tok = tokens[:, :, P:P + 1].clone()
                    cnd = cond[:, P:P + 1].clone()
                    pos = torch.full((), P, dtype=torch.int64, device="cuda")
                    buf = torch.empty(B, K, 1024, device="cuda")

                    def step():
                        lg, rows = s.decode_rows(tok, cnd, cache, pos)
                        s.commit_rows(cache, rows, pos)
                        buf.copy_(lg)
                    side = torch.cuda.Stream()
                    side.wait_stream(torch.cuda.current_stream())
                    graph_ = torch.cuda.CUDAGraph()
                    with torch.cuda.stream(side):
                        step()  # the eager warm-up writes position P
                        out.append(buf.clone())
                        with torch.cuda.graph(graph_, stream=side):
                            step()
                    torch.cuda.current_stream().wait_stream(side)
                    for p in range(P + 1, T):
                        pos.fill_(p)
                        tok.copy_(tokens[:, :, p:p + 1])
                        cnd.copy_(cond[:, p:p + 1])
                        graph_.replay()
                        out.append(buf.clone())
                return torch.stack(out, 2).float(), routes
        finally:
            s._store = store
            s.expert_choices = None

    eager, routes = decode()
    launches = M.launches
    replay, routes_g = decode(graph=True)
    res["replay_launches"] = M.launches - launches
    fp8, routes_f = decode(rounding=torch.float8_e4m3fn)
    with torch.no_grad(), check.exact_matmuls():
        def reference(r):
            gaps = []
            sd = made["sampler"]
            c_ = ref.S.cond_sequence(sd, ref.S.project_cond(sd, feats), T, 7)
            return ref.forward(sd, scfg, tokens, c_, r, gaps), max(
                float(t.max()) for t in gaps)
        want, gap = reference(routes)
        want_g, gap_g = reference(routes_g)
        want_f, gap_f = reference(routes_f)

    def rel(a, b):
        return ((a - b).pow(2).sum((1, 3)) / b.pow(2).sum((1, 3))).sqrt()

    res["eager_rel"] = rel(eager, want).max().item()
    res["replay_rel"] = rel(replay, want_g).max().item()
    res["replay_vs_eager_max_abs"] = max_err(replay, eager)
    res["fp8_rel"] = rel(fp8, want_f).max().item()
    res["route_gap"] = {"eager": gap, "replay": gap_g, "fp8": gap_f}
    res["per_position_rel"] = rel(eager, want).max(0).values.tolist()
    log(f"[mla_moe] logits vs reference (relative L2 a position, worst): "
        f"eager {res['eager_rel']:.4f}, replayed {res['replay_rel']:.4f} "
        f"(replay vs eager max abs {res['replay_vs_eager_max_abs']:.3e}), "
        f"fp8 latent cache {res['fp8_rel']:.4f}; route gap {res['route_gap']}")
    for tag in ("eager_rel", "replay_rel"):
        if not res[tag] <= TOL_MLA_MOE_REL:
            problems.append(f"{tag} {res[tag]:.4f} > {TOL_MLA_MOE_REL}")
    if not max(gap, gap_g) <= TOL_MLA_MOE_ROUTE:
        problems.append(f"route gap {max(gap, gap_g)} > {TOL_MLA_MOE_ROUTE}")
    # the warm-up step and the recording (a replay launches without the
    # wrapper): one launch a layer each
    if res["replay_launches"] != 2 * 27:
        problems.append(f"the replayed decode's warm-up and recording "
                        f"launched the kernel {res['replay_launches']} "
                        "times, not 54")

    # (b) the cell's batch through VauraSystem.generate: one launch a
    # layer and step, a replay counting what its recording launched; of
    # the decode block's kernels 2 L + 1 norms and L SwiGLUs (layer 0's
    # dense one, then the shared experts') a step, no RoPE (the latent
    # attention's own)
    x = torch.randn(512, 32, 768, device="cuda", generator=g)
    n_layers = system.sampler_config.num_layers
    n_steps_b = system.prepare_generation(221)[2] - 1
    want_b = n_layers * n_steps_b
    want_block = {"add_rmsnorm": (2 * n_layers + 1) * n_steps_b,
                  "rope_qkv_store": 0, "swiglu": n_layers * n_steps_b}
    replayed, eager_n = V.replayed_steps, V.eager_steps
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.time()
    out = system.generate(vis_feats=x, max_new_tokens=221, cfg_scale=6.0,
                          top_k=128, tokens_per_frame=7, dac_chunk_size=32,
                          seed=5)
    torch.cuda.synchronize()
    res["b512"] = {"wall_s": time.time() - t0, "stage_ms": out["stage_ms"],
                   "replayed": V.replayed_steps - replayed,
                   "eager": V.eager_steps - eager_n,
                   "mla_launches": M.launches,
                   "expected_mla_launches": want_b,
                   "block_launches": _block_counts(),
                   "expected_block_launches": want_block,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"[mla_moe] B=512: {res['b512']}")
    codes = out["codes"]
    if res["b512"]["replayed"] < 227 or not (
            0 <= int(codes.min()) and int(codes.max()) < 1024):
        problems.append(f"B=512 generation: {res['b512']}")
    if M.launches != want_b:
        problems.append(f"B=512 generation: {M.launches} launches of "
                        f"mla_decode_attention, expected {want_b}")
    if res["b512"]["block_launches"] != want_block:
        problems.append(f"B=512 generation: decode block launches "
                        f"{res['b512']['block_launches']}, expected "
                        f"{want_block}")
    del out, system, made, s, x
    torch.cuda.empty_cache()

    # (c) the generate action, as a user runs it
    root = os.path.join(OUT_DIR, "action", "moonlight")
    shutil.rmtree(root, ignore_errors=True)
    tokens_c = int(2.56 * 86)  # the yaml's 2.56 s clips
    want_c = n_layers * (DelayedPatternProvider(9).get_pattern(
        tokens_c)._build_seq_tables(tokens_c)[1].shape[1] - 1)
    _zero_counters()
    t0 = time.time()
    result = port_main([
        f"config={os.path.join(ROOT, 'configs/generate_vgg_moonlight.yaml')}",
        "dataloader.dataset_type=dummy", "dataloader.num_workers=0",
        "max_batches=1", f"output_dir={root}"])
    wavs = sorted(f for f in os.listdir(root) if f.endswith(".wav"))
    res["action"] = {"wall_s": time.time() - t0,
                     "num_generated": result["num_generated"],
                     "wavs": len(wavs), "mla_launches": M.launches,
                     "expected_mla_launches": want_c}
    log(f"[mla_moe] generate action: {res['action']}")
    if result["num_generated"] != 16 or len(wavs) != 16 or \
            M.launches != want_c:
        problems.append(f"generate action: {res['action']}")
    torch.cuda.empty_cache()
    report["mla_moe"] = res
    if problems:
        raise AssertionError("; ".join(problems))
    # the main paths' own launches: (b) and (c), not the checks before
    return {"mla_decode_attention": res["b512"]["mla_launches"]
            + res["action"]["mla_launches"]}


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


# Snake's levels at the main path's shapes: the DAC decoder's five in a
# 32-clip slice (the first block's input, then each block's output width),
# and the encoder's five at the training batch of 48 clips
SNAKE_DECODE_LEVELS = ((32, 1536, 221), (32, 768, 1768), (32, 384, 14144),
                       (32, 192, 56576), (32, 96, 113152))
SNAKE_ENCODE_LEVELS = ((48, 64, 113152), (48, 128, 56576), (48, 256, 14144),
                       (48, 512, 1768), (48, 1024, 221))
# the kernel's output against the plain version's, in ulps (the same
# arithmetic in float32; bf16 rounds a*x and the quotient where both do)
TOL_SNAKE_ULPS = {"float32": 2, "bfloat16": 1}
# the kernel's share of its byte bound at the decoder's widest level
SNAKE_MIN_BOUND_SHARE = 0.75
# the decode block's kernels (csrc/decode_block.cu): the rows of a decode
# step at the benchmark's batch (512 clips and their CFG null stream); the
# norm's output against the plain path, in ulps (its float32 sum of squares
# in another order: a warp tree, not PyTorch's reduction; RoPE, the int8
# rows and SwiGLU must be bit for bit)
DECODE_BLOCK_ROWS = 1024
TOL_NORM_ULPS = {"bfloat16": 1, "float32": 8}


def _max_ulps(a, b) -> int:
    """The largest distance in ulps between two float32 or bf16 tensors
    (their bit patterns as integers ordered like the values)."""
    import torch

    itype = torch.int32 if a.dtype == torch.float32 else torch.int16
    top = (1 << 31) - 1 if a.dtype == torch.float32 else (1 << 15) - 1

    def ordered(t):
        bits = t.contiguous().view(itype).long()
        return torch.where(bits < 0, -(bits & top), bits)
    return int((ordered(a) - ordered(b)).abs().max())


def _snake_level(shape, dtype, gen) -> dict:
    """The kernel against the plain version (on the card: the eager
    formula) at one shape: ulps, device ms of each and the byte bound."""
    import torch

    from vaura_tpu_torch.ops import snake as S

    x = (torch.randn(shape, device="cuda", generator=gen) * 3.0).to(dtype)
    alpha = torch.empty(shape[1], device="cuda").uniform_(
        0.5, 2.0, generator=gen).to(dtype)
    got, want = S.snake_cuda(x, alpha), S.snake_plain(x, alpha)
    bound_ms = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
    reps = max(3, min(50, int(20.0 / bound_ms)))
    entry = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
             "vector_path": S.vector_path(x, got),
             "ulps": _max_ulps(got, want),
             "bit_equal": bool(torch.equal(got, want)),
             "ms": cuda_ms(lambda: S.snake_cuda(x, alpha), reps),
             "plain_ms": cuda_ms(lambda: S.snake_plain(x, alpha), reps),
             "bound_ms": bound_ms}
    entry["bound_share"] = entry["bound_ms"] / entry["ms"]
    del x, alpha, got, want
    torch.cuda.empty_cache()
    return entry


def phase_snake(gen, report):
    """Snake's kernel (``csrc/snake.cu``) against its plain version at the
    DAC's levels in float32 and bf16; its launches in one 512-clip
    generation (16 slices x 29) and one training step (29, the codec's
    encode); that generation's waveform against the eager path's
    decode of the same codes (``snake: {...}``)."""
    import torch

    from vaura_tpu_torch.flagship import (
        GENERATE_KW,
        flagship_system,
        flagship_train_state,
        random_train_batch,
    )
    from vaura_tpu_torch.models.dac import layers as DL
    from vaura_tpu_torch.ops import snake as S
    from vaura_tpu_torch.train.steps import make_train_step

    problems, res = [], {"levels": []}
    report["snake"] = res
    for where, levels in (("decode", SNAKE_DECODE_LEVELS),
                          ("encode", SNAKE_ENCODE_LEVELS)):
        for shape in levels:
            for dtype in (torch.float32, torch.bfloat16):
                e = _snake_level(shape, dtype, gen)
                e["where"] = where
                res["levels"].append(e)
                log(f"[snake] {where} {tuple(shape)} {e['dtype']}: "
                    f"{e['ulps']} ulps (bit equal {e['bit_equal']}), "
                    f"{e['ms']:.4f} ms, bound {e['bound_ms']:.4f} "
                    f"({100 * e['bound_share']:.1f}%), plain "
                    f"{e['plain_ms']:.4f}")
                if e["ulps"] > TOL_SNAKE_ULPS[e["dtype"]]:
                    problems.append(f"{where} {shape} {e['dtype']}: "
                                    f"{e['ulps']} ulps")
    widest = [e for e in res["levels"] if e["shape"] == [32, 96, 113152]
              and e["dtype"] == "float32"][0]
    if widest["bound_share"] < SNAKE_MIN_BOUND_SHARE:
        problems.append(f"[32, 96, 113152] float32 at "
                        f"{100 * widest['bound_share']:.1f}% of its bound")

    # one 512-clip generation from features, the DAC in 32-clip slices
    system = flagship_system("cuda", gen)
    feats = torch.randn(512, 32, 768, device="cuda", generator=gen)
    torch.cuda.synchronize()
    before = S.launches
    t0 = time.time()
    out = system.generate(vis_feats=feats, seed=3, dac_chunk_size=32,
                          **GENERATE_KW)
    torch.cuda.synchronize()
    res["generate"] = {"wall_s": time.time() - t0,
                       "stage_ms": out["stage_ms"],
                       "launches": S.launches - before}
    _check_generation("snake", out, (512, 9, 221), problems)
    if res["generate"]["launches"] != 16 * 29:
        problems.append(f"512-clip generation: {res['generate']['launches']}"
                        " Snake launches, expected 464")
    # the same codes through the eager formula
    kernel_forward = DL.Snake1d.forward
    DL.Snake1d.forward = lambda self, x: S.snake_plain(
        x, self.alpha.to(x.dtype))
    try:
        before = S.launches
        eager = system.decode_audio(out["codes"], chunk_size=32)
        torch.cuda.synchronize()
        eager_launches = S.launches - before
    finally:
        DL.Snake1d.forward = kernel_forward
    audio = out["audio"]
    diff = (audio.float() - eager.float())
    res["waveform"] = {
        "max_abs": float(diff.abs().max()),
        "rel_l2": float(diff.norm() / eager.float().norm()),
        "bit_equal": bool(torch.equal(audio, eager)),
        "eager_launches": eager_launches}
    log(f"[snake] 512 clips: {res['generate']}; waveform against the eager "
        f"path: {res['waveform']}")
    if eager_launches != 0 or not res["waveform"]["max_abs"] <= 1e-5:
        problems.append(f"waveform against the eager path: {res['waveform']}")
    del system, feats, out, eager, audio, diff
    torch.cuda.empty_cache()

    # one training step (the count is the same at any batch; the flagship
    # training configuration trains the encoder and does not fit 48 clips)
    system = flagship_system("cuda", gen, training=True)
    state = flagship_train_state(system)
    batch = random_train_batch(4, gen, "cuda")
    step = make_train_step(system)
    torch.cuda.synchronize()
    before = S.launches
    state, metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    res["train_step"] = {"loss": float(metrics["loss"]),
                         "launches": S.launches - before}
    log(f"[snake] training step at 4 clips: {res['train_step']}")
    if res["train_step"]["launches"] != 29:
        problems.append(f"training step: {res['train_step']['launches']} "
                        "Snake launches, expected 29")
    del system, state, batch
    torch.cuda.empty_cache()
    print(json.dumps({"snake": res}))
    if problems:
        raise AssertionError("; ".join(problems))


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
        if _differs(launches, want):
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
# the dummy datamodule): A trains one epoch of 3 steps with a frozen
# encoder, as the main experiment does, with the epoch's predict media and
# a validation after each of the first two steps (every scalar tag of the
# Trainer); B resumes A's `last` for a second epoch with async saves;
# C tests A's best checkpoint; D trains 2 steps with the encoder unfrozen
TRAIN_CONFIG = "configs/experiments/flagship_smoke.yaml"
TRAIN_A = ["trainer.fast_dev_run=false", "trainer.max_epochs=1",
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
    if _differs(launches, want):
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
        # A: 3 steps, 2 mid-epoch + 1 end validations of 2 batches, 2
        # test batches, 1 predict generation and its attention forward
        _train_run("A", TRAIN_A, os.path.join(tmp, "A"),
                   want(3 + 6 + 2 + 1 + 1, decode_gens=1), res, total,
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
        if [s for s, _ in steps] != list(range(1, 4)):
            problems.append(f"A: train_loss_step at steps {[s for s, _ in steps]}")
        if not all(math.isfinite(x) for x in losses):
            problems.append("A: losses not finite")
        if not steps or abs(steps[0][1] - math.log(1024)) > 1e-2:
            problems.append(f"A: first loss {steps[:1]} is not ln 1024")
        if _epoch_checkpoints(a_root) != ["epoch=0-step=3"]:
            problems.append(f"A: checkpoints {_epoch_checkpoints(a_root)}")
        ck = os.path.join(a_root, "checkpoints")
        if not (os.path.islink(os.path.join(ck, "last"))
                and os.path.isdir(os.path.join(ck, "frozen"))):
            problems.append("A: `last` or the frozen save is missing")
        with open(os.path.join(ck, "last", "meta.json")) as f:
            a_meta = json.load(f)
        shutil.copy(_glob_one(a_root, "events.out.tfevents.*"),
                    os.path.join(OUT_DIR, "train_action_A.tfevents"))

        # B: resume A's last for epoch 1 only (3 steps, 3 validations, the
        # test; no predict generation: A checks those)
        _train_run("B", TRAIN_A + ["trainer.max_epochs=2",
                                   "trainer.async_checkpointing=true",
                                   "model.predict_at_val_start=false",
                                   f"trainer.ckpt_path={ck}/last"],
                   os.path.join(tmp, "B"), want(3 + 6 + 2), res, total,
                   problems)
        b_root = res["B"]["root"]
        ev = read_events(_glob_one(b_root, "events.out.tfevents.*"))
        b_steps = [e["step"] for e in ev if e["tag"] == "train_loss_step"]
        if b_steps != [4, 5, 6]:
            problems.append(f"B: train_loss_step at steps {b_steps}")
        if _epoch_checkpoints(b_root) != ["epoch=1-step=6"]:
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
    ``chiprun_out/finetune/`` for the eval phase; F's run directory is
    deleted, L's experiment (and its base) kept for the ``mesh`` phase's
    generate action on a mesh, which deletes it (``report["finetune"]
    ["tmp"]``)."""
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
        if _differs(launches, want):
            problems.append(f"{tag}: launches {launches}, expected {want}")
        return out

    tvaura.VauraSystem.generate = generate_spy
    tloop.Trainer.fit = fit_spy
    kept = False
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
        kept = True
    finally:
        tvaura.VauraSystem.generate = generate
        tloop.Trainer.fit = fit
        seen.clear()
        if not kept:
            shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    res["train_action_D_peak_mem_gib"] = (
        report.get("train_action", {}).get("D", {}).get("peak_mem_gib"))
    res["launches"] = total
    res["wav_dirs"] = {"lora": lora_wavs, "base": base_wavs}
    res["tmp"], res["lora_experiment"] = tmp, l_root
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


def _get(url, timeout=60):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def _metrics(base):
    text = _get(base + "/metrics").decode()
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


def _stream_request(service, base, rng, problems, tag):
    """One ``/generate_long`` stream of seeded features: time to the first
    increment, wall, samples (the geometry's tokens times the hop)."""
    import io
    import urllib.request

    import numpy as np

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
    res = {"tokens": service.stream_tokens,
           "time_to_first_increment_s": first, "wall_s": time.time() - t0,
           "samples": len(pcm) // 2}
    log(f"[{tag}] stream of {service.stream_tokens} tokens: first increment "
        f"after {first:.3f} s, {len(pcm) // 2} samples in "
        f"{res['wall_s']:.3f} s")
    if header[:4] != b"RIFF" or len(pcm) // 2 != service.stream_tokens * hop:
        problems.append(f"{tag} stream: header {header[:4]!r}, "
                        f"{len(pcm) // 2} samples")
    return res


def _reload_checkpoint(service, ckdir):
    """A ``CheckpointManager`` checkpoint of a ``TrainState`` as training
    saves it: differently seeded sampler weights (seed 1) and the served
    system's other trainable leaves."""
    import torch

    from vaura_tpu_torch.models.sampler import Sampler
    from vaura_tpu_torch.train.checkpoint import CheckpointManager
    from vaura_tpu_torch.train.state import TrainState, make_optimizer
    from vaura_tpu_torch.utils import seeded_init_

    old = service.system
    sampler = Sampler(old.sampler_config, service.device)
    seeded_init_(sampler, torch.Generator(service.device).manual_seed(1))
    params = {f"sampler.{k}": v for k, v in sampler.named_parameters()}
    params.update({k: v for k, v in old.named_parameters()
                   if k in service._trainable_like
                   and not k.startswith("sampler.")})
    state = TrainState.create(params, make_optimizer(1e-4))
    return CheckpointManager(ckdir).save(state, epoch=0, step=1, val_loss=1.0)


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
    ``close()``. Service B (``quantize=cache``): a burst of 8. The ``mesh``
    phase runs A's config under ``torchrun`` with the same requests. The
    counters are zeroed after each
    service's warm-up and read after its last request; the direct
    generations that check the server are not counted."""
    import base64
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vaura_tpu_torch.data import media

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
        # 2. a burst of 16 (two batches at least: requests queue across
        # batches)
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
        res["stream"] = _stream_request(service, base, rng, problems,
                                        "serve")
        # 5. hot reload in the HTTP thread (one process) from a checkpoint
        # of differently seeded sampler weights, a TrainState as training
        # saves it: a lone request's codes differ from the old weights'
        ckdir = tempfile.mkdtemp()
        try:
            old = service.system
            t0 = time.time()
            path = _reload_checkpoint(service, ckdir)
            res["checkpoint_save_s"] = time.time() - t0
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
    if service.device.type == "cuda" and _differs(launches, want):
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
    if service.device.type == "cuda" and _differs(launches, want):
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


# encoder_variants: the encoder layouts and heads of the JAX package at full
# ViT-B/16 width and depth (seeded bf16 weights made on the card, frames
# [2, 4, 3, 16, 224, 224], B' = 8): the exact trajectory encoder into the
# flagship generation, the approximated trajectory encoders and the joint
# one, the int8 encoder against the bf16 one, the aggregation heads, a
# training step at each remat policy, and each variant at cut depth card
# against CPU. The int8 bound is tests/test_encoder_quant.py's, the int8
# encoder against the float one at random weights:
TOL_INT8_REL = 0.05
TOL_INT8_COS = 0.995
VARIANT_APPROX_DIM = 128  # landmarks / random features (the JAX default)


def _encoder(gen, depth=None, device="cuda", **kw):
    """A seeded bf16 encoder of the flagship widths (no graph recorded)."""
    import dataclasses

    import torch

    from vaura_tpu_torch.models.motionformer import MotionFormer, MotionFormerConfig
    from vaura_tpu_torch.utils import seeded_init_

    cfg = dataclasses.replace(MotionFormerConfig(), param_dtype=torch.bfloat16,
                              **kw)
    if depth:
        cfg = dataclasses.replace(cfg, depth=depth)
    enc = MotionFormer(cfg, device)
    if gen is not None:
        seeded_init_(enc, gen)
    return enc.requires_grad_(False)


def _timed_forward(enc, frames, **kw):
    """One forward after a warm-up: ``(output, ms between CUDA events around
    it, peak GiB of the run)``."""
    import torch

    with torch.no_grad():
        enc(frames, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = enc(frames, **kw)
        b.record()
        b.synchronize()
    return out, a.elapsed_time(b), torch.cuda.max_memory_allocated() / 2 ** 30


def _variants_generate(gen, frames, res, problems):
    """(a) The exact trajectory encoder, then the flagship generation."""
    import torch

    from vaura_tpu_torch.flagship import GENERATE_KW, flagship_system

    system = flagship_system("cuda", gen,
                             encoder_overrides={"attn_layer": "trajectory"})
    n_steps = system.prepare_generation(GENERATE_KW["max_new_tokens"])[2] - 1
    expected = {"decode_attention": system.sampler_config.num_layers * n_steps,
                "decode_attention_int8": 0, "encoder_attention": 0,
                "encoder_mlp": 0, "grouped_cls_attention": 0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters()
    t0 = time.time()
    out = system.generate(frames, seed=0, **GENERATE_KW)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _counters()
    res["trajectory_generate"] = {
        "wall_s": wall, "stage_ms": out["stage_ms"], "launches": launches,
        "expected_launches": expected,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"[encoder_variants] trajectory -> generate: wall {wall:.2f} s, "
        "stages (ms): " + ", ".join(f"{k} {v:.1f}"
                                    for k, v in out["stage_ms"].items())
        + f"; launches {launches}")
    _check_generation("encoder_variants", out, (2, 9, 221), problems)
    if _differs(launches, expected):
        problems.append(f"trajectory generate: launches {launches}, "
                        f"expected {expected}")
    feats, ms, peak = _timed_forward(system.encoder, frames)
    res["forwards"]["trajectory"] = {"ms": ms, "peak_gib": peak,
                                     "shape": list(feats.shape)}
    del system
    torch.cuda.empty_cache()
    return launches


def _variants_forwards(gen, frames, res, problems):
    """(b) the approximated trajectory encoders and the joint one, (d) the
    aggregation heads: finite outputs of the expected shapes."""
    import torch

    runs = {
        "nystrom": dict(attn_layer="trajectory", approx_attn_type="nystrom"),
        "orthoformer": dict(attn_layer="trajectory",
                            approx_attn_type="orthoformer"),
        "performer": dict(attn_layer="trajectory",
                          approx_attn_type="performer"),
        "joint": dict(attn_layer="joint", pos_embed_type="joint"),
        "temporal_global": dict(agg_time_module="TransformerEncoderLayer",
                                add_global_repr=True),
        "average_global": dict(agg_space_module="AveragePooling",
                               agg_time_module="AveragePooling",
                               add_global_repr=True,
                               agg_segments_module="AveragePooling"),
        "unfactorised": dict(factorize_space_time=False),
    }
    B, S = frames.shape[:2]
    shapes = {"temporal_global": ((B, S, 768), (B, 768)),
              "average_global": ((B, S, 768), (B, 768)),
              "unfactorised": ((B, S, 8 * 196, 768), None)}
    for name, kw in runs.items():
        if "approx_attn_type" in kw:
            kw = dict(kw, approx_attn_dim=VARIANT_APPROX_DIM)
        enc = _encoder(gen, **kw)
        (feats, glob), ms, peak = _timed_forward(enc, frames,
                                                 return_global=True)
        want_f, want_g = shapes.get(name, ((B, S, 8, 768), None))
        entry = {"ms": ms, "peak_gib": peak, "shape": list(feats.shape)}
        if glob is not None:
            entry["global_shape"] = list(glob.shape)
        res["forwards"][name] = entry
        log(f"[encoder_variants] {name}: {ms:.1f} ms, peak {peak:.2f} GiB, "
            f"features {tuple(feats.shape)}"
            + ("" if glob is None else f", global {tuple(glob.shape)}"))
        if tuple(feats.shape) != want_f or not bool(
                torch.isfinite(feats).all()):
            problems.append(f"{name}: features {tuple(feats.shape)} "
                            f"(expected {want_f}) or not finite")
        if (None if glob is None else tuple(glob.shape)) != want_g or (
                glob is not None and not bool(torch.isfinite(glob).all())):
            problems.append(f"{name}: global {glob if glob is None else tuple(glob.shape)}"
                            f" (expected {want_g}) or not finite")
        del enc, feats, glob
        torch.cuda.empty_cache()


def _variants_int8(gen, frames, res, problems):
    """(c) The int8 encoder against the bf16 one on the same weights; one
    block's int8 products against float64; the grouped-attention launches
    of the int8 encoder's unfused blocks."""
    import dataclasses

    import torch

    from vaura_tpu_torch.models.motionformer import MotionFormer
    from vaura_tpu_torch.ops.quantization import (
        int8_matmul,
        quantize_encoder_params,
        quantize_rows,
    )

    enc = _encoder(gen)
    q_enc = MotionFormer(dataclasses.replace(enc.cfg, quantize=True), "cuda")
    q_enc.load_state_dict(quantize_encoder_params(enc.state_dict()))
    q_enc.requires_grad_(False)
    ref, ms_bf16, peak_bf16 = _timed_forward(enc, frames)
    torch.cuda.synchronize()
    _zero_counters()
    with torch.no_grad():
        q_enc(frames)
    torch.cuda.synchronize()
    launches = _counters()
    out, ms_int8, peak_int8 = _timed_forward(q_enc, frames)
    a, b = out.float().reshape(-1), ref.float().reshape(-1)
    rel = float((a - b).norm() / b.norm())
    cos = float(a @ b / (a.norm() * b.norm()))

    # block 0's MLP products (K = 768 and 3072) over one block's rows
    # (B' x 1569) and over 5 rows (padded to torch._int_mm's 17), against
    # the float64 product of the same int8 values (exact: |sum| < 2^53)
    blk = q_enc.blocks[0].mlp
    exact = {}
    for name, layer in (("fc1", blk.fc1), ("fc2", blk.fc2)):
        K = layer.kernel_q.shape[1]
        for rows in (frames.shape[0] * frames.shape[1] * 1569, 5):
            x = torch.randn(rows, K, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            xq, _ = quantize_rows(x)
            got = int8_matmul(xq, layer.kernel_q)
            want = xq.double() @ layer.kernel_q.double().t()
            exact[f"{name}_{rows}x{K}"] = bool(torch.equal(got.double(), want))
    expected = {"decode_attention": 0, "decode_attention_int8": 0,
                "encoder_attention": 0, "encoder_mlp": 0,
                "grouped_cls_attention": 2 * enc.cfg.depth}
    res["int8"] = {"rel": rel, "cos": cos, "ms": ms_int8, "ms_bf16": ms_bf16,
                   "peak_gib": peak_int8, "peak_gib_bf16": peak_bf16,
                   "int_mm_exact": exact, "launches": launches,
                   "expected_launches": expected}
    res["forwards"]["int8"] = {"ms": ms_int8, "peak_gib": peak_int8}
    res["forwards"]["divided_bf16"] = {"ms": ms_bf16, "peak_gib": peak_bf16}
    log(f"[encoder_variants] int8 encoder vs bf16: rel {rel:.4f} (tol "
        f"{TOL_INT8_REL}), cos {cos:.5f} (tol {TOL_INT8_COS}); {ms_int8:.1f} "
        f"ms against {ms_bf16:.1f} ms; _int_mm exact {exact}; launches "
        f"{launches}")
    if not (rel < TOL_INT8_REL and cos > TOL_INT8_COS):
        problems.append(f"int8 encoder: rel {rel}, cos {cos}")
    if not all(exact.values()):
        problems.append(f"int8 products not exact: {exact}")
    if _differs(launches, expected):
        problems.append(f"int8 encoder: launches {launches}, expected "
                        f"{expected}")
    del enc, q_enc
    torch.cuda.empty_cache()
    return launches


def _variants_remat(res, problems):
    """(e) Two flagship training steps at each remat policy from the same
    seeds (None twice): both losses equal bit for bit; the second step's
    forward / backward / optimizer ms, the memory a forward holds for the
    backward pass, and the run's peak. The updated parameters are compared
    with the first run's and the leaves that differ counted, not held:
    the backward's atomic sums (an embedding's, an index_select's) are not
    deterministic on the card, and the repeat of None shows that noise."""
    import torch

    from vaura_tpu_torch.flagship import (
        flagship_system,
        flagship_train_state,
        random_train_batch,
    )
    from vaura_tpu_torch.train.steps import make_train_step
    from vaura_tpu_torch.utils import StageClock

    runs, first = {}, None
    g = lambda s: torch.Generator(device="cuda").manual_seed(s)
    for tag, policy in (("None", None), ("None_again", None), ("dots", "dots"),
                        ("dots_no_batch", "dots_no_batch")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        system = flagship_system(
            "cuda", g(11), training=True,
            sampler_overrides={"remat": True, "remat_policy": policy})
        state = flagship_train_state(system)
        batch = random_train_batch(2, g(12), "cuda")
        step = make_train_step(system)
        state, m0 = step(state, batch, g(13))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        loss, aux = system.train_forward(batch["frames"], batch["audio"],
                                         g(14), train=True)
        held = (torch.cuda.memory_allocated() - base) / 2 ** 30
        del loss, aux
        clock = StageClock(system.device)
        clock.mark("start")
        state, m1 = step(state, batch, g(15), clock=clock)
        ms = clock.ms()
        params = {k: p.detach().clone() for k, p in state.params.items()}
        losses = [float(m0["loss"]), float(m1["loss"])]
        run = {"losses": losses, **ms, "held_gib": held,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        if first is None:
            first = (losses, {k: v.cpu() for k, v in params.items()})
        else:
            run["leaves_differing"] = sum(
                not torch.equal(v.cpu(), first[1][k]) for k, v in params.items())
            run["largest_difference"] = max(
                float((v.cpu() - first[1][k]).abs().max()) for k, v in params.items())
            if losses != first[0]:
                problems.append(f"remat_policy={policy}: losses {losses} != "
                                f"{first[0]}")
        runs[tag] = run
        log(f"[encoder_variants] remat_policy={policy} ({tag}): losses {losses}, "
            f"second step forward {ms['forward']:.1f} / backward "
            f"{ms['backward']:.1f} / optimizer {ms['optimizer']:.1f} ms; a "
            f"forward holds {held:.2f} GiB; peak {run['peak_gib']:.2f} GiB; "
            f"updated leaves unlike the first run's "
            f"{run.get('leaves_differing', 0)} of {len(params)} (largest "
            f"difference {run.get('largest_difference', 0.0):.3e})")
        del system, state, batch, params
    res["remat"] = runs


def _variants_reference(gen, res, problems):
    """(f) Each variant at 1 block on two segments, the card against the CPU
    on the same weights, relative to the output's largest magnitude. The
    orthoformer's greedy landmark choice turns on near-ties of |cosine|
    that other roundings decide otherwise, so its CPU run replays the
    card's choice (the share of equal choices is reported)."""
    import torch

    from vaura_tpu_torch.ops import trajectory_attention as TA
    from vaura_tpu_torch.ops.quantization import quantize_encoder_params

    runs = {
        "trajectory": dict(attn_layer="trajectory"),
        "nystrom": dict(attn_layer="trajectory", approx_attn_type="nystrom"),
        "orthoformer": dict(attn_layer="trajectory",
                            approx_attn_type="orthoformer"),
        "performer": dict(attn_layer="trajectory",
                          approx_attn_type="performer"),
        "joint": dict(attn_layer="joint", pos_embed_type="joint"),
        "int8": dict(quantize=True),
        "temporal_global": dict(agg_time_module="TransformerEncoderLayer",
                                add_global_repr=True),
    }
    frames = torch.randn(1, 2, 3, 16, 224, 224, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
    rel = lambda a, b: max_err(a.cpu(), b) / float(b.float().abs().max())
    out = {}
    pick = TA._landmark_indices
    for name, kw in runs.items():
        if "approx_attn_type" in kw:
            kw = dict(kw, approx_attn_dim=VARIANT_APPROX_DIM)
        if kw.get("quantize"):
            src = _encoder(gen, depth=1)
            card = _encoder(None, depth=1, **kw)
            card.load_state_dict(quantize_encoder_params(src.state_dict()))
        else:
            card = _encoder(gen, depth=1, **kw)
        cpu = _encoder(None, depth=1, device="cpu", **kw)
        cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
        chosen, own = [], []
        if name == "orthoformer":
            TA._landmark_indices = lambda *a: chosen.append(pick(*a)) or chosen[-1]
        try:
            with torch.no_grad():
                fa, ga = card(frames, return_global=True)
                if chosen:
                    card_choice = chosen[0].cpu()
                    TA._landmark_indices = (
                        lambda *a: own.append(pick(*a)) or card_choice)
                fb, gb = cpu(frames.cpu(), return_global=True)
        finally:
            TA._landmark_indices = pick
        out[name] = rel(fa, fb)
        if ga is not None:
            out[name + "_global"] = rel(ga, gb)
        if own:
            res["orthoformer_same_choice"] = float(
                (own[0] == card_choice).float().mean())
        del card, cpu
    res["reference"] = out
    log("[encoder_variants] card vs CPU at 1 block, rel err (tol "
        f"{TOL_REF_REL}): " + ", ".join(f"{k} {v:.2e}" for k, v in out.items())
        + "; the CPU's own orthoformer landmarks equal to the card's: "
        f"{res.get('orthoformer_same_choice')}")
    bad = {k: v for k, v in out.items() if not v <= TOL_REF_REL}
    if bad:
        problems.append(f"card and CPU disagree: {bad}")


def phase_encoder_variants(gen, report):
    import torch

    from vaura_tpu_torch.flagship import random_frames

    frames = random_frames(2, gen, "cuda")
    res, problems = {"forwards": {}}, []
    launches = dict.fromkeys(_counters(), 0)
    for part in (_variants_generate, _variants_int8):
        for k, n in part(gen, frames, res, problems).items():
            launches[k] += n
    _variants_forwards(gen, frames, res, problems)
    _variants_remat(res, problems)
    _variants_reference(gen, res, problems)
    report["encoder_variants"] = res
    print("encoder_variants: " + json.dumps(
        {"forwards": res["forwards"], "remat": res.get("remat"),
         "int8": {k: res["int8"][k] for k in ("rel", "cos")},
         "reference": res.get("reference"),
         "orthoformer_same_choice": res.get("orthoformer_same_choice")}),
        flush=True)
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


# the last sampler modes: (tag, sampler changes, the decode kernel they take)
QUANT_MODES = (
    ("int4", {"cache_bits": 4}, "decode_attention_int4"),
    ("int8_dots", {"int8_dots": True}, "decode_attention_int8_dots"),
    ("int4_dots", {"cache_bits": 4, "int8_dots": True},
     "decode_attention_int8_dots"),
)


def _quant_run(tag, fn, want, total, res, problems, want_forms=None):
    """One generation with every counter zeroed before and read after:
    launches held to ``want`` (kernels it names; others 0) and added to
    ``total``, the decode launches by form to ``want_forms`` where given;
    wall and stages into ``res[tag]``. Returns ``fn``'s result."""
    import torch

    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, forms = _counters(), _form_counts()
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    stage_ms = out.get("stage_ms", {}) if isinstance(out, dict) else {}
    res[tag] = {"wall_s": wall, "stage_ms": stage_ms, "launches": launches,
                "expected_launches": want, "form_launches": forms}
    log(f"[quant_modes] {tag}: wall {wall:.2f} s, stages (ms) "
        + ", ".join(f"{k} {v:.1f}" for k, v in stage_ms.items())
        + f", launches {launches}, by form {forms}")
    if _differs(launches, want):
        problems.append(f"{tag}: launches {launches}, expected {want}")
    if want_forms is not None and forms != want_forms:
        problems.append(f"{tag}: launches by form {forms}, expected "
                        f"{want_forms}")
    return out


def _quant_reference(gen, mode, changes, res, problems):
    """The mode at flagship widths and cut depth, card against CPU:
    ``prefill`` over 80 positions, then decode steps at 70..79 over the
    cache it made (under ``int8_dots`` in three groups); on the card each
    step in both forms of the mode's kernel, whose logits must agree within
    ``TOL_DECODE`` of their largest magnitude."""
    import torch

    from vaura_tpu_torch.flagship import flagship_system
    from vaura_tpu_torch.ops import decode_attention as da

    kw = dict(sampler_layers=2, encoder_depth=1,
              sampler_overrides={"quantize_cache": True, **changes})
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
    _, ca = card.sampler.prefill(toks, cond)
    _, cb = cpu.sampler.prefill(toks.cpu(), cond.cpu())
    if cfg.int8_dots:
        ca["chunk_starts"] = torch.tensor([0, 31, 63], dtype=torch.int32,
                                          device="cuda")
        cb["chunk_starts"] = ca["chunk_starts"].cpu()
    worst = forms = 0.0
    for pos in range(P, T):
        # both forms of the mode's kernel on the one cache (each step writes
        # the same k/v into it), then the CPU
        step = lambda: card.sampler.decode_step(
            toks[:, :, pos:pos + 1], cond[:, pos:pos + 1], ca, pos)
        with da.forced_form("serve"):
            a_serve = step()
        with da.forced_form("cluster"):
            a = step()
        b = cpu.sampler.decode_step(toks[:, :, pos:pos + 1].cpu(),
                                    cond[:, pos:pos + 1].cpu(), cb, pos)
        worst = max(worst, rel(a, b))
        forms = max(forms, max_err(a_serve, a) / float(a.float().abs().max()))
    res[f"reference_{mode}_logits"] = worst
    res[f"forms_{mode}_logits"] = forms
    log(f"[quant_modes] {mode}: decode logits card vs CPU rel err "
        f"{worst:.3e} (tol {TOL_REF_REL}); serving form vs cluster form on "
        f"one cache {forms:.3e} (tol {TOL_DECODE})")
    if not worst <= TOL_REF_REL:
        problems.append(f"{mode}: card and CPU logits {worst:.3e} apart")
    if not forms <= TOL_DECODE:
        problems.append(f"{mode}: the two forms' logits {forms:.3e} apart")


def phase_quant_modes(gen, report):
    """The last sampler modes at full width and depth, batch 2
    (``flagship.py``): generation with the int4 cache, with the int8 x int8
    products, with both (5,496 launches of the mode's kernel each, no other
    decode kernel); a 150-token prompt through ``prefill`` and
    ``generate_long_kv`` (5.12 s, window 4 x 56, one sink chunk) under
    int4 + int8 products; the generate action from a config written to a
    temporary directory (``generate_vgg.yaml`` with the flagship model and
    ``cache_bits: 4``) with ``quantize=true``; and each mode's decode
    logits, card against CPU at cut depth."""
    import shutil
    import tempfile

    import torch

    from vaura_tpu_torch.config.loader import load_config
    from vaura_tpu_torch.config.yaml_subset import dump, load_file
    from vaura_tpu_torch.flagship import (
        GENERATE_KW,
        LONG_KV_KW,
        LONG_SAMPLER,
        flagship_system,
        random_frames,
    )
    from vaura_tpu_torch.main import main
    from vaura_tpu_torch.ops.patterns import DelayedPatternProvider
    from vaura_tpu_torch.scripts.generate import _replace_sampler

    system = flagship_system("cuda", gen)
    frames = random_frames(2, gen, "cuda")
    L = system.sampler_config.num_layers
    depth = system.encoder.cfg.depth
    n_steps = system.prepare_generation(GENERATE_KW["max_new_tokens"])[2] - 1
    res, problems, total = {}, [], {}
    for mode, changes, kernel in QUANT_MODES:
        _replace_sampler(system, **{"quantize_cache": True, "cache_bits": 8,
                                    "int8_dots": False, **changes})
        want = {kernel: L * n_steps, "encoder_attention": 2 * depth,
                "encoder_mlp": depth}
        out = _quant_run(mode, lambda: system.generate(frames, seed=0,
                                                       **GENERATE_KW),
                         want, total, res, problems,
                         want_forms={"cluster": L * n_steps, "serve": 0})
        _check_generation(f"quant_modes {mode}", out, (2, 9, 221), problems)
        loop_s = out["stage_ms"]["decode_loop"] / 1e3
        res[mode].update(decode_loop_ms=out["stage_ms"]["decode_loop"],
                         decode_kernel_launches_per_step=L,
                         audio_s_per_s=2 * 221 / 86 / res[mode]["wall_s"],
                         decode_loop_audio_s_per_s=2 * 221 / 86 / loop_s)

    # a prompt through prefill, then the rolling cache with a sink chunk,
    # both under int4 + int8 products (features made once, not counted)
    feats = system.visual_features(frames)

    # a serving batch of 8 clips (B2 = 16, 256 (batch row, KV head) pairs):
    # the plan takes the serving form of the int8 x int8 kernel at every step
    from vaura_tpu_torch.ops import decode_attention as da

    feats8 = feats.repeat(4, *([1] * (feats.dim() - 1)))
    _replace_sampler(system, quantize_cache=True, cache_bits=8, int8_dots=True)
    scfg = system.sampler_config
    plan = da.kernel_plan(16, scfg.nhead, scfg.n_kv_heads,
                          system.prepare_generation(221)[2], scfg.head_dim, 0,
                          True, kind="dots", groups=8)
    if plan["form"] != "serve":
        problems.append(f"batch 8: the plan takes the {plan['form']} form")
    out = _quant_run("int8_dots_batch8_serving_form", lambda: system.generate(
        vis_feats=feats8, seed=0, **GENERATE_KW),
        {"decode_attention_int8_dots": L * n_steps}, total, res, problems,
        want_forms={"cluster": 0, "serve": L * n_steps})
    _check_generation("quant_modes int8_dots_batch8_serving_form", out,
                      (8, 9, 221), problems)
    del feats8
    prompt = torch.randint(0, 1024, (2, 9, 150), generator=gen, device="cuda")
    first = DelayedPatternProvider(9).get_pattern(221) \
        .get_first_step_with_timesteps(150)
    _replace_sampler(system, **LONG_SAMPLER)
    out = _quant_run("int4_dots_prompt", lambda: system.generate(
        vis_feats=feats, audio_prompt_codes=prompt, seed=0, **GENERATE_KW),
        {"decode_attention_int8_dots": L * (n_steps + 1 - first)}, total, res,
        problems)
    _check_generation("quant_modes int4_dots_prompt", out, (2, 9, 221),
                      problems)
    if not torch.equal(out["codes"][..., :150], prompt):
        problems.append("int4_dots_prompt: the prompt's codes changed")
    long_tokens = int(5.12 * 86)
    segs = torch.randn(2, 8, 8, 768, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    S_long = system.prepare_generation(long_tokens)[2]
    kw = {k: GENERATE_KW[k] for k in ("cfg_scale", "top_k", "tokens_per_frame")}
    out = _quant_run("int4_dots_long_kv_sink", lambda: system.generate_long_kv(
        vis_feats_segments=segs, total_tokens=long_tokens, seed=0,
        **dict(LONG_KV_KW, sink_chunks=1), **kw),
        {"decode_attention_int8_dots": L * (S_long - 1)}, total, res,
        problems)
    _check_generation("quant_modes int4_dots_long_kv_sink", out,
                      (2, 9, long_tokens), problems)
    del system, feats, segs
    torch.cuda.empty_cache()

    # the generate action from a config that sets cache_bits: 4
    tmp = tempfile.mkdtemp(prefix="quant_modes_")
    try:
        cfg = load_file(os.path.join(ROOT, "configs", "generate_vgg.yaml"))
        model = load_config(os.path.join(ROOT, "configs",
                                         "vaura_defaults.yaml"), ROOT)["model"]
        model["sampler_config"].setdefault("params", {})["cache_bits"] = 4
        cfg["model"] = model
        path = os.path.join(tmp, "generate_int4.yaml")
        with open(path, "w") as f:
            f.write(dump(cfg))
        tokens = int(2.56 * 86)
        steps = DelayedPatternProvider(9).get_pattern(tokens) \
            ._build_seq_tables(tokens)[1].shape[1] - 1
        out_dir = os.path.join(OUT_DIR, "quant_modes", "action")
        shutil.rmtree(out_dir, ignore_errors=True)
        argv = [f"config={path}", "quantize=true",
                "dataloader.dataset_type=dummy", "dataloader.num_workers=0",
                "dataloader.batch_size=2", "max_batches=1",
                f"output_dir={out_dir}"]
        result = _quant_run("action_int4_quantize", lambda: main(argv),
                            {"decode_attention_int4": L * steps,
                             "encoder_attention": 2 * depth,
                             "encoder_mlp": depth}, total, res, problems)
        if result["num_generated"] != 2:
            problems.append(f"action: {result['num_generated']} clips of 2")
        import numpy as np

        from vaura_tpu_torch.ops.audio import read_wav

        for i in range(2):
            wav, sr = read_wav(os.path.join(out_dir, f"{i}.wav"))
            if wav.shape != (1, tokens * 512) or not np.isfinite(wav).all():
                problems.append(f"action: clip {i} wav {wav.shape}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    for mode, changes, _ in QUANT_MODES:
        _quant_reference(gen, mode, changes, res, problems)
    res["launches"] = total
    report["quant_modes"] = res
    print("quant_modes: " + json.dumps({
        t: {k: res[t][k] for k in ("wall_s", "decode_loop_ms",
                                   "audio_s_per_s", "decode_loop_audio_s_per_s")}
        for t, *_ in QUANT_MODES}), flush=True)
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))
    return total


def phase_quant_quality(gen, report):
    """Both quantization-quality scripts at ``--mid`` (6 x 512) with few
    steps and clips, on the card: the overfit loss must fall below
    ``ln 1024`` and every number printed must be finite."""
    import torch

    from vaura_tpu_torch.scripts import int8_margin_check, quant_quality_fad

    common = ["--mid", "--steps", "30", "--batch", "4"]
    runs = {
        "int8_margin_check_int4_dots": (int8_margin_check.main, common + [
            "--gen-batch", "2", "--cache-bits", "4", "--int8-dots"]),
        "quant_quality_fad": (quant_quality_fad.main, common + [
            "--gen-batch", "4", "--clips", "4"]),
    }
    res, problems = {}, []

    def finite(x):
        if isinstance(x, dict):
            return all(finite(v) for v in x.values())
        return not isinstance(x, float) or math.isfinite(x)

    for tag, (fn, argv) in runs.items():
        t0 = time.time()
        out = fn(argv)
        torch.cuda.synchronize()
        res[tag] = {"argv": argv, "wall_s": time.time() - t0, "result": out}
        log(f"[quant_quality] {tag}: {res[tag]['wall_s']:.1f} s")
        if not (out["overfit_loss"] < math.log(1024) and finite(out)):
            problems.append(f"{tag}: {out}")
    report["quant_quality"] = res
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))


# ---------------------------------------------------------------------------
# the mesh phase: a sharded run at 1 x 1 x 1 (one card, NCCL) against the
# same run in one process without a mesh. The training step's loss is a
# forward of the same weights, batch and dropout masks through the same
# kernels (FSDP2's gather copies the weights): 1e-5 relative is about a
# thousandth of a bf16 ulp at ln 1024 (measured: see PERF.md)
MESH_LOSS_REL = 1e-5
MESH_TIMEOUT_S = 600
# the mesh phase's LoRA train action (``flagship_smoke.yaml``: frozen
# encoder, bf16, batch 2): adapters of rank 8, 2 steps at lr 1e-3 (the
# warm-up of ``vaura_defaults.yaml`` starts there, not at 1e-6), 1
# validation and 1 test batch, under ``torchrun`` at 1 x 1 x 1 and in this
# process (``_lora_train_checks``: the LM head drawn from the seeded
# generator, as the train action's zero head, JAX's too, passes no gradient
# to the adapters)
MESH_LORA_TRAIN = ["model.lora_rank=8", "trainer.fast_dev_run=false",
                   "trainer.max_epochs=1", "trainer.limit_train_batches=2",
                   "trainer.limit_val_batches=1",
                   "trainer.limit_test_batches=1",
                   "model.learning_rate=1.0e-3",
                   "model.lr_scheduler.params.warmup_init_lr=1.0e-3"]
# the adapters the mesh run saved against this process's: the same weights,
# batches and masks through the same kernels (FSDP2's gather at 1 x 1 x 1
# copies the weights), so they are expected equal; Adam moves an element by
# about lr (1e-3) a step, and 1e-6 is a thousandth of that
TOL_MESH_ADAPTERS = 1e-6
# the local head counts a model axis of 2 and 4 hands the decode kernels
LOCAL_HEADS = (8, 4)


def check_decode_local_heads(gen):
    """Each decode kernel at the head counts a model axis of 2 and 4 leaves
    a rank (H = 8, 4; hd 96, S 230), in both forms, against its plain
    version through the checks of the 16-head kernels at ``H`` heads
    (``check_decode_attention``, ``_check_quant_decode`` with its edge
    events). Then each kernel's ms a call in the plan's form over the main
    path's positions at B2 = 4 beside the byte bound."""
    import torch

    from vaura_tpu_torch.ops import decode_attention as da

    B2, hd, S, L = 4, 96, 230, 24
    groups8 = torch.tensor(dots_groups_s230(), dtype=torch.int32,
                           device="cuda")
    pos_t = torch.arange(S + 1, dtype=torch.int32, device="cuda")
    kinds = (("bf16", None, False), ("int8", 8, False), ("int4", 4, False),
             ("dots", 8, True))
    out = {}
    for H in LOCAL_HEADS:
        rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda",
                                     dtype=torch.bfloat16)
        q, k1, v1 = rnd(B2, H, hd), rnd(B2, H, hd), rnd(B2, H, hd)
        kc = _quant_caches(gen, (L, B2, S, H, hd))
        vc = _quant_caches(gen, (L, B2, S, H, hd))
        for kind, bits, dots in kinds:
            if bits is None:
                args = lambda i: (kc["bf16"][i], vc["bf16"][i])
                tail, kw = lambda i: (), {}
                row = check_decode_attention(gen, H=H, timed=False)
            else:
                args = lambda i: (kc[bits][0][i], vc[bits][0][i])
                tail = lambda i: (kc[bits][1][i], vc[bits][1][i])
                kw = dict(cache_bits=bits, int8_dots=dots,
                          chunk_starts=groups8 if dots else None)
                checked = _check_quant_decode(gen, f"decode {kind} H={H}",
                                              bits, dots, H=H, timed=False)
                row = {k: checked[k] for k in (
                    "max_abs_err", "over_tol_decode", "outputs",
                    "edge_events", "edge_event_limit", "max_err_limit")}
            form = da.kernel_plan(B2, H, H, S, hd, 0, True, kind=kind,
                                  groups=groups8.numel())["form"]

            def sweep():
                for pos in range(S - 1):
                    i = pos % L
                    da.decode_attention_cuda(q, *args(i), k1, v1,
                                             pos_t[pos:pos + 1], *tail(i),
                                             form=form, **kw)
            row["form"] = form
            row["ms"] = cuda_ms(sweep, 10) / (S - 1)
            cached = 2 * hd if bits is None else (
                hd // 2 if bits == 4 else hd) + 4
            row["bound_ms"] = sum(
                (8 * B2 * H * hd + 2 * B2 * p * H * cached) / HBM_BYTES_PER_S
                for p in range(S - 1)) / (S - 1) * 1e3
            out[f"{kind} H={H}"] = row
            log(f"[mesh] decode {kind} H={H}: max_abs_err "
                f"{row['max_abs_err']:.3e}, {row['ms']:.5f} ms a call "
                f"({form} form), bound {row['bound_ms']:.5f}")
        del kc, vc
        torch.cuda.empty_cache()
    return out


def _mesh_frames():
    """The clip the mesh phase's server encodes: one frame past 2.56 s of
    seeded 224 x 224 frames."""
    import numpy as np

    return np.random.default_rng(5).integers(
        0, 256, (int(2.56 * 25) + 1, 224, 224, 3), dtype=np.uint8)


def rank_main(out, argv) -> int:
    """``chip_smoke.py --rank OUT key=value ...``: one rank of a run the
    mesh phase starts under ``torchrun``, ``vaura_tpu_torch.main.main`` of
    ``argv`` as ``python -m vaura_tpu_torch`` runs it, the kernels' launch
    counters zeroed just before it (a server's: after its warm-up) and
    written to ``OUT/launches_rank<r>.json`` after it. A server's rank 0
    first sends one clip (``_mesh_frames``) through ``frames_to_features``,
    the encoder as a job of every rank, and writes its features to
    ``OUT/features.npy``."""
    import numpy as np

    sys.path.insert(0, ROOT)
    from vaura_tpu_torch.main import main as port_main
    from vaura_tpu_torch.scripts import serve

    start, make_server = serve.GenerationService.start, serve.make_server

    def start_then_zero(self):
        start(self)
        _zero_counters()

    def make_server_with_clip(cfg):
        service, server = make_server(cfg)
        if server is not None:
            np.save(os.path.join(out, "features.npy"),
                    service.frames_to_features(_mesh_frames()))
        return service, server

    serve.GenerationService.start = start_then_zero
    serve.make_server = make_server_with_clip
    _zero_counters()
    port_main(argv)
    rank = int(os.environ.get("RANK", "0"))
    with open(os.path.join(out, f"launches_rank{rank}.json"), "w") as f:
        json.dump(_counters(), f)
    return 0


@contextlib.contextmanager
def _lora_train_checks(notes):
    """Around a LoRA train action (``MESH_LORA_TRAIN``), in a rank of the
    mesh launch or in this process: the system's LM head drawn from the
    run's seeded generator after its initialisation (both runs draw alike),
    and after ``Trainer.fit`` the base sampler, whole (gathered under a
    mesh), compared bit for bit with itself when ``fit`` began; the names
    that differ go to ``notes["base_changed"]``."""
    import torch

    import vaura_tpu_torch.train.loop as tloop
    from vaura_tpu_torch.scripts import train as train_script

    init, fit = train_script.init_system, tloop.Trainer.fit

    def init_random_head(cfg, device):
        system, generator = init(cfg, device)
        w = system.sampler.lm_head.weight
        with torch.no_grad():
            w.normal_(0.0, w.shape[1] ** -0.5, generator=generator)
        return system, generator

    def base(system):
        pl = system.placement
        return {n: p.detach() if pl is None else pl.full(n, p)
                for n, p in system.named_parameters()
                if n.startswith("sampler.")}

    def fit_checked(self, *a, **k):
        start = {n: t.clone() for n, t in base(self.system).items()}
        out = fit(self, *a, **k)
        end = base(self.system)
        notes["base_changed"] = [n for n, t in start.items()
                                 if not torch.equal(t, end[n])]
        return out

    train_script.init_system, tloop.Trainer.fit = init_random_head, fit_checked
    try:
        yield
    finally:
        train_script.init_system, tloop.Trainer.fit = init, fit


def rank_jobs(out, jobs_path) -> int:
    """``chip_smoke.py --rank-jobs OUT JOBS``: one rank of the mesh phase's
    launch of several runs in one ``torchrun`` (one process start for them
    all). Each job of the JSON list ``JOBS`` (``{"tag", "argv"}``: ``argv``
    of ``vaura_tpu_torch.main.main``, or with ``"dryrun": true`` of
    ``vaura_tpu_torch.dryrun.main``, which ends the process group and so
    comes last) runs in order with the launch counters zeroed before it;
    its wall (after a device sync), launches and peak memory go to
    ``OUT/jobs_rank<r>.json``. A job with ``"lora_train": true`` runs
    inside ``_lora_train_checks``, whose notes join its record."""
    import gc

    import torch

    sys.path.insert(0, ROOT)
    from vaura_tpu_torch import dryrun
    from vaura_tpu_torch.main import main as port_main

    with open(jobs_path) as f:
        jobs = json.load(f)
    done = {}
    for job in jobs:
        notes = {}
        torch.cuda.reset_peak_memory_stats()
        _zero_counters()
        t0 = time.time()
        if job.get("dryrun"):
            if dryrun.main(job["argv"]) != 0:
                raise RuntimeError(f"{job['tag']}: the dry run failed")
        elif job.get("lora_train"):
            with _lora_train_checks(notes):
                port_main(job["argv"])
        else:
            port_main(job["argv"])
        torch.cuda.synchronize()
        done[job["tag"]] = {
            "wall_s": time.time() - t0, "launches": _counters(),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            **notes}
        gc.collect()
        torch.cuda.empty_cache()
    rank = int(os.environ.get("RANK", "0"))
    with open(os.path.join(out, f"jobs_rank{rank}.json"), "w") as f:
        json.dump(done, f)
    return 0


def _torchrun_ranks(tag, argv, root, mode="--rank"):
    """``argv`` of ``vaura_tpu_torch`` under ``torchrun --standalone
    --nproc_per_node=1`` through ``rank_main`` (or the arguments of
    ``rank_jobs``, ``mode`` ``--rank-jobs``); ``(Popen, log path, out
    dir)``, the output in ``<root>/<tag>.log``."""
    out = os.path.join(root, tag)
    os.makedirs(out)
    path = os.path.join(root, f"{tag}.log")
    with open(path, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node=1", os.path.abspath(__file__), mode, out,
             *argv], cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
    return proc, path, out


def _torchrun_jobs(root, jobs):
    """``jobs`` (``rank_jobs``) in one ``torchrun`` launch; ``(the launch's
    wall, {tag: {"wall_s", "launches"}})``."""
    path = os.path.join(root, "jobs.json")
    with open(path, "w") as f:
        json.dump(jobs, f)
    t0 = time.time()
    proc, log_path, out = _torchrun_ranks("jobs", [path], root,
                                          "--rank-jobs")
    try:
        rc = proc.wait(timeout=MESH_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.time() - t0
    if rc != 0:
        with open(log_path) as f:
            raise AssertionError(f"the mesh launch: exit {rc}: "
                                 f"{f.read()[-3000:]}")
    with open(os.path.join(out, "jobs_rank0.json")) as f:
        return wall, json.load(f)


def _wait_for_line(proc, path, pattern, timeout):
    """The first match of ``pattern`` in the log ``path`` of ``proc``;
    raises when ``proc`` ends first or ``timeout`` passes."""
    import re

    deadline = time.time() + timeout
    while time.time() < deadline:
        with open(path) as f:
            m = re.search(pattern, f.read())
        if m:
            return m
        if proc.poll() is not None:
            break
        time.sleep(0.5)
    with open(path) as f:
        raise AssertionError(f"no {pattern!r} in {path}: "
                             f"{f.read()[-3000:]}")


def _next_seed(base) -> int:
    """The seed the server hands its next batch or stream: one a batch and
    one a stream so far (``/metrics``)."""
    m = _metrics(base)
    return int(m["vaura_batches_total"] + m["vaura_stream_requests_total"])


def _mesh_server(root, res, problems, add):
    """(e) The server as a user starts it on several cards (``torchrun``,
    here one process with NCCL at 1 x 1 x 1), serve phase A's config:
    one clip through ``frames_to_features`` (a job of every rank), a lone
    ``raw=codes`` request held to ``VauraSystem.generate`` of the same
    weights (a one-process service of the same config, not started),
    padded features and seed in this process, a burst of 16, one stream,
    ``/reload`` after which a lone request's codes differ from the old
    weights' at the same seed, and SIGTERM, after which every process exits
    0. The server's launches (after its warm-up) are counted."""
    import shutil
    import signal
    import tempfile

    import numpy as np
    import torch

    from vaura_tpu_torch.main import get_config
    from vaura_tpu_torch.scripts.serve import GenerationService

    walls, out_res = res["walls_s"], {}
    argv = [f"config={os.path.join(ROOT, SERVE_CONFIG)}", "action=serve",
            "port=0", *SERVE_A]
    t0 = time.time()
    proc, path, out = _torchrun_ranks("server", argv, root)
    ckdir = tempfile.mkdtemp()
    try:
        m = _wait_for_line(proc, path, r"serving on (http://\S+) "
                           r"\(batch=\d+, pid (\d+)\)", MESH_TIMEOUT_S)
        walls["server_start"] = time.time() - t0
        base, pid = m.group(1), int(m.group(2))
        health = json.loads(_get(base + "/healthz"))
        out_res["mesh"] = health["mesh"]
        service = GenerationService(get_config(argv))
        rng = np.random.default_rng(0)

        def direct(system, feats, seed):
            with torch.inference_mode():
                o = system.generate(
                    vis_feats=torch.from_numpy(feats[None]).to(
                        service.device),
                    generator=torch.Generator(service.device).manual_seed(
                        seed),
                    max_new_tokens=service.tokens, tokens_per_frame=7,
                    decode_to_audio=False, **service.sampling)
            return o["codes"].cpu().numpy()[0]

        def lone(feats):
            seed = _next_seed(base)
            t = time.time()
            body = _post_npy(base + "/generate?raw=codes", feats)
            return np.asarray(json.loads(body)["codes"]), seed, time.time() - t

        # the clip rank 0 encoded at start-up, against this process's
        want = service.frames_to_features(_mesh_frames())
        got = np.load(os.path.join(out, "features.npy"))
        out_res["features_max_abs_diff"] = float(np.abs(got - want).max())
        if got.shape != want.shape or not out_res[
                "features_max_abs_diff"] <= TOL_REF_REL * float(
                np.abs(want).max()):
            problems.append(f"mesh server features {got.shape}, "
                            f"{out_res['features_max_abs_diff']} off")
        # a lone request, a burst of 16, a stream
        feats = rng.standard_normal((service.tv, service.cond_dim)).astype(
            np.float32)
        codes, seed, walls["server_lone_request"] = lone(feats)
        out_res["lone_codes_equal_direct"] = bool(
            np.array_equal(codes, direct(service.system, feats, seed)))
        if not out_res["lone_codes_equal_direct"]:
            problems.append("mesh server: lone request codes differ from "
                            "VauraSystem.generate")
        out_res["burst16"] = _burst(service, base, 16, rng, problems,
                                    "mesh server burst of 16")
        out_res["stream"] = _stream_request(service, base, rng, problems,
                                            "mesh server")
        # a hot reload: the codes of a lone request change
        t = time.time()
        ckpt = _reload_checkpoint(service, ckdir)
        walls["checkpoint_save"] = time.time() - t
        t = time.time()
        info = json.loads(_post_json(base + "/reload",
                                     {"ckpt_path": str(ckpt)}))
        walls["server_reload"] = time.time() - t
        codes, seed, _ = lone(feats)
        out_res["reload_codes_changed"] = bool(not np.array_equal(
            codes, direct(service.system, feats, seed)))
        metrics = _metrics(base)
        batches = int(metrics["vaura_batches_total"])
        if not (info.get("reloaded") and out_res["reload_codes_changed"]
                and metrics["vaura_reloads_total"] == 1):
            problems.append(f"mesh server reload: {info}, codes changed "
                            f"{out_res['reload_codes_changed']}")
        steps = _decode_steps(service, service.tokens)
        stream_steps = _decode_steps(service, service.stream_tokens)
        layers = service.system.sampler_config.num_layers
        depth = service.system.encoder.cfg.depth
        del service
        torch.cuda.empty_cache()
        # SIGTERM: rank 0 drains, every process exits 0
        t = time.time()
        os.kill(pid, signal.SIGTERM)
        rc = proc.wait(timeout=MESH_TIMEOUT_S)
        walls["server_drain_and_exit"] = time.time() - t
        out_res["exit_code"] = rc
        with open(path) as f:
            text = f.read()
        if rc != 0 or "shutdown complete (drained=True)" not in text:
            problems.append(f"mesh server: exit {rc} after SIGTERM: "
                            f"{text[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(ckdir, ignore_errors=True)
    with open(os.path.join(out, "launches_rank0.json")) as f:
        launches = json.load(f)
    want = {"decode_attention": layers * (steps * batches + stream_steps),
            "decode_attention_int8": 0, "encoder_attention": 2 * depth,
            "encoder_mlp": depth, "grouped_cls_attention": 0}
    out_res["launches"], out_res["expected_launches"] = launches, want
    if _differs(launches, want):
        problems.append(f"mesh server launches {launches}, expected {want}")
    add(launches)
    res["server"] = out_res
    log(f"[mesh] server 1x1x1 (mesh {out_res['mesh']}): lone request "
        f"{walls['server_lone_request']:.3f} s equal to generate: "
        f"{out_res['lone_codes_equal_direct']}, burst of 16 "
        f"{out_res['burst16']['wall_s']:.3f} s in "
        f"{out_res['burst16']['batches']} batches, stream first increment "
        f"{out_res['stream']['time_to_first_increment_s']:.3f} s, reload "
        f"{walls['server_reload']:.1f} s (codes changed: "
        f"{out_res['reload_codes_changed']}), exit {out_res['exit_code']}; "
        f"launches {launches}")


def _mesh_lora_action(root, res, problems, add, ft, job):
    """(f) The generate action from the finetune phase's LoRA experiment
    (L) under ``torchrun`` with NCCL (``job``, of the phase's launch): its
    codes equal the same action's in one process (the finetune phase's
    ``generate_lora``), its launches counted. ``main`` deletes L's
    experiment after the last phase."""
    import numpy as np

    from vaura_tpu_torch.ops.patterns import DelayedPatternProvider

    one = ft["wav_dirs"]["lora"]
    differ = [i for i in range(2) if not np.array_equal(
        np.load(os.path.join(one, f"{i}.codes.npy")),
        np.load(os.path.join(root, "lora_mesh", f"{i}.codes.npy")))]
    launches = job["launches"]
    steps = DelayedPatternProvider(9).get_pattern(
        FT_GEN_TOKENS)._build_seq_tables(FT_GEN_TOKENS)[1].shape[1] - 1
    want = _ft_want(encoder_fwd=1, decode_steps=steps)
    res["lora_action"] = {"codes_differ": differ, "launches": launches,
                          "expected_launches": want,
                          "one_process_wall_s": ft.get(
                              "generate_lora", {}).get("wall_s")}
    add(launches)
    log(f"[mesh] generate action from the LoRA run on the mesh: "
        f"{res['walls_s']['lora_action_mesh']:.1f} s (one process "
        f"{res['lora_action']['one_process_wall_s']}), codes differ in "
        f"{differ}, launches {launches}")
    if differ or _differs(launches, want):
        problems.append(f"LoRA action on the mesh: clips {differ} differ, "
                        f"launches {launches}, expected {want}")


def _train_record(root):
    """``(losses by step, test loss, last checkpoint's params)`` of the
    train action's run under ``root``."""
    from vaura_tpu_torch.train.checkpoint import load_state
    from vaura_tpu_torch.utils.tb import read_events

    run = _glob_one(root, "*")
    ev = read_events(_glob_one(run, "events.out.tfevents.*"))
    losses = [e["value"] for e in sorted(
        (e for e in ev if e["tag"] == "train_loss_step"),
        key=lambda e: e["step"])]
    (test,) = [e["value"] for e in ev if e["tag"] == "test_loss_epoch"]
    params = load_state(os.path.join(run, "checkpoints", "last"))["params"]
    return losses, test, {k: v.float() for k, v in params.items()}


def _mesh_lora_train(tmp, res, problems, add, job):
    """(g) The train action with LoRA adapters on the flagship
    (``MESH_LORA_TRAIN``) under ``torchrun`` with NCCL at 1 x 1 x 1
    (``job``, of the phase's launch: the base sampler placed for training,
    FSDP2-wrapped and frozen, the adapters whole, merged per block into its
    gathered weight) against the same action in this process: losses within
    ``MESH_LOSS_REL``, the saved adapters within ``TOL_MESH_ADAPTERS``, the
    adapters moved, the base sampler bit for bit its start in both, the
    checkpoint holding the adapters (and a bridge) alone, the launches
    counted (both encoder kernels once per encoder forward: 2 steps, 1
    validation and 1 test batch)."""
    import torch

    from vaura_tpu_torch.main import main

    notes = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30  # this phase's tensors
    _zero_counters()
    t0 = time.time()
    with _lora_train_checks(notes):
        main([f"config={os.path.join(ROOT, TRAIN_CONFIG)}", *MESH_LORA_TRAIN,
              f"trainer.log_dir={os.path.join(tmp, 'one')}"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _counters()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = _ft_want(encoder_fwd=2 + 1 + 1)
    add(launches)
    add(job["launches"])
    (m_loss, m_test, m_params), (o_loss, o_test, o_params) = (
        _train_record(os.path.join(tmp, k)) for k in ("mesh", "one"))
    rel = max(abs(a - b) / abs(b) for a, b in zip(m_loss, o_loss))
    names = sorted(m_params)
    err = max(float((m_params[k] - o_params[k]).abs().max()) for k in names)
    moved = max(float(v.abs().max()) for k, v in m_params.items()
                if k.endswith("lora_b"))
    r = res["lora_train"] = {
        "losses_mesh": m_loss, "losses_one": o_loss, "loss_rel": rel,
        "test_loss_mesh": m_test, "test_loss_one": o_test,
        "adapters_max_abs_diff": err, "lora_b_max_abs": moved,
        "checkpoint_params": len(names),
        "base_changed": [job.get("base_changed"), notes.get("base_changed")],
        "wall_s": [job["wall_s"], wall],
        "peak_mem_gib": [job["peak_mem_gib"], peak],
        "held_before_gib": held,
        "launches": [job["launches"], launches], "expected_launches": want}
    log(f"[mesh] LoRA train action, mesh / one process: wall "
        f"{job['wall_s']:.1f} / {wall:.1f} s, peak {job['peak_mem_gib']:.2f}"
        f" / {peak:.2f} GiB ({held:.2f} held before), losses {m_loss} / {o_loss} (rel {rel:.2e}), "
        f"adapters {err:.3e} apart, lora_b up to {moved:.3e}, test loss "
        f"{m_test} / {o_test}, launches {job['launches']} / {launches}")
    if not (len(m_loss) == len(o_loss) == 2 and rel <= MESH_LOSS_REL
            and all(map(math.isfinite, m_loss))):
        problems.append(f"LoRA train: losses {m_loss} against {o_loss}")
    if set(names) != set(o_params) or not names or any(
            not k.startswith(("lora_sampler.", "bridge.")) for k in names):
        problems.append(f"LoRA train: checkpoint holds {names[:3]}...")
    elif not err <= TOL_MESH_ADAPTERS or not moved > 0:
        problems.append(f"LoRA train: adapters {err:.3e} apart, lora_b up "
                        f"to {moved:.3e}")
    if r["base_changed"] != [[], []]:
        problems.append(f"LoRA train: base changed {r['base_changed']}")
    for tag, got in (("mesh", job["launches"]), ("one process", launches)):
        if _differs(got, want):
            problems.append(f"LoRA train ({tag}): launches {got}, expected "
                            f"{want}")


def phase_mesh(gen, report):
    """The multi-device path on this card: (a) the flagship dry run
    (``vaura_tpu_torch.dryrun --system flagship``: greedy generation of 221
    tokens for 2 clips, then one training step) under ``torchrun`` with
    NCCL at a mesh of 1 x 1 x 1, against the same run in this process
    without a mesh (loss within ``MESH_LOSS_REL``, codes equal); (b) the
    generate action from ``configs/generate_vgg.yaml`` at its batch of 16,
    greedy, under ``torchrun`` (its batch on a data mesh), against the same
    action in this process (codes equal, each WAV written once); (c) the
    demo on a synthetic ``--frames`` file, 2.56 s and 5.12 s, random
    flagship weights (finite WAVs of the right length, the decode and fused
    encoder kernels launched); (e) the server under ``torchrun`` with
    NCCL at 1 x 1 x 1 (``_mesh_server``: a clip, a lone request held to
    ``VauraSystem.generate``, a burst of 16, a stream, a hot reload,
    SIGTERM); (f) the generate action from the finetune phase's LoRA run
    under ``torchrun`` against the same action in one process
    (``_mesh_lora_action``); (g) the train action with LoRA adapters on the
    flagship under ``torchrun`` against the same action in this process
    (``_mesh_lora_train``); (d) the decode kernels at the head counts a
    model axis of 2 and 4 leaves a rank. (a), (b), (f) and (g) on the mesh
    share one ``torchrun`` launch (``rank_jobs``: one process start, paid
    once; their walls are taken in the rank, the launch's as
    ``mesh_launch``). Returns the launches of the dry run on the mesh, the
    demo, the one-process greedy action, the server's requests, the LoRA
    action on the mesh and both LoRA train actions."""
    import shutil

    import numpy as np
    import torch

    from vaura_tpu_torch import demo, dryrun
    from vaura_tpu_torch.main import main
    from vaura_tpu_torch.ops.audio import read_wav

    root = os.path.join(OUT_DIR, "mesh")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    res, problems, total = {"walls_s": {}}, [], {}
    walls = res["walls_s"]

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    # the runs on the mesh in one torchrun launch (one process start): the
    # generate action (b), the generate action from the LoRA run (f), the
    # LoRA train action (g), then the dry run (a), which ends the process
    # group
    ft = report.get("finetune") or {}
    if "lora_experiment" not in ft:
        raise AssertionError("no LoRA experiment: the finetune phase failed")
    # (g)'s run directories (each holds a float32 flagship base, frozen/)
    # inside the finetune phase's, which ``main`` deletes after the last
    # phase
    lora_tmp = os.path.join(ft["tmp"], "mesh_lora_train")
    out = os.path.join(root, "dryrun.pt")
    argv = [f"config={os.path.join(ROOT, 'configs/generate_vgg.yaml')}",
            "dataloader.dataset_type=dummy", "dataloader.num_workers=0",
            "max_batches=1", "return_sampled_indices=true",
            "use_sampling=false"]
    dirs = {k: os.path.join(root, f"action_{k}") for k in ("one", "mesh")}
    walls["mesh_launch"], jobs = _torchrun_jobs(root, [
        {"tag": "action", "argv": argv + [f"output_dir={dirs['mesh']}"]},
        {"tag": "lora_action", "argv": [
            f"config={os.path.join(ROOT, TRAIN_CONFIG)}", *FT_GEN,
            f"experiment_path={ft['lora_experiment']}",
            f"output_dir={os.path.join(root, 'lora_mesh')}"]},
        {"tag": "lora_train", "lora_train": True, "argv": [
            f"config={os.path.join(ROOT, TRAIN_CONFIG)}", *MESH_LORA_TRAIN,
            f"trainer.log_dir={os.path.join(lora_tmp, 'mesh')}"]},
        {"tag": "dryrun", "dryrun": True, "argv": [
            "--system", "flagship", "--mesh", "1x1x1", "--out", out]}])
    for tag, job in jobs.items():
        walls[f"{tag}_mesh"] = job["wall_s"]

    # (a) the flagship dry run on the mesh and in one process
    meshed = torch.load(out, weights_only=False)
    torch.cuda.empty_cache()
    t0 = time.time()
    one = dryrun.run(None, "cuda", "flagship")
    walls["dryrun_one_process"] = time.time() - t0
    rel = abs(meshed["loss"] - one["loss"]) / abs(one["loss"])
    same = torch.equal(meshed["codes"], one["codes"].cpu())
    steps = 24 * 229  # 221 tokens: 229 decode steps of 24 layers
    want = {"decode_attention": steps, "encoder_attention": 24,
            "encoder_mlp": 12, "grouped_cls_attention": 24}
    add(meshed["launches"])
    res["dryrun"] = {"loss_mesh": meshed["loss"], "loss_one": one["loss"],
                     "loss_rel": rel, "codes_equal": same,
                     "codes": list(meshed["codes"].shape),
                     "launches": meshed["launches"]}
    log(f"[mesh] dryrun flagship 1x1x1: loss {meshed['loss']:.7f} (one "
        f"process {one['loss']:.7f}, rel {rel:.2e}), greedy codes "
        f"{tuple(meshed['codes'].shape)} equal: {same}; launches "
        f"{meshed['launches']}")
    if not rel <= MESH_LOSS_REL:
        problems.append(f"dryrun loss rel {rel:.2e} > {MESH_LOSS_REL}")
    if not same:
        problems.append("dryrun greedy codes differ from one process")
    if _differs(meshed["launches"], want):
        problems.append(f"dryrun launches {meshed['launches']}, expected "
                        f"{want}")
    if not bool(torch.isfinite(meshed["audio"]).all()):
        problems.append("dryrun audio not finite")
    del one, meshed
    torch.cuda.empty_cache()

    # (b) the generate action: a data mesh under torchrun, one process here
    _zero_counters()
    t0 = time.time()
    main(argv + [f"output_dir={dirs['one']}"])
    torch.cuda.synchronize()
    walls["action_one_process"] = time.time() - t0
    action_launches = _counters()
    add(action_launches)
    files = {k: sorted(os.listdir(d)) for k, d in dirs.items()}
    n_codes = sum(f.endswith(".codes.npy") for f in files["mesh"])
    differ = [f for f in files["one"] if f.endswith(".codes.npy") and not
              np.array_equal(np.load(os.path.join(dirs["one"], f)),
                             np.load(os.path.join(dirs["mesh"], f)))]
    wav_err = max(float(np.abs(read_wav(os.path.join(dirs["one"], f))[0]
                               - read_wav(os.path.join(dirs["mesh"], f))[0]
                               ).max())
                  for f in files["one"] if f.endswith(".wav"))
    res["action"] = {"files_equal": files["one"] == files["mesh"],
                     "clips": n_codes, "codes_differ": differ,
                     "wav_max_abs_diff": wav_err,
                     "launches_one_process": action_launches}
    log(f"[mesh] generate action, batch 16 greedy: {n_codes} clips on the "
        f"mesh, codes differ in {len(differ)}, WAVs at most {wav_err:.3e} "
        f"apart; one-process launches {action_launches}")
    if files["one"] != files["mesh"] or n_codes != 16 or differ:
        problems.append(f"generate action on the mesh: files "
                        f"{files['mesh'][:4]}..., codes differ in {differ}")

    # (c) the demo from a frames file: 8 segments of 240 x 320 frames
    frames = np.random.default_rng(0).integers(
        0, 256, (8 * 16, 240, 320, 3)).astype(np.uint8)
    path = os.path.join(root, "frames.npy")
    np.save(path, frames)
    _zero_counters()
    t0 = time.time()
    demo.main(["--frames", path, "--long-duration", "5.12", "--out",
               os.path.join(root, "demo")])
    torch.cuda.synchronize()
    walls["demo"] = time.time() - t0
    demo_launches = _counters()
    add(demo_launches)
    wavs = {}
    for name, tokens in (("generated.wav", int(2.56 * 86)),
                         ("generated_long.wav", int(5.12 * 86))):
        wav, sr = read_wav(os.path.join(root, "demo", name))
        wavs[name] = list(wav.shape)
        if (sr != 44100 or wav.shape != (1, tokens * 512)
                or not np.isfinite(wav).all() or float(wav.std()) == 0.0):
            problems.append(f"demo {name}: {wav.shape} at {sr} Hz")
    # the encoder once per call (4 segments, then all 8 for the long run)
    if (demo_launches["encoder_attention"], demo_launches["encoder_mlp"]) != (
            48, 24) or demo_launches["decode_attention"] <= steps:
        problems.append(f"demo launches {demo_launches}")
    res["demo"] = {"wavs": wavs, "launches": demo_launches}
    log(f"[mesh] demo: {wavs}, launches {demo_launches}")
    os.remove(path)

    # (e) the server on the mesh, (f) the generate action from a LoRA run
    torch.cuda.empty_cache()
    _mesh_server(root, res, problems, add)
    torch.cuda.empty_cache()
    _mesh_lora_action(root, res, problems, add, ft, jobs["lora_action"])
    torch.cuda.empty_cache()
    try:
        _mesh_lora_train(lora_tmp, res, problems, add, jobs["lora_train"])
    finally:
        shutil.rmtree(lora_tmp, ignore_errors=True)

    # (d) the decode kernels at local head counts
    t0 = time.time()
    res["local_heads"] = check_decode_local_heads(gen)
    walls["decode_local_heads"] = time.time() - t0
    report["mesh"] = res
    srv = res["server"]
    print("mesh: " + json.dumps({
        "walls_s": walls, "loss_rel": res["dryrun"]["loss_rel"],
        "server": {"burst16": srv["burst16"], "stream": srv["stream"],
                   "lone_codes_equal_direct": srv["lone_codes_equal_direct"],
                   "reload_codes_changed": srv["reload_codes_changed"],
                   "features_max_abs_diff": srv["features_max_abs_diff"],
                   "exit_code": srv["exit_code"]},
        "lora_action_codes_differ": res["lora_action"]["codes_differ"],
        "lora_train": {k: res["lora_train"][k] for k in (
            "wall_s", "peak_mem_gib", "loss_rel", "adapters_max_abs_diff",
            "base_changed")},
        "decode_ms": {k: v["ms"] for k, v in res["local_heads"].items()}}),
        flush=True)
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))
    return total


# ---------------------------------------------------------------------------
# the benchmark entry points (vaura_tpu_torch.bench, the burst bench, the
# codes precompute tool)
AOT_CONFIG = "configs/experiments/flagship_smoke.yaml"
# the server of AOT_CONFIG (the flagship, seeded weights, its default batch
# of 8 and 2.56 s) with the bf16 cache and with quantize=cache: the mode's
# tag, its overrides and the decode kernel its steps launch
AOT_MODES = (("bf16", [], "decode_attention"),
             ("cache", ["quantize=cache"], "decode_attention_int8"))
AOT_TIMEOUT_S = 400


def _decode_kernel_counts(da) -> dict:
    """The decode kernels' counts of ``launch_counts`` from the wrapper
    module alone (the aot process imports nothing of the models)."""
    return {"decode_attention": da.launches - da.int8_launches
            - da.int4_launches - da.int8_dots_launches,
            "decode_attention_int8": da.int8_launches}


def aot_load_main(out) -> int:
    """``chip_smoke.py --aot-load OUT``: a fresh process that answers from
    the ``aot`` phase's artifacts without the model code. It loads
    ``OUT/state.pt`` onto the card, then for each mode ``OUT/<tag>.pt2``
    (``load_generate``), and answers ``OUT/feats.npy`` with seed 0: the
    first mode twice (its first answer pays the process's first launches),
    the others once, each after the first a batch wall; the first answer's
    seconds counted from the start of the loads; the decode kernels'
    counters zeroed before each answer and read after it. Writes
    ``OUT/<tag>_aot_codes.npy`` and
    ``OUT/aot_load.json``; fails if ``vaura_tpu_torch.models`` or JAX was
    imported."""
    t_start = time.time()
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from vaura_tpu_torch.ops import decode_attention as da
    from vaura_tpu_torch.utils.aot import load_generate

    torch.backends.cuda.matmul.allow_tf32 = False  # as main() sets it
    res = {"import_s": time.time() - t_start}
    t0 = time.time()
    state = {k: v.to("cuda") for k, v in torch.load(
        os.path.join(out, "state.pt"), weights_only=True, mmap=True).items()}
    feats = torch.from_numpy(np.load(os.path.join(out, "feats.npy"))).cuda()
    torch.cuda.synchronize()
    res["state_load_s"] = time.time() - t0
    for tag, _, _ in AOT_MODES:
        r = res[tag] = {}
        t1 = time.time()
        fn, meta = load_generate(os.path.join(out, f"{tag}.pt2"))
        r["artifact_load_s"] = time.time() - t1
        r["answers"] = 2 if tag == AOT_MODES[0][0] else 1
        for i in range(r["answers"]):
            _zero_counters()
            t2 = time.time()
            audio, codes = fn(state, feats, 0)
            codes = codes.cpu().numpy()
            finite = bool(torch.isfinite(audio).all())
            r[f"answer{i}_s"] = time.time() - t2
            r[f"launches{i}"] = _decode_kernel_counts(da)
            r[f"forms{i}"] = dict(da.form_launches)
        r["load_to_first_answer_s"] = (r["artifact_load_s"] + r["answer0_s"]
                                       + (res["state_load_s"]
                                          if tag == AOT_MODES[0][0] else 0.0))
        r["audio_finite"], r["meta_device"] = finite, meta["device_name"]
        np.save(os.path.join(out, f"{tag}_aot_codes.npy"), codes)
    res["modules_loaded"] = sorted(
        m for m in sys.modules if m.startswith("vaura_tpu_torch.models")
        or m.split(".")[0] in ("jax", "vaura_tpu"))
    with open(os.path.join(out, "aot_load.json"), "w") as f:
        json.dump(res, f)
    return 1 if res["modules_loaded"] else 0


def phase_aot(gen, report):
    """Serving from exported graphs (``utils/aot.py``) as a user runs it:
    the server of ``AOT_CONFIG`` started with ``aot_export=`` in each mode
    of ``AOT_MODES`` (``GenerationService``: the warm-up, then the export
    of its three programs, timed), one eager batch of seeded features
    through ``_generate`` with seed 0 (its codes, wall and launches); the
    served state saved once to a ``state.pt``; then a fresh process
    (``chip_smoke.py --aot-load``) loads the state and each artifact and
    answers the same batch and seed without importing the model code (the
    first mode twice, the warm second answer its batch wall). Held:
    the aot codes equal the eager server's in both modes; the exported step
    holds the decode-attention operator once per layer; each aot answer
    launches the mode's decode kernel layers x steps times, and so does the
    eager batch; the artifact under 1% of the state's bytes. Printed
    (``aot: {...}``, beside the card's name and power limit): export
    seconds, artifact and state bytes, the load-to-first-answer seconds and
    the batch wall, aot against eager. Returns the counted launches (the
    eager batches' and the aot answers')."""
    import io
    import shutil
    import tempfile
    import zipfile

    import numpy as np
    import torch

    from vaura_tpu_torch.main import get_config
    from vaura_tpu_torch.scripts.serve import GenerationService
    from vaura_tpu_torch.utils.aot import serving_state

    res, problems, total = {}, [], {}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    res["card"] = smi[0] if smi else report["device"]
    tmp = tempfile.mkdtemp(prefix="aot_")
    try:
        feats = None
        for tag, extra, kernel in AOT_MODES:
            r = res[tag] = {}
            art = os.path.join(tmp, f"{tag}.pt2")
            cfg = get_config([f"config={os.path.join(ROOT, AOT_CONFIG)}",
                              "action=serve", *extra, f"aot_export={art}"])
            t0 = time.time()
            service = GenerationService(cfg)
            service.start()
            r["start_s"] = time.time() - t0
            r["export_s"] = service.aot_export_s
            layers = service.system.sampler_config.num_layers
            want = layers * _decode_steps(service, service.tokens)
            if feats is None:
                feats = np.random.default_rng(0).standard_normal(
                    (service.batch, service.tv, service.cond_dim)
                ).astype(np.float32)
                np.save(os.path.join(tmp, "feats.npy"), feats)
            torch.cuda.synchronize()
            _zero_counters()
            t0 = time.time()
            with torch.no_grad():
                out = service._generate(service._put_batch(feats), 0)
            codes = out["codes"].cpu().numpy()
            r["eager_batch_s"] = time.time() - t0
            launches = _counters()
            r["eager_launches"] = launches[kernel]
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            if launches[kernel] != want or sum(launches.values()) != want:
                problems.append(f"{tag}: eager launches {launches}, expected "
                                f"{want} of {kernel}")
            np.save(os.path.join(tmp, f"{tag}_eager_codes.npy"), codes)
            state = serving_state(service.system)
            r["state_bytes"] = sum(t.numel() * t.element_size()
                                   for t in state.values())
            r["artifact_bytes"] = (os.path.getsize(art)
                                   + os.path.getsize(art + ".json"))
            if tag == AOT_MODES[0][0]:  # both modes serve these weights
                t0 = time.time()
                torch.save({k: v.cpu() for k, v in state.items()},
                           os.path.join(tmp, "state.pt"))
                r["state_save_s"] = time.time() - t0
            # the operator's nodes in the serialized step graph
            with zipfile.ZipFile(art) as zf, zipfile.ZipFile(
                    io.BytesIO(zf.read("step.pt2"))) as inner:
                graph = inner.read(next(n for n in inner.namelist()
                                        if n.endswith("models/model.json")))
            r["step_graph_ops"] = graph.count(
                b'"target": "torch.ops.vaura_torch.decode_attention.default"')
            if r["step_graph_ops"] != layers:
                problems.append(f"{tag}: the exported step holds "
                                f"{r['step_graph_ops']} decode-attention "
                                f"operators, expected {layers}")
            if not r["artifact_bytes"] < 0.01 * r["state_bytes"]:
                problems.append(f"{tag}: artifact {r['artifact_bytes']} B, "
                                f"not under 1% of {r['state_bytes']} B")
            r["want_launches"] = want
            service.close(timeout=30)
            del service, state, out
            torch.cuda.empty_cache()
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--aot-load", tmp], capture_output=True, text=True,
            timeout=AOT_TIMEOUT_S)
        res["process_s"] = time.time() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the aot process exited {proc.returncode}:"
                                 f"\n{proc.stderr[-4000:]}")
        with open(os.path.join(tmp, "aot_load.json")) as f:
            sub = json.load(f)
        res["import_s"], res["state_load_s"] = (sub["import_s"],
                                                sub["state_load_s"])
        for tag, _, kernel in AOT_MODES:
            r, s = res[tag], sub[tag]
            last = s["answers"] - 1
            r.update({k: s[k] for k in ("artifact_load_s", "answer0_s",
                                        "load_to_first_answer_s")})
            r["forms"] = s[f"forms{last}"]
            r["aot_batch_s"] = s[f"answer{last}_s"]
            r["aot_over_eager"] = r["aot_batch_s"] / r["eager_batch_s"]
            eager = np.load(os.path.join(tmp, f"{tag}_eager_codes.npy"))
            aot = np.load(os.path.join(tmp, f"{tag}_aot_codes.npy"))
            r["codes_equal"] = bool(np.array_equal(eager, aot))
            r["codes_differ"] = int((eager != aot).sum())
            if not r["codes_equal"]:
                problems.append(f"{tag}: aot codes differ from the eager "
                                f"server's in {r['codes_differ']} tokens")
            if not s["audio_finite"]:
                problems.append(f"{tag}: aot audio not finite")
            for i in range(s["answers"]):
                got = s[f"launches{i}"]
                total[kernel] = total.get(kernel, 0) + got[kernel]
                if got[kernel] != r["want_launches"] or sum(
                        got.values()) != r["want_launches"]:
                    problems.append(f"{tag}: aot answer {i} launched {got}, "
                                    f"expected {r['want_launches']} of "
                                    f"{kernel}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["aot"] = res
    print("aot: " + json.dumps(res), flush=True)
    for tag, _, _ in AOT_MODES:
        r = res.get(tag, {})
        log(f"[aot] {tag}: export {r.get('export_s')} s, artifact "
            f"{r.get('artifact_bytes')} B of state {r.get('state_bytes')} B, "
            f"load to first answer {r.get('load_to_first_answer_s')} s, "
            f"batch aot {r.get('aot_batch_s')} s vs eager "
            f"{r.get('eager_batch_s')} s ({res['card']})")
    if problems:
        raise AssertionError("; ".join(problems))
    return total


BENCH_BURST = ["--config", SERVE_CONFIG, "--batch", "8", "--requests", "16",
               "--concurrency", "16"]
BENCH_BURST_TIMEOUT_S = 600
BENCH_CODES = ["configs/experiments/dummy.yaml", "--split", "validation",
               "--batch", "2", "--limit", "4"]


def _bench_line(argv):
    """``vaura_tpu_torch.bench.main(argv)`` in this process: its JSON line,
    parsed from what it printed, and its ``#`` lines."""
    import io

    from vaura_tpu_torch import bench

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main(argv)
    lines = buf.getvalue().splitlines()
    results = [ln for ln in lines if ln.startswith("{")]
    if len(results) != 1:
        raise AssertionError(f"bench {argv}: {len(results)} JSON lines in "
                             f"{lines}")
    return json.loads(results[0]), [ln for ln in lines if ln.startswith("#")]


def _positive(tag, line, keys, problems):
    for k in keys:
        v = line.get(k)
        if not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0):
            problems.append(f"{tag}: {k} = {v!r}, not finite and > 0")


def phase_bench(gen, report):
    """The benchmark as a user runs it (``python -m vaura_tpu_torch.bench``,
    here ``bench.main(argv)`` in this process, each JSON line parsed): (a)
    generate mode at its defaults (B=128, the int8 cache over bf16 weights,
    the DAC in bf16) with its peak memory; (b) ``--no-int8 --with-encoder``
    (B=32, frames through the fused encoder); (c) encoder mode with the int8
    encoder (B = 1, 8, 16, 32); (d) long mode at B=8 over 5.12 s (int8
    weights and cache); (e) train mode (B=12, 2 timed steps); each with
    ``--iters 1`` but train, its counters zeroed before and read after,
    exact launch counts for (a) to (d). Then (f) the burst bench as a
    subprocess (the server it starts is another), 16 requests at batch 8 and
    concurrency 16, and (g) the codes precompute tool on the dummy
    datamodule, its files checked as the CPU test checks them. Every value
    finite and positive, under the JAX bench's metric names, with the card's
    name beside it."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vaura_tpu_torch.flagship import GENERATE_KW, flagship_system
    from vaura_tpu_torch.models.motionformer import MotionFormerConfig
    from vaura_tpu_torch.models.sampler import SamplerConfig

    name = report["device"]
    res, problems, total = {}, [], {}
    layers, depth = SamplerConfig().num_layers, MotionFormerConfig().depth
    # the decode steps of a generation and of 5.12 s at a 0.64 s stride
    # (tables only: a system without weights, on the host)
    probe = flagship_system("cpu", None, sampler_layers=1, encoder=False)
    steps = probe.prepare_generation(GENERATE_KW["max_new_tokens"])[2] - 1
    long_steps = _long_decode_steps(probe, int(5.12 * 86), int(0.64 * 86),
                                    GENERATE_KW["max_new_tokens"])
    del probe
    runs = (
        ("a_generate", ["--iters", "1"],
         "audio_sec_per_sec_per_chip",
         {"decode_attention_int8": 2 * layers * steps}),
        ("b_generate_encoder", ["--no-int8", "--with-encoder", "--iters", "1"],
         "frames_to_audio_sec_per_sec_per_chip",
         {"decode_attention": 2 * layers * steps,
          "encoder_attention": 2 * 2 * depth, "encoder_mlp": 2 * depth}),
        ("c_encoder", ["--mode", "encoder", "--int8-encoder", "--iters", "1"],
         "encoder_ms_per_clip", {"grouped_cls_attention": 8 * 2 * depth}),
        ("d_long", ["--mode", "long", "--batch", "8", "--duration", "5.12",
                    "--iters", "1"], "long_audio_sec_per_sec_per_chip",
         {"decode_attention_int8": 2 * layers * long_steps}),
        ("e_train", ["--mode", "train", "--iters", "2"],
         "train_codec_tokens_per_sec_per_chip", {}),
    )
    for tag, argv, metric, want in runs:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _zero_counters()
        t0 = time.time()
        try:
            line, notes = _bench_line(argv)
        except Exception as e:  # the other runs go on; the phase fails
            problems.append(f"{tag}: {type(e).__name__}: {e}")
            traceback.print_exc()
            continue
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = _counters()
        res[tag] = {"argv": argv, "line": line, "notes": notes,
                    "wall_s": wall, "launches": launches,
                    "expected_launches": want, "form_launches": _form_counts(),
                    "held_gib": held / 2 ** 30,
                    "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        log(f"[bench] {tag}: {json.dumps(line)}; wall {wall:.1f} s, peak "
            f"{res[tag]['peak_mem_gib']:.2f} GiB ({held / 2 ** 30:.2f} held "
            f"before), launches {launches}")
        for note in notes:
            log(f"[bench] {tag} {note}")
        if line.get("metric") != metric:
            problems.append(f"{tag}: metric {line.get('metric')!r}")
        if name not in str(line.get("device")):
            problems.append(f"{tag}: device {line.get('device')!r}")
        _positive(tag, line, ["value"] + (["mfu"] if tag == "e_train" else []),
                  problems)
        if tag == "c_encoder":
            _positive(tag, line["sweep"], list(line["sweep"]), problems)
        if _differs(launches, want):
            problems.append(f"{tag}: launches {launches}, expected {want}")

    # (f) the burst bench, as a user starts it
    from vaura_tpu_torch.dryrun import _free_port

    port = _free_port()
    cmd = [sys.executable, "-m", "vaura_tpu_torch.scripts.burst_bench",
           *BENCH_BURST, "--port", str(port)]
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=BENCH_BURST_TIMEOUT_S)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or len(lines) != 1:
            log_path = os.path.join(tempfile.gettempdir(),
                                    f"burst_serve_{port}.log")
            tail = ""
            if os.path.exists(log_path):
                with open(log_path) as f:
                    tail = f.read()[-3000:]
            raise AssertionError(f"exit {proc.returncode}: {proc.stderr[-2000:]}"
                                 f"\nserver log: {tail}")
        line = json.loads(lines[0])
        res["f_burst"] = {"argv": BENCH_BURST, "line": line,
                          "wall_s": time.time() - t0}
        log(f"[bench] f_burst: {json.dumps(line)}; wall "
            f"{res['f_burst']['wall_s']:.1f} s")
        if line["errors"] != 0 or line["requests"] != 16:
            problems.append(f"f_burst: {line['requests']} requests answered, "
                            f"{line['errors']} errors")
        if name not in str(line.get("device")):
            problems.append(f"f_burst: device {line.get('device')!r}")
        _positive("f_burst", line, ["audio_sec_per_s", "req_per_s", "p50_s",
                                    "p95_s", "first_request_s"], problems)
    except Exception as e:  # noqa: BLE001 — recorded, the phase fails
        problems.append(f"f_burst: {type(e).__name__}: {e}")

    # (g) the codes precompute tool on the dummy datamodule
    from vaura_tpu_torch.scripts import precompute_codes

    out = tempfile.mkdtemp(prefix="bench_codes_")
    t0 = time.time()
    try:
        n, dirs = precompute_codes.main([os.path.join(ROOT, BENCH_CODES[0]),
                                         *BENCH_CODES[1:], "--out", out])
        files = sorted(f for f in os.listdir(out) if f.endswith(".codes.npy"))
        codes = [np.load(os.path.join(out, f)) for f in files]
        res["g_precompute"] = {"argv": BENCH_CODES, "files": files,
                               "shapes": [list(c.shape) for c in codes],
                               "wall_s": time.time() - t0}
        log(f"[bench] g_precompute: {res['g_precompute']}")
        if n != 4 or files != [f"{i}.codes.npy" for i in range(4)]:
            problems.append(f"g_precompute: {n} files {files}")
        for f, c in zip(files, codes):
            if not (c.dtype == np.int16 and c.shape == (3, 48)
                    and 0 <= c.min() and c.max() < 16):
                problems.append(f"g_precompute: {f} {c.dtype} {c.shape} "
                                f"in [{c.min()}, {c.max()}]")
    except Exception as e:  # noqa: BLE001 — recorded, the phase fails
        problems.append(f"g_precompute: {type(e).__name__}: {e}")
    finally:
        shutil.rmtree(out, ignore_errors=True)

    report["bench"] = res
    print("bench: " + json.dumps({
        tag: {**{k: r["line"].get(k) for k in (
            "metric", "value", "batch", "quant_mode", "mfu", "sweep",
            "p50_batch_seconds", "p50_s", "p95_s", "req_per_s",
            "audio_sec_per_s") if k in r.get("line", {})},
              "wall_s": r["wall_s"],
              **({"peak_mem_gib": r["peak_mem_gib"]} if "peak_mem_gib" in r
                 else {})}
        for tag, r in res.items() if "line" in r}), flush=True)
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))
    return total


def main() -> int:
    if sys.argv[1:2] == ["--rank"]:  # a rank of the mesh phase's torchrun
        return rank_main(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["--rank-jobs"]:
        return rank_jobs(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--aot-load"]:  # the aot phase's fresh process
        return aot_load_main(sys.argv[2])
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
    if sys.argv[1:2] == ["--phase"]:  # one phase alone, e.g. mla_moe
        run(sys.argv[2], globals()["phase_" + sys.argv[2]], gen, report)
        report["failed"] = failed
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, f"chip_smoke_{sys.argv[2]}.json"),
                  "w") as f:
            json.dump(report, f, indent=1, default=str)
        print(json.dumps({"ok": not failed, "failed": failed}))
        return 1 if failed else 0
    run("build", phase_build, report)
    kernels = []
    checks = (check_decode_attention, check_decode_attention_int8,
              check_decode_attention_int4, check_decode_attention_int8_dots,
              check_encoder_attention, check_encoder_mlp,
              check_grouped_cls_attention, check_mla_decode_attention)
    for check in checks:
        entry = run(check.__name__, check, gen)
        if entry is None:
            continue
        kernels.append(entry)
        log(f"[{entry['name']}] max_abs_err {entry['max_abs_err']:.3e} "
            f"(tol {entry['tol']}) ms {entry['ms']:.4f} plain {entry['plain_ms']:.4f} "
            f"bound {entry['bound_ms']:.4f} library {entry['library_ms']}")
        # the int8 x int8 kernel: TOL_DECODE, or for its few outputs past it
        # one p8 step more (``_check_quant_decode``)
        if not entry["max_abs_err"] <= entry.get("max_err_limit",
                                                 entry["tol"]):
            failed.append(f"{entry['name']} tolerance")
    launches = run("main", phase_main, gen, report) or {}
    run("decode_graph", phase_decode_graph, gen, report)
    int8_launches = run("int8", phase_int8, gen, report) or {}
    train_launches = run("train", phase_train, gen, report) or {}
    run("long", phase_long, gen, report)
    run("reference", phase_reference, gen, report)
    action_launches = run("action", phase_action, gen, report) or {}
    train_action_launches = run("train_action", phase_train_action, gen,
                                report) or {}
    serve_launches = run("serve", phase_serve, gen, report) or {}
    aot_launches = run("aot", phase_aot, gen, report) or {}
    finetune_launches = run("finetune", phase_finetune, gen, report) or {}
    if "finetune" in report:
        run("eval", phase_eval, gen, report)
    else:
        failed.append("eval")
    variant_launches = run("encoder_variants", phase_encoder_variants, gen,
                           report) or {}
    quant_launches = run("quant_modes", phase_quant_modes, gen, report) or {}
    run("quant_quality", phase_quant_quality, gen, report)
    mesh_launches = run("mesh", phase_mesh, gen, report) or {}
    bench_launches = run("bench", phase_bench, gen, report) or {}
    mla_launches = run("mla_moe", phase_mla_moe, gen, report) or {}
    run("snake", phase_snake, gen, report)
    if (report.get("finetune") or {}).get("tmp"):  # L's experiment
        import shutil

        shutil.rmtree(report["finetune"]["tmp"], ignore_errors=True)

    # each kernel's count on the main paths that run it: generation for the
    # decode and fused encoder kernels, generation with the int8 cache for
    # the int8 decode kernel, the three training steps for the grouped
    # attention, the generate action's three runs and the server's
    # requests, the finetune runs, and the encoder variants' generation
    # (decode attention) and int8 encoder (grouped attention), the last
    # sampler modes (the int4 and int8 x int8 decode kernels), and the
    # benchmark's runs in this process
    for entry in kernels:
        name = entry["name"]
        entry["launches"] = (
            launches.get(name, 0) + train_launches.get(name, 0)
            + (int8_launches.get(name, 0) if name == "decode_attention_int8"
               else 0) + action_launches.get(name, 0)
            + train_action_launches.get(name, 0)
            + serve_launches.get(name, 0)
            + aot_launches.get(name, 0)
            + finetune_launches.get(name, 0)
            + variant_launches.get(name, 0)
            + quant_launches.get(name, 0)
            + mesh_launches.get(name, 0)
            + bench_launches.get(name, 0)
            + mla_launches.get(name, 0))
    report["kernels"] = kernels
    report["failed"] = failed
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the decode kernels also carry both forms' ms a call at each B2
    print(json.dumps({"kernels": [
        {**{k: e[k] for k in keys},
         **({"form_ms": e["form_ms"]} if "form_ms" in e else {})}
        for e in kernels]}))
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
