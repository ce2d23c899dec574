"""Headline benchmark of the port: batched 2.56 s clip generation on one card.

Counterpart of the repo's ``bench.py``: the same modes, flags, defaults and
JSON lines, run by the port on its CUDA kernels::

    python -m vaura_tpu_torch.bench [--mode generate|long|train|encoder]
        [--batch B] [--iters N] [--platform cuda|cpu] [...]

Each mode prints ONE JSON line (after ``#`` comment lines), with the JAX
bench's keys and ``device``: the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them, or ``"cpu"``.

  generate  (default) the flagship generation hot path: 24L x 1536d x 16h
            sampler, 9 codebooks, CFG 6.0 (a 2B decode batch), top-k 128,
            221 tokens through the KV-cache decode loop, then the DAC decode
            to the waveform in bf16; B=128 with the int8 KV cache over bf16
            weights by default. ``{"metric": "audio_sec_per_sec_per_chip",
            "value", "unit", "vs_baseline", "quant_mode", "batch"}``;
            ``vs_baseline`` is the value over the repo's target of 5x
            realtime. ``--with-encoder`` runs the visual encoder on frames
            inside the timed call (``frames_to_audio_sec_per_sec_per_chip``,
            B=32 by default).
  long      10.24 s a clip through ``generate_long`` at a 0.64 s stride, or
            ``generate_long_kv`` (``--long-kv``) over a rolling window;
            int8 weights and cache by default.
  train     flagship sampler train steps (float32 parameters, bf16 compute,
            remat, frozen codec) on audio through the DAC encoder or on
            precomputed codes; tokens/s and the model FLOPs utilisation
            against the H100 SXM's dense bf16 peak.
  encoder   the MotionFormer feature extraction alone, ms a 2.56 s clip over
            B in (1, 8, 16, 32).

The weights are seeded random: throughput does not depend on their values.
One warm-up call (the CUDA kernels build from ``csrc/`` at their first
launch, there and never inside the timed window), then ``--iters`` timed
calls, each ended by reading its result on the host; the value comes from
the fastest. Runs on CUDA unless ``--platform cpu``; without CUDA it raises
``RuntimeError``. Nothing is compiled, so ``--compilation-cache-dir`` is
accepted and ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

SECONDS_PER_CLIP = 2.56
TOKENS_PER_SECOND = 86  # DAC 44.1 kHz frame rate
TARGET_AUDIO_SEC_PER_SEC = 5.0  # the repo's north star: 5x realtime a card
# H100 SXM dense bf16 peak (NVIDIA's data sheet), the operations bound of
# PERF.md's kernel table
H100_BF16_PEAK = 989e12
FEATURE_ROWS = 32  # visual feature rows of a 2.56 s clip (4 segments x 8)
SEGMENT_ROWS = 8  # feature rows of a 0.64 s segment
SEGMENT_SECONDS = 0.64
TRAIN_AUDIO_SAMPLES = 112896  # 2.56 s at 44.1 kHz
TRAIN_BATCH = 12  # the reference recipe's per-GPU batch
ENCODER_BATCHES = (1, 8, 16, 32)
TOKENS_PER_FRAME = 7


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # None -> resolve_args: 128, or 32 under --with-encoder (frames and the
    # encoder's activations beside the cache)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--tokens", type=int, default=221)
    ap.add_argument("--cfg-scale", type=float, default=6.0)
    ap.add_argument("--top-k", type=int, default=128)
    ap.add_argument("--no-dac", action="store_true", help="skip waveform decode")
    ap.add_argument("--int8", dest="quant_mode", action="store_const",
                    const="int8", default=None,
                    help="int8 sampler weights and int8 KV cache")
    ap.add_argument("--no-int8", dest="quant_mode", action="store_const",
                    const="none", help="bf16 weights and cache")
    ap.add_argument("--int8-cache-only", dest="quant_mode",
                    action="store_const", const="cache",
                    help="bf16 weights over the int8 KV cache: the default "
                         "in generate mode")
    ap.add_argument("--cache-bits", type=int, choices=[8, 4], default=8,
                    help="KV-cache width of the quantized modes: 4 = the "
                         "nibble-packed int4 cache")
    ap.add_argument("--int8-dots", action="store_true",
                    help="int8 x int8 attention products over the quantized "
                         "cache")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--mode", choices=["generate", "train", "encoder", "long"],
                    default="generate",
                    help="train: flagship train-step throughput; encoder: "
                         "MotionFormer feature extraction sweep (ms per "
                         "2.56 s clip); long: 10.24 s chunked generation "
                         "with prompt carry")
    ap.add_argument("--duration", type=float, default=10.24,
                    help="long mode: total seconds per sample")
    ap.add_argument("--stride", type=float, default=0.64,
                    help="long mode: chunk stride seconds")
    ap.add_argument("--long-kv", action="store_true",
                    help="long mode: rolling-KV decode (generate_long_kv) "
                         "instead of chunk re-prefill")
    ap.add_argument("--window-chunks", type=int, default=4,
                    help="--long-kv: trailing chunks queries attend")
    ap.add_argument("--chunk-steps", type=int, default=56,
                    help="--long-kv: steps per rolling cache chunk")
    ap.add_argument("--sink-chunks", type=int, default=0,
                    help="--long-kv: pinned anchor chunks (0 = pure sliding "
                         "window)")
    ap.add_argument("--layers", type=int, default=None,
                    help="override the decoder's layer count (the encoder's "
                         "depth in encoder mode)")
    ap.add_argument("--greedy", action="store_true",
                    help="argmax sampling (isolates top-k cost)")
    ap.add_argument("--decode-buckets", type=int, default=None,
                    help="the cache's chunk groups of the int8 x int8 "
                         "products; default 8, 2 in long mode")
    ap.add_argument("--with-encoder", action="store_true",
                    help="generate mode: frames -> waveform, the visual "
                         "encoder inside the timed call")
    ap.add_argument("--int8-encoder", action="store_true",
                    help="int8 MotionFormer inference (encoder mode and "
                         "--with-encoder)")
    ap.add_argument("--encoder-chunk", type=int, default=None,
                    help="with --with-encoder: run the visual encoder over "
                         "sequential batch slices of this size")
    ap.add_argument("--precomputed-codes", action="store_true",
                    help="train mode: feed codec tokens instead of encoding "
                         "audio every step")
    ap.add_argument("--no-remat", action="store_true",
                    help="train mode: disable block rematerialization")
    ap.add_argument("--remat-policy", type=str, default=None,
                    choices=["dots", "dots_no_batch"],
                    help="train mode: checkpoint policy (default: save "
                         "nothing, recompute all)")
    ap.add_argument("--mu-dtype", type=str, default=None,
                    help="train mode: AdamW first-moment dtype (e.g. "
                         "bfloat16)")
    ap.add_argument("--nu-dtype", type=str, default=None,
                    help="train mode: AdamW second-moment dtype")
    ap.add_argument("--compilation-cache-dir", type=str, default=None,
                    help="accepted for the JAX bench's command lines; the "
                         "port compiles nothing, so it is ignored")
    ap.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                    help="cpu runs the kernels' plain PyTorch versions")
    return ap


def resolve_args(args: argparse.Namespace) -> argparse.Namespace:
    """The defaults that depend on other flags, in place: the quant mode
    (``cache`` in generate mode, ``int8`` in the others), the batch (128,
    or 32 under ``--with-encoder``) and the decode buckets (8, or 2 in long
    mode)."""
    if args.quant_mode is None:
        args.quant_mode = "cache" if args.mode == "generate" else "int8"
    args.int8 = args.quant_mode == "int8"
    args.int8_cache_only = args.quant_mode == "cache"
    if args.batch is None:
        args.batch = 32 if args.with_encoder else 128
    if args.decode_buckets is None:
        args.decode_buckets = 2 if args.mode == "long" else 8
    return args


def bench_device(args) -> torch.device:
    """The card (``resolve_device``: raises without CUDA) unless
    ``--platform cpu``."""
    from vaura_tpu_torch.utils import resolve_device

    return resolve_device("cpu" if args.platform == "cpu" else None)


def device_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    from vaura_tpu_torch.profile_generate import nvidia_smi

    return nvidia_smi().splitlines()[device.index or 0]


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _sync_read(out: torch.Tensor):
    """The result on the host: the call's end."""
    return out.item() if out.ndim == 0 else out.cpu()


def _timed(call: Callable[[int], torch.Tensor], iters: int,
           name: str = "") -> list:
    """One warm-up call with seed 2 (kernels build there), then ``iters``
    calls with seeds 3, 4, ..., each timed to its result on the host; with
    a ``name``, a ``#`` line of every timed call's seconds."""
    _sync_read(call(2))
    times = []
    for i in range(iters):
        t0 = time.perf_counter()
        _sync_read(call(3 + i))
        times.append(time.perf_counter() - t0)
    if name:
        print(f"# {name}: timed calls " + ", ".join(f"{t:.3f}" for t in times)
              + " s", flush=True)
    return times


def _quant_overrides(args) -> dict:
    """The sampler fields of the quant mode."""
    if args.quant_mode == "none":
        return {}
    return {"quantize_cache": True, "quantize_weights": args.int8,
            "cache_bits": args.cache_bits, "int8_dots": args.int8_dots}


def _bf16_codec(overrides: dict):
    from vaura_tpu_torch.models.dac.model import config_for_sample_rate

    return overrides.get("dac") or dataclasses.replace(
        config_for_sample_rate(44100), dtype=torch.bfloat16)


def _emit(result: dict, device: torch.device) -> dict:
    result["device"] = device_label(device)
    print(json.dumps(result), flush=True)
    return result


# --------------------------------------------------------------------------
# generate
# --------------------------------------------------------------------------
def make_generate(system, args) -> Callable:
    """The timed function of generate mode: ``generate(vis_feats, generator,
    frames=None)`` runs frames (when given) through the visual encoder, then
    the conditioning, the pattern, ``generate_tokens`` (sampling unless
    ``--greedy``, top-k, CFG, decode buckets), the reverted codes clipped to
    the codebook, and the DAC decode; it returns ``sum(|audio|)`` as a 0-d
    float32 tensor, or the codes ``[B, K, tokens]`` under ``--no-dac``."""
    from vaura_tpu_torch.models.vaura import UNKNOWN_TOKEN

    pattern, valid_mask, S = system.prepare_generation(args.tokens)
    use_cfg = args.cfg_scale > 1.0
    d_codebook = system.sampler_config.d_codebook

    @torch.no_grad()
    def generate(vis_feats: torch.Tensor, generator: torch.Generator,
                 frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        if frames is not None:
            vis_feats = system.visual_features(frames,
                                               chunk_size=args.encoder_chunk)
        B = vis_feats.shape[0]
        cond_seq = system.build_cond_seq_for_generation(
            vis_feats, S, tokens_per_frame=TOKENS_PER_FRAME, cfg=use_cfg)
        gen_seq = torch.full((B, system.num_codebooks, args.tokens),
                             UNKNOWN_TOKEN, dtype=torch.long,
                             device=system.device)
        gen_seq, _, _ = pattern.build_pattern_sequence(
            gen_seq, system.special_token_id)
        gen_seq = system.generate_tokens(
            cond_seq, gen_seq, generator, S=S, valid_mask=valid_mask,
            use_sampling=not args.greedy, temp=1.0, top_k=args.top_k,
            cfg_scale=args.cfg_scale, decode_buckets=args.decode_buckets)
        codes, _, _ = pattern.revert_pattern_sequence(gen_seq, UNKNOWN_TOKEN)
        codes = codes[..., :args.tokens].clamp(0, d_codebook - 1)
        if args.no_dac:
            return codes
        # the batch decoded in slices only where its activations would not
        # fit beside the rest; a checksum, not the waveform, comes back
        audio = system.decode_audio(codes, chunk_size=32 if B >= 144 else None)
        return audio.float().abs().sum()

    return generate


def bench_generate(args, *, device: Optional[torch.device] = None,
                   overrides: Optional[dict] = None) -> dict:
    """Generate mode. ``overrides`` (tests: a tiny configuration) may hold
    ``sampler`` and ``encoder`` (fields replaced in the flagship
    configurations), ``dac`` (a ``DacConfig``) and ``frames`` (one clip's
    frames shape)."""
    from vaura_tpu_torch.flagship import FRAMES_SHAPE, flagship_system

    ov = overrides or {}
    device = device or bench_device(args)
    system = flagship_system(
        device, _generator(device, 0), sampler_layers=args.layers,
        sampler_overrides={**ov.get("sampler", {}), **_quant_overrides(args)},
        encoder_overrides=ov.get("encoder"), dac_config=_bf16_codec(ov),
        encoder=args.with_encoder,
        quantize_encoder=args.with_encoder and args.int8_encoder)
    B = args.batch
    vis_feats = torch.randn(B, FEATURE_ROWS, system.sampler_config.cond_in_dim,
                            generator=_generator(device, 1), device=device)
    frames = None
    if args.with_encoder:  # 2.56 s: 4 segments x 16 frames at 224^2
        frames = torch.randn(B, *ov.get("frames", FRAMES_SHAPE),
                             generator=_generator(device, 8), device=device,
                             dtype=torch.bfloat16)
    generate = make_generate(system, args)
    times = _timed(lambda seed: generate(vis_feats, _generator(device, seed),
                                         frames), args.iters, "generate")
    value = B * args.tokens / TOKENS_PER_SECOND / min(times)
    return _emit({
        "metric": ("frames_to_audio_sec_per_sec_per_chip"
                   if args.with_encoder else "audio_sec_per_sec_per_chip"),
        "value": round(value, 3),
        "unit": "audio_sec/sec/chip",
        "vs_baseline": round(value / TARGET_AUDIO_SEC_PER_SEC, 3),
        "quant_mode": args.quant_mode,
        "batch": B,
    }, device)


# --------------------------------------------------------------------------
# encoder
# --------------------------------------------------------------------------
def bench_encoder(args, *, device: Optional[torch.device] = None,
                  overrides: Optional[dict] = None) -> dict:
    """Encoder mode: the flagship MotionFormer (bf16 weights; ``--layers``
    its depth, ``--int8-encoder`` the int8 encoder from the same seeded
    weights) over batches of 1, 8, 16 and 32 clips."""
    from vaura_tpu_torch.flagship import FRAMES_SHAPE
    from vaura_tpu_torch.models.motionformer import MotionFormer, MotionFormerConfig
    from vaura_tpu_torch.ops.quantization import quantize_encoder_params
    from vaura_tpu_torch.utils import seeded_init_

    ov = overrides or {}
    device = device or bench_device(args)
    cfg = dataclasses.replace(MotionFormerConfig(), param_dtype=torch.bfloat16,
                              **ov.get("encoder", {}))
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, depth=args.layers)
    model = seeded_init_(MotionFormer(cfg, device), _generator(device, 0))
    if args.int8_encoder:
        q_model = MotionFormer(dataclasses.replace(cfg, quantize=True), device)
        q_model.load_state_dict(quantize_encoder_params(model.state_dict()))
        model = q_model
    model.requires_grad_(False)

    @torch.no_grad()
    def feats(frames):
        return model(frames).float().abs().sum()

    results = {}
    for B in ENCODER_BATCHES:
        frames = torch.randn(B, *ov.get("frames", FRAMES_SHAPE),
                             generator=_generator(device, 1), device=device,
                             dtype=torch.bfloat16)
        times = _timed(lambda seed: feats(frames), args.iters)
        ms_per_clip = min(times) / B * 1e3
        results[B] = round(ms_per_clip, 2)
        print(f"# encoder B={B}: {ms_per_clip:.2f} ms/clip "
              f"({min(times) * 1e3:.1f} ms/batch)", flush=True)
    best = min(results.values())
    return _emit({
        "metric": "encoder_ms_per_clip",
        "value": best,
        "unit": "ms/clip",
        "vs_baseline": round(SECONDS_PER_CLIP * 1e3 / best, 2),
        "sweep": results,
    }, device)


# --------------------------------------------------------------------------
# long
# --------------------------------------------------------------------------
def bench_long(args, *, device: Optional[torch.device] = None,
               overrides: Optional[dict] = None) -> dict:
    """Long mode: ``--duration`` seconds a clip from features ``[B,
    ceil(duration / 0.64), 8, cond_in_dim]``; the first chunk generates the
    full window, each later one carries the last (window - stride) tokens as
    a prompt (``generate_long``), or one decode runs over a rolling cache of
    ``--window-chunks`` x ``--chunk-steps`` (``--long-kv``, whose RoPE table
    is raised to cover the horizon). The waveform is decoded in slices."""
    from vaura_tpu_torch.flagship import flagship_system
    from vaura_tpu_torch.models.sampler import SamplerConfig

    ov = overrides or {}
    device = device or bench_device(args)
    sampler = {**ov.get("sampler", {}), **_quant_overrides(args)}
    if args.long_kv:
        need = int(args.duration * TOKENS_PER_SECOND) + 64
        base = dataclasses.replace(SamplerConfig(), **ov.get("sampler", {}))
        sampler["block_size_audio"] = max(base.block_size_audio, need)
    system = flagship_system(device, _generator(device, 0),
                             sampler_overrides=sampler,
                             dac_config=_bf16_codec(ov), encoder=False)
    B = args.batch
    total_tokens = int(args.duration * TOKENS_PER_SECOND)
    stride_tokens = int(args.stride * TOKENS_PER_SECOND)
    n_seg = math.ceil(args.duration / SEGMENT_SECONDS)
    feats = torch.randn(B, n_seg, SEGMENT_ROWS,
                        system.sampler_config.cond_in_dim,
                        generator=_generator(device, 1), device=device)
    # decode slices that each carry about 8 clips of 2.56 s
    dac_chunk = max(1, int(8 * SECONDS_PER_CLIP / args.duration * 4))
    kw = dict(total_tokens=total_tokens, vis_feats_segments=feats,
              decode_to_audio=True, dac_chunk_size=dac_chunk, temp=1.0,
              top_k=args.top_k, cfg_scale=args.cfg_scale)
    if args.long_kv:
        kw.update(window_chunks=args.window_chunks,
                  chunk_steps=args.chunk_steps, sink_chunks=args.sink_chunks)
        fn = system.generate_long_kv
    else:
        kw.update(stride_tokens=stride_tokens,
                  decode_buckets=args.decode_buckets)
        fn = system.generate_long

    def run(seed):
        out = fn(None, generator=_generator(device, seed), **kw)
        return out["audio"].float().abs().sum()

    times = _timed(run, args.iters, "long")
    p50 = float(np.median(times))
    value = B * args.duration / min(times)
    return _emit({
        "metric": "long_audio_sec_per_sec_per_chip",
        "value": round(value, 3),
        "unit": "audio_sec/sec/chip",
        "vs_baseline": round(value / TARGET_AUDIO_SEC_PER_SEC, 3),
        "duration_s": args.duration,
        "stride_s": args.stride,
        "long_kv": bool(args.long_kv),
        "batch": B,
        "p50_batch_seconds": round(p50, 3),
        "p50_latency_per_clip_s": round(p50, 3),
    }, device)


# --------------------------------------------------------------------------
# train
# --------------------------------------------------------------------------
def train_model_flops(n_params: int, num_layers: int, d_model: int,
                      batch: int, seq: int) -> int:
    """Analytic model FLOPs of one train step: the 6 N T transformer count
    plus the attention's quadratic term 12 L d S^2, per sequence (remat's
    recompute and the DAC encode excluded)."""
    attn_quad = 12 * num_layers * d_model * seq * seq
    return 6 * n_params * batch * seq + attn_quad * batch


def build_train(args, *, device: torch.device,
                overrides: Optional[dict] = None):
    """Train mode's system (the flagship sampler with float32 parameters, no
    visual encoder: features come in, the frozen float32 codec), its
    ``TrainState`` (AdamW at 1e-4, ``--mu-dtype``/``--nu-dtype``), the step
    and one batch: audio ``[B, 1, 112896]`` of amplitude 0.1 (or random
    codes under ``--precomputed-codes``) and features ``[B, 32,
    cond_in_dim]``. B is ``--batch`` up to 64, else 12. Returns ``(system,
    state, step, batch, tokens)``, ``tokens`` the codec frames a clip."""
    from vaura_tpu_torch.flagship import flagship_system
    from vaura_tpu_torch.train.state import TrainState, make_optimizer
    from vaura_tpu_torch.train.steps import make_train_step, split_params

    ov = overrides or {}
    B = args.batch if args.batch <= 64 else TRAIN_BATCH
    system = flagship_system(
        device, _generator(device, 0), training=True, encoder=False,
        sampler_overrides={**ov.get("sampler", {}), "remat": not args.no_remat,
                           "remat_policy": args.remat_policy},
        dac_config=ov.get("dac"))
    trainable, _ = split_params(system)
    state = TrainState.create(trainable, make_optimizer(
        1e-4, mu_dtype=args.mu_dtype, nu_dtype=args.nu_dtype))
    samples = ov.get("train_audio_samples", TRAIN_AUDIO_SAMPLES)
    tokens = -(-samples // system.dac.cfg.hop_length)
    rng = np.random.default_rng(0)
    cfg = system.sampler_config
    if args.precomputed_codes:
        batch = {"codes": rng.integers(0, cfg.d_codebook,
                                       (B, cfg.num_codebooks, tokens))}
    else:
        batch = {"audio": (rng.standard_normal((B, 1, samples)) * 0.1
                           ).astype(np.float32)}
    batch["vis_feats"] = rng.standard_normal(
        (B, FEATURE_ROWS, cfg.cond_in_dim)).astype(np.float32)
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    return system, state, make_train_step(system), batch, tokens


def bench_train(args, *, device: Optional[torch.device] = None,
                overrides: Optional[dict] = None) -> dict:
    """Train mode (``build_train``): codec tokens a second and the model
    FLOPs utilisation (``train_model_flops`` over the step time, against
    the H100's dense bf16 peak; null on the CPU) with its analytic HFU."""
    device = device or bench_device(args)
    system, state, step, batch, seq = build_train(args, device=device,
                                                  overrides=overrides)
    B = next(iter(batch.values())).shape[0]
    holder = {"state": state}

    def call(seed):
        holder["state"], metrics = step(holder["state"], batch,
                                        _generator(device, seed - 1))
        return metrics["loss"]

    times = _timed(call, args.iters)  # generators 1, 2, 3, ...
    dt = min(times)
    value = B * seq / dt
    n_params = sum(p.numel() for p in holder["state"].params.values())
    cfg = system.sampler_config
    model_flops = train_model_flops(n_params, cfg.num_layers, cfg.d_model, B,
                                    seq)
    # HFU (analytic): 6N a step splits 2N forward + 4N backward; full remat
    # recomputes the forward in the backward (+2N -> 8/6), the dots
    # policies save the products (~6/6)
    remat_mult = (8.0 / 6.0 if (not args.no_remat
                                and args.remat_policy is None) else 1.0)
    mfu = (model_flops / dt / H100_BF16_PEAK if device.type == "cuda"
           else None)
    if mfu is not None:
        print(f"# train MFU {mfu * 100:.1f}% (model {model_flops / 1e12:.2f} "
              f"TFLOP/step over {n_params / 1e6:.0f}M params, {dt * 1e3:.0f} "
              f"ms), HFU {mfu * remat_mult * 100:.1f}% (analytic, remat "
              f"x{remat_mult:.2f})", flush=True)
    else:
        print(f"# train MFU not measured on the CPU (model "
              f"{model_flops / 1e12:.4f} TFLOP/step over {n_params / 1e6:.2f}M "
              f"params, {dt * 1e3:.0f} ms)", flush=True)
    return _emit({
        "metric": "train_codec_tokens_per_sec_per_chip",
        "value": round(value, 1),
        "unit": "tokens/sec/chip",
        "vs_baseline": round(B / TRAIN_BATCH / dt, 3),
        "mfu": None if mfu is None else round(mfu, 4),
    }, device)


MODES = {"generate": bench_generate, "long": bench_long, "train": bench_train,
         "encoder": bench_encoder}


def main(argv=None, *, overrides: Optional[dict] = None) -> dict:
    """Parse ``argv``, run the mode, print its JSON line and return it as a
    dict. ``overrides``: a tiny configuration (see ``bench_generate``;
    ``train_audio_samples`` for train mode), for tests."""
    args = resolve_args(build_parser().parse_args(argv))
    if args.compilation_cache_dir:
        logger.warning("--compilation-cache-dir %s ignored: the port "
                       "compiles nothing", args.compilation_cache_dir)
    device = bench_device(args)
    return MODES[args.mode](args, device=device, overrides=overrides)


if __name__ == "__main__":
    main(sys.argv[1:])
