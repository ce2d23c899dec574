"""The flagship configuration, for generation and for training, with seeded
random weights made on the target device.

  sampler  SamplerConfig(): 24 layers, d=1536, 16 heads (hd=96), 9 codebooks
           of 1024, bf16 compute and cache
  encoder  MotionFormerConfig(): divided ViT-B/16, D=768, 12 heads, 12
           blocks, t=8, hw=196, bf16
  codec    config_for_sample_rate(44100): hop 512, float32
  pattern  DelayedPatternProvider(9)

The generation settings of the flagship run (``GENERATE_KW``) are CFG 6.0,
top-k 128, 221 new tokens at 7 tokens per video frame, from frames
``[B, 4, 3, 16, 224, 224]``. The serving modes change the sampler's
configuration: ``quantize_cache`` (the int8 KV cache with bf16 weights, the
JAX package's serving default) and ``quantize_weights`` (int8 matmul
weights, here the quantization of the seeded bf16 weights).

The long-horizon configuration (``bench.py``'s long-mode defaults): 10.24 s
(``LONG_TOKENS``, 880) from frames ``[B, 16, 3, 16, 224, 224]``
(``LONG_SEGMENTS``), ``generate_long`` at a stride of 0.64 s
(``LONG_STRIDE_TOKENS``, 55; chunks of at most 221 tokens), or
``generate_long_kv`` with a window of 4 chunks of 56 steps (``LONG_KV_KW``),
whose RoPE table must cover the horizon: ``LONG_SAMPLER`` raises
``block_size_audio`` to 1024, as ``scripts/generate.py`` does for
``long_mode: stream_kv``.

A system made for generation stores its matmul weights in bf16 and records
no graph. ``training=True`` makes the training configuration: float32
parameters (cast to bf16 at use), an unfrozen encoder, the configurations'
own dropout and stochastic-depth rates, a zero-initialised ``lm_head`` (as
the JAX package initialises it, so the first loss is ``ln 1024``) and the
optimizer of ``configs/vaura_defaults.yaml`` (``TRAIN_KW``,
``LR_SCHEDULER``: AdamW at 1e-3 behind an inverse-sqrt schedule with 3000
warmup steps, value clipping at 1.0). A training batch (``random_train_batch``) is frames
``[B, 4, 3, 16, 224, 224]`` with audio ``[B, 1, 113152]`` (221 codec frames
at hop 512).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vaura_tpu_torch.models.dac.model import DacConfig, config_for_sample_rate
from vaura_tpu_torch.models.motionformer import MotionFormer, MotionFormerConfig
from vaura_tpu_torch.models.sampler import Sampler, SamplerConfig
from vaura_tpu_torch.models.vaura import VauraSystem
from vaura_tpu_torch.ops.quantization import (
    quantize_encoder_params,
    quantize_sampler_params,
)
from vaura_tpu_torch.utils import DeviceLike, seeded_init_

GENERATE_KW = dict(cfg_scale=6.0, top_k=128, max_new_tokens=221,
                   tokens_per_frame=7)
FRAMES_SHAPE = (4, 3, 16, 224, 224)  # per clip: segments, C, T, H, W
TOKENS_PER_SECOND = 86  # codec frames a second
LONG_TOKENS = int(10.24 * TOKENS_PER_SECOND)
LONG_STRIDE_TOKENS = int(0.64 * TOKENS_PER_SECOND)
LONG_SEGMENTS = 16  # 10.24 s of 0.64 s video segments
LONG_KV_KW = dict(window_chunks=4, chunk_steps=56, sink_chunks=0)
LONG_SAMPLER = {"block_size_audio": 1024}
AUDIO_SAMPLES = 221 * 512
# the optimizer of ``configs/vaura_defaults.yaml``
TRAIN_KW = dict(learning_rate=1e-3, weight_decay=0.0, betas=(0.9, 0.95),
                gradient_clip_val=1.0, gradient_clip_algorithm="value",
                accumulate_grad_batches=1)
LR_SCHEDULER = {"target": "InverseSquareRootLRScheduler",
                "params": {"warmup_steps": 3000, "warmup_init_lr": 1e-6}}


def flagship_system(device: DeviceLike = None,
                    generator: Optional[torch.Generator] = None,
                    sampler_layers: Optional[int] = None,
                    encoder_depth: Optional[int] = None,
                    training: bool = False,
                    sampler_overrides: Optional[dict] = None,
                    encoder_overrides: Optional[dict] = None,
                    quantize_encoder: bool = False,
                    dac_config: Optional[DacConfig] = None,
                    encoder: bool = True) -> VauraSystem:
    """The flagship system; ``sampler_layers``/``encoder_depth`` cut depth
    only and the ``*_overrides`` replace fields of the two configurations
    (``{"remat": True}``, dropout rates, the encoder's ``attn_layer``).
    With a ``generator`` the weights are drawn from it
    (``utils.seeded_init_``); without one they are left for
    ``load_state_dicts``. ``quantize_encoder`` makes the int8 encoder
    (``MotionFormerConfig.quantize``) from the seeded bf16 weights, as
    ``sampler_overrides={"quantize_weights": True}`` makes the int8
    sampler. ``dac_config`` replaces the 44.1 kHz codec's configuration
    (the benchmark decodes in bf16); ``encoder=False`` leaves the visual
    encoder out, and the system then takes features. See the module
    docstring for ``training``."""
    store = torch.float32 if training else torch.bfloat16
    s_cfg = dataclasses.replace(SamplerConfig(), param_dtype=store,
                                **(sampler_overrides or {}))
    e_cfg = dataclasses.replace(MotionFormerConfig(), param_dtype=store,
                                **(encoder_overrides or {}))
    if sampler_layers:
        s_cfg = dataclasses.replace(s_cfg, num_layers=sampler_layers)
    if encoder_depth:
        e_cfg = dataclasses.replace(e_cfg, depth=encoder_depth)
    quantize_weights = s_cfg.quantize_weights
    if quantize_weights:
        if training:
            raise ValueError("int8 weights are for inference")
        s_cfg = dataclasses.replace(s_cfg, quantize_weights=False)
    system = VauraSystem(s_cfg, dac_config or config_for_sample_rate(44100),
                         e_cfg if encoder else None,
                         use_visual_conditioning=encoder,
                         freeze_feature_extractor=False, device=device)
    if generator is not None:
        seeded_init_(system, generator)
    if quantize_weights:
        # the same seeded weights, then quantized (without a generator the
        # int8 sampler's buffers wait for load_state_dicts)
        q_cfg = dataclasses.replace(s_cfg, quantize_weights=True)
        sampler = Sampler(q_cfg, system.device)
        if generator is not None:
            sampler.load_state_dict(
                quantize_sampler_params(system.sampler.state_dict()))
        system.sampler, system.sampler_config = sampler, q_cfg
    if quantize_encoder:
        if training:
            raise ValueError("the int8 encoder is for inference")
        q_enc = MotionFormer(dataclasses.replace(e_cfg, quantize=True),
                             system.device)
        if generator is not None:
            q_enc.load_state_dict(
                quantize_encoder_params(system.encoder.state_dict()))
        system.encoder = q_enc
    if training:
        torch.nn.init.zeros_(system.sampler.lm_head.weight)
    else:
        system.requires_grad_(False)
    return system


def flagship_train_state(system: VauraSystem):
    """The ``TrainState`` of the flagship training configuration over
    ``system`` (made with ``training=True``)."""
    from vaura_tpu_torch.train.state import (
        TrainState,
        build_schedule,
        make_optimizer,
    )
    from vaura_tpu_torch.train.steps import split_params

    kw = dict(TRAIN_KW)
    lr = build_schedule(LR_SCHEDULER, kw.pop("learning_rate"))
    trainable, _ = split_params(system)
    return TrainState.create(trainable, make_optimizer(lr, **kw))


def random_train_batch(batch: int, generator: torch.Generator,
                       device: DeviceLike = None) -> dict:
    """Seeded ``{"frames", "audio"}``: bf16 frames and a float32 waveform
    ``[batch, 1, 113152]`` of amplitude about 0.3."""
    audio = 0.3 * torch.randn(batch, 1, AUDIO_SAMPLES, generator=generator,
                              device=device)
    return {"frames": random_frames(batch, generator, device), "audio": audio}


def random_frames(batch: int, generator: torch.Generator,
                  device: DeviceLike = None,
                  segments: int = FRAMES_SHAPE[0]) -> torch.Tensor:
    """Seeded bf16 frames ``[batch, segments, 3, 16, 224, 224]`` (4
    segments: 2.56 s)."""
    return torch.randn(batch, segments, *FRAMES_SHAPE[1:], generator=generator,
                       device=device, dtype=torch.bfloat16)
