"""The flagship configuration of the generation path, with seeded random
weights made on the target device.

  sampler  SamplerConfig(): 24 layers, d=1536, 16 heads (hd=96), 9 codebooks
           of 1024, bf16 compute and cache
  encoder  MotionFormerConfig(): divided ViT-B/16, D=768, 12 heads, 12
           blocks, t=8, hw=196, bf16
  codec    config_for_sample_rate(44100): hop 512, float32
  pattern  DelayedPatternProvider(9)

The generation settings of the flagship run (``GENERATE_KW``) are CFG 6.0,
top-k 128, 221 new tokens at 7 tokens per video frame, from frames
``[B, 4, 3, 16, 224, 224]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vaura_tpu_torch.models.dac.model import config_for_sample_rate
from vaura_tpu_torch.models.motionformer import MotionFormerConfig
from vaura_tpu_torch.models.sampler import SamplerConfig
from vaura_tpu_torch.models.vaura import VauraSystem
from vaura_tpu_torch.utils import DeviceLike, seeded_init_

GENERATE_KW = dict(cfg_scale=6.0, top_k=128, max_new_tokens=221,
                   tokens_per_frame=7)
FRAMES_SHAPE = (4, 3, 16, 224, 224)  # per clip: segments, C, T, H, W


def flagship_system(device: DeviceLike = None,
                    generator: Optional[torch.Generator] = None,
                    sampler_layers: Optional[int] = None,
                    encoder_depth: Optional[int] = None) -> VauraSystem:
    """The flagship system; ``sampler_layers``/``encoder_depth`` cut depth
    only. With a ``generator`` the weights are drawn from it
    (``utils.seeded_init_``); without one they are left for
    ``load_state_dicts``."""
    s_cfg, e_cfg = SamplerConfig(), MotionFormerConfig()
    if sampler_layers:
        s_cfg = dataclasses.replace(s_cfg, num_layers=sampler_layers)
    if encoder_depth:
        e_cfg = dataclasses.replace(e_cfg, depth=encoder_depth)
    system = VauraSystem(s_cfg, config_for_sample_rate(44100), e_cfg,
                         device=device)
    if generator is not None:
        seeded_init_(system, generator)
    return system


def random_frames(batch: int, generator: torch.Generator,
                  device: DeviceLike = None) -> torch.Tensor:
    """Seeded bf16 frames ``[batch, 4, 3, 16, 224, 224]``."""
    return torch.randn(batch, *FRAMES_SHAPE, generator=generator,
                       device=device, dtype=torch.bfloat16)
