"""The trained proxy that the quantization-quality scripts measure
(``int8_margin_check.py``, ``quant_quality_fad.py``): the sampler overfit
on one fixed batch of random codes and visual features, so that its logit
margins are a trained model's on its training distribution.

Counterpart of the recipe both JAX scripts share (``scripts/
int8_margin_check.py`` and ``scripts/quant_quality_fad.py``): the flagship
sampler (24 layers x 1536, ``remat``) or ``mid`` (6 x 512, 8 heads) or
``tiny`` (2 x 192, 4 heads; a logic check only), AdamW at ``lr`` with the
defaults of ``make_optimizer``, codes ``[batch, 9, tokens]`` in [0, 1024)
and features ``[batch, 32, 768]`` from ``numpy.random.default_rng(0)``, no
encoder, the 44.1 kHz codec's geometry. The weights start from a seeded
initialisation (``seeded_init_``) with the zero ``lm_head`` of the JAX
package; the dropout masks come from a generator seeded per step. The
arms then share one system whose sampler is swapped (``use_arm``): bf16
weights (every float rounded to bf16, as the JAX scripts' ``cast_floats``),
or int8 weights quantized from the float32 ones (scales rounded to bf16 as
well), over the bf16 cache or a quantized one.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Tuple

import numpy as np
import torch

from vaura_tpu_torch.models.dac.model import config_for_sample_rate
from vaura_tpu_torch.models.sampler import Sampler, SamplerConfig
from vaura_tpu_torch.models.vaura import VauraSystem
from vaura_tpu_torch.ops.quantization import quantize_sampler_params
from vaura_tpu_torch.train.state import TrainState, make_optimizer
from vaura_tpu_torch.train.steps import make_train_step, split_params
from vaura_tpu_torch.utils import seeded_init_

_PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def proxy_device(platform) -> torch.device:
    """``--platform`` (``cpu``, ``gpu`` or ``cuda``), else CUDA, which
    raises when absent."""
    if platform is None:
        from vaura_tpu_torch.utils import resolve_device

        return resolve_device(None)
    if str(platform).lower() not in _PLATFORMS:
        raise ValueError(f"--platform {platform!r}: one of {sorted(_PLATFORMS)}")
    return torch.device(_PLATFORMS[str(platform).lower()])


def proxy_config(tiny: bool, mid: bool) -> SamplerConfig:
    """The sampler that is overfit: flagship, ``mid`` or ``tiny``."""
    cfg = SamplerConfig(remat=True, param_dtype=torch.float32)
    if tiny:
        return dataclasses.replace(cfg, num_layers=2, d_model=192, nhead=4,
                                   block_size_audio=64)
    if mid:
        return dataclasses.replace(cfg, num_layers=6, d_model=512, nhead=8)
    return cfg


def overfit(sampler_cfg: SamplerConfig, device, *, steps: int, batch: int,
            lr: float, tokens: int
            ) -> Tuple[VauraSystem, Dict[str, torch.Tensor], dict]:
    """Train the proxy for ``steps`` steps on its fixed batch. Returns the
    system, the trained sampler's float32 state dict and ``{"codes",
    "vis", "loss0", "loss", "seconds", "step_ms"}``."""
    system = VauraSystem(sampler_cfg, config_for_sample_rate(44100), None,
                         device=device)
    seeded_init_(system.sampler, torch.Generator(device).manual_seed(0))
    torch.nn.init.zeros_(system.sampler.lm_head.weight)
    rngb = np.random.default_rng(0)
    codes = torch.as_tensor(rngb.integers(0, 1024, (batch, 9, tokens)),
                            device=device)
    vis = torch.as_tensor(rngb.standard_normal((batch, 32, 768)).astype(
        np.float32), device=device)
    trainable = {k: v for k, v in split_params(system)[0].items()
                 if k.startswith("sampler.")}
    state = TrainState.create(trainable, make_optimizer(lr))
    step = make_train_step(system)
    losses = []
    t0 = time.time()
    for i in range(steps):
        state, m = step(state, {"codes": codes, "vis_feats": vis},
                        torch.Generator(device).manual_seed(10 + i))
        losses.append(m["loss"])
    losses = [float(x) for x in losses]
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.time() - t0
    trained = {k: v.detach().float().clone()
               for k, v in system.sampler.state_dict().items()}
    system.sampler.requires_grad_(False)
    return system, trained, {
        "codes": codes, "vis": vis, "loss0": losses[0] if losses else None,
        "loss": losses[-1] if losses else None, "losses": losses,
        "seconds": seconds, "step_ms": 1e3 * seconds / max(steps, 1)}


def use_arm(system: VauraSystem, sampler_cfg: SamplerConfig,
            trained: Dict[str, torch.Tensor], *, quantize_weights=False,
            quantize_cache=False, cache_bits=8, int8_dots=False) -> None:
    """Give ``system`` the inference sampler of one arm: no remat or
    dropout, bf16 weights, or int8 ones (``quantize_weights``), and the
    cache of ``quantize_cache``/``cache_bits``/``int8_dots``."""
    cfg = dataclasses.replace(
        sampler_cfg, remat=False, dropout=0.0, param_dtype=torch.bfloat16,
        quantize_weights=quantize_weights, quantize_cache=quantize_cache,
        cache_bits=cache_bits if quantize_cache else 8,
        int8_dots=int8_dots)
    sd = quantize_sampler_params(trained) if quantize_weights else trained
    sd = {k: v.to(torch.bfloat16).float() if v.is_floating_point() else v
          for k, v in sd.items()}
    sampler = Sampler(cfg, system.device)
    sampler.load_state_dict(sd)
    sampler.requires_grad_(False)
    system.sampler, system.sampler_config = sampler, cfg
