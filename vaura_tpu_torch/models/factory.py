"""Config -> VauraSystem assembly.

Counterpart of ``vaura_tpu/models/factory.py``: consumes the ``model``
config block (``configs/vaura_defaults.yaml``: ``sampler_config`` /
``audio_encoder_config`` / ``feature_extractor_config`` /
``visual_bridge_config`` / ``pattern_provider_config`` as ``{target,
params}`` dicts, plus the flat flags) and builds the port's system.
Reference-style target strings resolve through the registry aliases
(``vaura_tpu_torch.config.registry``), so configs written for the reference
or for the JAX package work unchanged.

``flatten_vis_feats`` is read by the Trainer (``train/loop.py``: the
length of its predict-media generation) and, through the config defaults,
by the datamodules (``partition_audio_to_clips``); the system does not keep
it. ``lora_rank``, ``lora_target_modules`` (the reference's key name) and
``lora_alpha`` give the system LoRA adapters on its sampler
(``train/lora.py``); ``lora_finetune_feature_extractor`` is accepted with a
warning, as in the JAX package: LoRA targets the sampler only.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from vaura_tpu_torch.config import instantiate_from_config
from vaura_tpu_torch.models.dac.model import DacConfig
from vaura_tpu_torch.models.motionformer import MotionFormerConfig
from vaura_tpu_torch.models.sampler import SamplerConfig
from vaura_tpu_torch.models.vaura import VauraSystem
from vaura_tpu_torch.utils import DeviceLike

logger = logging.getLogger(__name__)

_PRECISION = {
    "bf16": torch.bfloat16,
    "16-mixed": torch.bfloat16,
    "f32": torch.float32,
    "32": torch.float32,
    32: torch.float32,
}


def build_system(
    model_cfg: Dict[str, Any],
    precision: Optional[str] = None,
    device: DeviceLike = None,
    param_dtype: Optional[torch.dtype] = None,
) -> VauraSystem:
    """Reference ``VAURAModel.__init__`` wiring (``vaura_model.py:28-122``)
    as a factory. ``precision``: 'bf16' (default) or 'f32' sets the compute
    dtype of the sampler, encoder and codec. ``param_dtype`` sets the
    storage of the sampler's and encoder's matmul weights (float32 by
    default, what training updates; bf16 for a system that only
    generates). ``device``: ``resolve_device``'s rule."""
    use_vis = model_cfg.get("use_visual_conditioning", True)
    dtype = _PRECISION.get(precision) if precision is not None else None
    store = {} if param_dtype is None else {"param_dtype": param_dtype}

    sampler_spec = instantiate_from_config(model_cfg["sampler_config"])
    assert isinstance(sampler_spec, SamplerConfig), type(sampler_spec)
    if dtype is not None:
        sampler_spec = dataclasses.replace(sampler_spec, dtype=dtype)
    sampler_spec = dataclasses.replace(sampler_spec, **store)

    dac_spec = instantiate_from_config(model_cfg["audio_encoder_config"])
    dac_config = getattr(dac_spec, "config", dac_spec)
    assert isinstance(dac_config, DacConfig), type(dac_config)
    if dtype is not None:
        dac_config = dataclasses.replace(dac_config, dtype=dtype)
    # The reference Transformer derives its factored-embedding entry dim
    # from the frozen codec at initialize_embeddings time (llama.py:387-412)
    # — sampler configs (and Lightning hparams) never carry codebook_dim,
    # so sync it from the codec spec here.
    if sampler_spec.codebook_dim != dac_config.codebook_dim:
        sampler_spec = dataclasses.replace(
            sampler_spec, codebook_dim=dac_config.codebook_dim)

    encoder_config: Optional[MotionFormerConfig] = None
    if use_vis and model_cfg.get("feature_extractor_config") is not None:
        enc = instantiate_from_config(model_cfg["feature_extractor_config"])
        assert isinstance(enc, MotionFormerConfig), type(enc)
        if dtype is not None:
            enc = dataclasses.replace(enc, dtype=dtype)
        encoder_config = dataclasses.replace(enc, **store)

    bridge = None
    if use_vis and model_cfg.get("visual_bridge_config") is not None:
        bridge = instantiate_from_config(model_cfg["visual_bridge_config"])

    pattern_provider = None
    if model_cfg.get("pattern_provider_config") is not None:
        pp_cfg = dict(model_cfg["pattern_provider_config"])
        # reference double-checks n_q against the sampler
        # (vaura_model.py:699-714)
        pp_params = dict(pp_cfg.get("params") or {})
        if pp_params.get("n_q") != sampler_spec.num_codebooks:
            pp_params["n_q"] = sampler_spec.num_codebooks
            pp_cfg["params"] = pp_params
        pattern_provider = instantiate_from_config(pp_cfg)

    lora_targets = model_cfg.get("lora_target_modules")
    if model_cfg.get("lora_finetune_feature_extractor"):
        logger.warning(
            "lora_finetune_feature_extractor is accepted for config "
            "compatibility (reference scripts/test.py:63-65) but LoRA "
            "targets the sampler only")
    return VauraSystem(
        sampler_config=sampler_spec,
        dac_config=dac_config,
        encoder_config=encoder_config,
        pattern_provider=pattern_provider,
        bridge=bridge,
        use_visual_conditioning=use_vis,
        freeze_feature_extractor=model_cfg.get("freeze_feature_extractor",
                                               False),
        device=device,
        lora_rank=int(model_cfg.get("lora_rank", 0) or 0),
        lora_targets=tuple(lora_targets) if lora_targets else None,
        lora_alpha=model_cfg.get("lora_alpha"),
    )


def maybe_load_pretrained(system: VauraSystem,
                          model_cfg: Dict[str, Any]) -> VauraSystem:
    """Load pretrained frozen-submodule weights referenced by the config,
    in place: ``audio_encoder_config.params.ckpt_path`` (DAC) and
    ``feature_extractor_config.params.ckpt_path`` (AVCLIP/MotionFormer),
    each a raw torch checkpoint file converted on the fly, or a directory
    of this package's checkpoint format (``train/checkpoint.py``) holding
    the submodule's parameters under their ``dac.`` / ``encoder.`` names,
    as ``CheckpointManager.save_frozen`` writes them. A directory without
    ``state.pt`` (an orbax tree of the JAX package's
    ``scripts/convert_checkpoints.py``), or without a name of the
    submodule, raises ``ValueError``. Other failures are logged and leave
    the weights as they are, as in the JAX package."""
    from vaura_tpu_torch.models import convert as C
    from vaura_tpu_torch.train.checkpoint import load_state

    for cfg_key, name in (("audio_encoder_config", "dac"),
                          ("feature_extractor_config", "encoder")):
        sub = model_cfg.get(cfg_key) or {}
        ckpt_path = (sub.get("params") or {}).get("ckpt_path")
        module = getattr(system, name)
        if not ckpt_path or module is None:
            continue
        path = Path(ckpt_path)
        sd = None
        if path.is_dir():  # this package's format; an orbax tree raises
            prefix = f"{name}."
            params = load_state(path)
            params = params.get("params", params)
            sd = {k[len(prefix):]: v for k, v in params.items()
                  if k.startswith(prefix)}
            if not sd:
                raise ValueError(f"{path} holds no parameter named "
                                 f"{prefix}*")
        try:
            if sd is None:
                ckpt = torch.load(path, map_location="cpu",
                                  weights_only=False)
                sd = ckpt.get("state_dict", ckpt.get("model_state", ckpt))
                if name == "dac":
                    sd = C.convert_dac_state_dict(sd)
                else:
                    sd = C.convert_motionformer_state_dict(
                        C.strip_avclip_prefix(sd))
            system.load_state_dicts({name: sd})
            logger.info("loaded pretrained %s from %s", name, ckpt_path)
        except Exception as e:  # noqa: BLE001 — as the JAX package: warn
            logger.warning("could not load pretrained %s from %s: %s",
                           name, ckpt_path, e)
    return system
