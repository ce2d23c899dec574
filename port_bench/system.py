"""The program under test, built from a configuration file as its entry
points build it (``models.factory.build_system``), with weights made from
the run's seed, and checked against the widths the file states."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from port_bench import weights as W
from port_bench.reference import dac as ref_dac
from port_bench.reference import encoder as ref_encoder
from port_bench.reference import sampler as ref_sampler

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

PARTS = (("sampler", ref_sampler), ("dac", ref_dac), ("encoder", ref_encoder))


def model_cfg(config: dict, *, encoder: bool) -> dict:
    """The ``model`` block ``build_system`` reads, from the file's widths."""
    target = "vaura_tpu_torch.models."
    return {
        "sampler_config": {"target": target + "sampler.SamplerSpec",
                           "params": config["sampler"]},
        "audio_encoder_config": {"target": target + "dac.model.DacSpec",
                                 "params": config["codec"]},
        "feature_extractor_config": (
            {"target": target + "motionformer.MotionFormerSpec",
             "params": config["encoder"]} if encoder else None),
        "pattern_provider_config": {
            "target": "vaura_tpu_torch.ops.patterns.DelayedPatternProvider",
            "params": config["pattern"]},
        "freeze_feature_extractor": config.get("freeze_feature_extractor",
                                               True),
    }


def part_config(config: dict, part: str) -> dict:
    return {"sampler": config["sampler"], "dac": config["codec"],
            "encoder": config.get("encoder", {})}[part]


def build(config: dict, device: torch.device, seed: int, *, encoder: bool,
          training: bool = False, sampler_overrides: Dict = None,
          codec_dtype: str = None, quantize_encoder: bool = False
          ) -> Tuple[object, Dict[str, Dict[str, torch.Tensor]]]:
    """``(system, weights)``: the program's ``VauraSystem`` and the
    benchmark's weights by part (``sampler``, ``dac``, ``encoder``), which
    were loaded into it. ``training`` keeps float32 parameters (the
    recipe); otherwise the matmul weights are served in
    ``config["dtypes"]["params"]``. ``sampler_overrides``,
    ``codec_dtype`` and ``quantize_encoder`` make a control: the program
    with a lower-precision path of its own switched on."""
    from vaura_tpu_torch.models.factory import build_system
    from vaura_tpu_torch.ops.quantization import (
        quantize_encoder_params,
        quantize_sampler_params,
    )

    dt = config["dtypes"]
    param_dtype = None if training else DTYPES[dt["params"]]
    cfg = model_cfg(config, encoder=encoder)
    if codec_dtype:
        cfg["audio_encoder_config"]["params"] = {
            **config["codec"], "dtype": DTYPES[codec_dtype]}
    system = build_system(cfg, device=device, param_dtype=param_dtype)
    made: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, (part, ref) in enumerate(PARTS):
        module = getattr(system, part, None)
        if module is None:
            continue
        specs = ref.param_specs(part_config(config, part))
        dtypes = W.storage_dtypes(module)
        missing = sorted({n for n, _, _ in specs} - set(dtypes))
        if missing:
            raise ValueError(f"{part}: the program has no {missing[:3]}")
        made[part] = W.make(specs, dtypes, W.generator(device, seed, k), device)
        module.load_state_dict(made[part], strict=True)
    check_widths(system, config)
    q_weights = bool((sampler_overrides or {}).get("quantize_weights"))
    if sampler_overrides:
        from vaura_tpu_torch.models.sampler import Sampler

        s_cfg = dataclasses.replace(system.sampler_config, **sampler_overrides)
        sampler = Sampler(s_cfg, device)
        sd = system.sampler.state_dict()
        sampler.load_state_dict(quantize_sampler_params(sd) if q_weights else sd)
        system.sampler, system.sampler_config = sampler, s_cfg
    if quantize_encoder:
        from vaura_tpu_torch.models.motionformer import MotionFormer

        q_enc = MotionFormer(dataclasses.replace(system.encoder.cfg,
                                                 quantize=True), device)
        q_enc.load_state_dict(quantize_encoder_params(system.encoder.state_dict()))
        system.encoder = q_enc
    if not training:
        system.requires_grad_(False)
    return system, made


def check_widths(system, config: dict) -> None:
    """The built model against the file: parameter counts, layers, heads,
    widths. Raises ``ValueError`` on a difference."""
    want = config["expect"]
    s = system.sampler_config
    got = {"sampler_params": sum(p.numel() for p in system.sampler.parameters()),
           "sampler_layers": s.num_layers, "sampler_heads": s.nhead,
           "sampler_d_model": s.d_model, "sampler_ffn_hidden": s.ffn_hidden_dim,
           "codebooks": s.num_codebooks, "codebook_size": s.d_codebook,
           "dac_params": sum(p.numel() for p in system.dac.parameters())}
    if system.encoder is not None:
        e = system.encoder.cfg
        got.update({"encoder_params": sum(p.numel()
                                          for p in system.encoder.parameters()),
                    "encoder_depth": e.depth, "encoder_heads": e.num_heads,
                    "encoder_dim": e.embed_dim})
    bad = {k: (got[k], want[k]) for k in got if k in want and got[k] != want[k]}
    if bad:
        raise ValueError(f"built model differs from the configuration: {bad}")
