"""Component registry + ``instantiate_from_config``.

Counterpart of ``vaura_tpu/config/registry.py``: the ``{target:
dotted.path, params: {...}}`` pattern of the configs, with aliases so that
both the JAX package's target strings (``vaura_tpu.ops.patterns.
DelayedPatternProvider``) and the reference's
(``models.modules.misc.codebook_patterns.DelayedPatternProvider``,
``torch.nn.Identity``, ``torchvision.transforms.v2.Resize``) resolve to the
port's classes.

A target that starts with ``vaura_tpu.`` and has no alias names a part of
the JAX package the port lacks: it raises ``ImportError`` and is never
imported.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Callable[..., Any]] = {}
_JAX_PACKAGE = "vaura_tpu."


def register(name: str, *aliases: str):
    """Register a component under ``name`` (and optional aliases)."""

    def deco(obj):
        _REGISTRY[name] = obj
        for a in aliases:
            _REGISTRY[a] = obj
        return obj

    return deco


def register_alias(name: str, obj: Callable[..., Any]) -> None:
    _REGISTRY[name] = obj


def get_obj_from_target(target: str) -> Callable[..., Any]:
    if target in _REGISTRY:
        return _REGISTRY[target]
    if target.startswith(_JAX_PACKAGE):
        raise ImportError(
            f"{target!r} names a part of the JAX package that the port has no "
            "counterpart for (ROADMAP.md, 'Modules to port')")
    module_name, _, attr = target.rpartition(".")
    if not module_name:
        raise ImportError(f"Cannot resolve target {target!r}")
    module = importlib.import_module(module_name)
    return getattr(module, attr)


def instantiate_from_config(config: dict, **extra_kwargs) -> Any:
    """Instantiate ``config['target']`` with ``config['params']``;
    ``extra_kwargs`` are merged over the config params."""
    if config is None:
        return None
    if "target" not in config:
        raise KeyError(f"Expected key `target` in config, got {config!r}")
    params = dict(config.get("params") or {})
    params.update(extra_kwargs)
    return get_obj_from_target(config["target"])(**params)


def _register_builtin_aliases() -> None:
    """The JAX package's alias table, resolved to the port's classes."""
    from vaura_tpu_torch.ops import patterns as _p

    for cls_name in (
        "DelayedPatternProvider",
        "ParallelPatternProvider",
        "UnrolledPatternProvider",
        "VALLEPattern",
        "MusicLMPattern",
    ):
        obj = getattr(_p, cls_name)
        register_alias(f"models.modules.misc.codebook_patterns.{cls_name}", obj)
        register_alias(f"vaura_tpu.ops.patterns.{cls_name}", obj)

    from vaura_tpu_torch.ops import schedules as _s

    for cls_name in (
        "InverseSquareRootLRScheduler",
        "WarmUpToStaticLRScheduler",
        "CosineLRScheduler",
    ):
        obj = getattr(_s, cls_name)
        register_alias(f"models.modules.misc.lr_schedulers.{cls_name}", obj)
        register_alias(f"vaura_tpu.ops.schedules.{cls_name}", obj)

    from vaura_tpu_torch.models import bridges as _b

    register_alias("torch.nn.Identity", _b.IdentityBridge)
    register_alias("models.modules.misc.bridges.BridgeBase", _b.IdentityBridge)
    register_alias("vaura_tpu.models.bridges.IdentityBridge", _b.IdentityBridge)
    for cls_name in ("ConvBridgeVisual", "ConvBridge2D", "MLPBridge"):
        obj = getattr(_b, cls_name)
        register_alias(f"models.modules.misc.bridges.{cls_name}", obj)
        register_alias(f"vaura_tpu.models.bridges.{cls_name}", obj)

    from vaura_tpu_torch.models import sampler as _sam

    register_alias("models.modules.sampler.llama.Transformer", _sam.SamplerSpec)
    register_alias("vaura_tpu.models.sampler.SamplerSpec", _sam.SamplerSpec)

    from vaura_tpu_torch.models.dac import model as _dac

    register_alias("models.modules.dac.model.DacModelWrapper", _dac.DacSpec)
    register_alias("vaura_tpu.models.dac.model.DacSpec", _dac.DacSpec)

    from vaura_tpu_torch.models import motionformer as _mf

    register_alias(
        "models.modules.feature_extractors.avclip.motionformer.MotionFormer",
        _mf.MotionFormerSpec,
    )
    register_alias("vaura_tpu.models.motionformer.MotionFormerSpec",
                   _mf.MotionFormerSpec)

    # transforms: torchvision / reference names -> the port's numpy ones
    from vaura_tpu_torch.data import transforms as _t

    tv = "torchvision.transforms.v2"
    vt = "models.data.transforms.video_transforms"
    for name, obj in (
        (f"{tv}.Resize", _t.Resize),
        (f"{tv}.CenterCrop", _t.CenterCrop),
        (f"{tv}.RandomCrop", _t.RandomCrop),
        (f"{tv}.RandomHorizontalFlip", _t.RandomHorizontalFlip),
        (f"{tv}.Normalize", _t.Normalize),
        (f"{tv}.UniformTemporalSubsample", _t.UniformTemporalSubsample),
        ("torchvision.transforms.Resize", _t.Resize),
        ("torchvision.transforms.CenterCrop", _t.CenterCrop),
        (f"{vt}.ToFloat32DType", _t.ToFloat32DType),
        (f"{vt}.RandomNullify", _t.RandomNullify),
        (f"{vt}.Permute", _t.Permute),
        (f"{vt}.UniformTemporalSubsample", _t.UniformTemporalSubsample),
        (f"{vt}.GenerateMultipleSegments", _t.GenerateMultipleSegments),
    ):
        register_alias(name, obj)
    for name in (
        "AudioRandomVolume",
        "AudioLowpassFilter",
        "AudioPitchShift",
        "AudioReverb",
        "AudioGaussNoise",
        "AudioPhaser",
        "AudioStandardNormalize",
        "AudioLoudnessNormalize",
        "AudioStereoToMono",
        "AudioResample",
        "AudioTrim",
        "AudioUnsqueeze",
    ):
        obj = getattr(_t, name)
        register_alias(f"models.data.transforms.audio_transforms.{name}", obj)
        register_alias(f"vaura_tpu.data.transforms.{name}", obj)
    for name in (
        "Resize",
        "CenterCrop",
        "RandomCrop",
        "RandomHorizontalFlip",
        "Normalize",
        "ToFloat32DType",
        "RandomNullify",
        "Permute",
        "UniformTemporalSubsample",
        "GenerateMultipleSegments",
    ):
        register_alias(f"vaura_tpu.data.transforms.{name}", getattr(_t, name))


_aliases_done = False


def ensure_aliases() -> None:
    global _aliases_done
    if not _aliases_done:
        _aliases_done = True
        _register_builtin_aliases()
