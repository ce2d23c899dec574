"""Load reference-distribution (PyTorch-Lightning) experiment trees.

The reference ships released checkpoints as a tarred Lightning experiment
directory (``utils/demo_utils.py:56-79``)::

    logs/<stamp>/
      checkpoints/epoch=E-step=S-val_loss=V.ckpt   torch Lightning ckpt
      <experiment_name>/hparams.yaml               VAURAModel init kwargs

and resolves it at generation time: pick the best-val-loss ``.ckpt`` by
filename (``utils/utils.py:30-45``), find the sibling hparams dir
(``scripts/generate.py:97-128``), patch hparams with backup/restore
semantics (``scripts/generate.py:71-94``), then
``VAURAModel.load_from_checkpoint``.

This module is the port's counterpart of ``vaura_tpu/utils/reference_ckpt.py``:
the same resolution walk, then the torch state dict converts to the port's
state dicts (:func:`vaura_tpu_torch.models.convert.convert_vaura_checkpoint`)
and the hparams dict IS the model config (``build_system`` consumes the
reference's ``{target, params}`` blocks through the registry aliases). A
patched hparams file is written as JSON text, which YAML readers read.
"""

from __future__ import annotations

import logging
import re
from pathlib import Path
from shutil import copyfile
from typing import Any, Dict, Optional, Tuple

from vaura_tpu_torch.config.yaml_subset import dump, load_file

logger = logging.getLogger(__name__)

CKPT_VAL_RE = re.compile(r"val_loss=(?P<val>[0-9]+\.?[0-9]*)")

# dirs the hparams walk must skip inside an experiment dir
# (reference scripts/generate.py:105-117)
_NON_HPARAMS_DIRS = (
    "vggsound_sparse", "vggsound_test", "vggsound_clean",
    "generated_samples", "visualsound", "vas", "checkpoints",
)

# the demo nulls the feature-extractor ckpt path so loading the Lightning
# ckpt doesn't re-download AVCLIP weights (reference demo_utils.py:15-17)
DEFAULT_OVERWRITE_HPARAMS: Dict[str, Any] = {
    "feature_extractor_config": {"params": {"ckpt_path": None}}
}


def is_reference_checkpoint(path: str | Path) -> bool:
    """True for a torch Lightning ``.ckpt`` file or an experiment dir
    holding one (as opposed to our orbax trees, which are directories of
    zarr arrays)."""
    p = Path(path)
    if p.is_file():
        return p.suffix == ".ckpt"
    if p.is_dir():
        if (p / "_METADATA").exists() or (p / "d").exists():
            return False  # orbax tree
        return any(p.rglob("*.ckpt"))
    return False


def best_val_loss_ckpt(root: Path, pattern: str = "**/*.ckpt") -> Path:
    """Reference ``get_file_with_best_val_loss`` (utils/utils.py:30-45):
    lowest ``val_loss=`` encoded in the filename; ties/absences fall back
    to the lexicographically last file (latest epoch)."""
    cands = sorted(root.glob(pattern))
    if not cands:
        raise FileNotFoundError(f"no .ckpt under {root}")
    best, best_val = None, float("inf")
    for p in cands:
        m = CKPT_VAL_RE.search(p.name)
        if m and float(m.group("val")) < best_val:
            best, best_val = p, float(m.group("val"))
    return best or cands[-1]


def resolve_ckpt(path: str | Path) -> Path:
    """File -> itself; directory -> best-val-loss ``.ckpt`` under it
    (reference scripts/generate.py:43-52, demo_utils.py:75-80)."""
    p = Path(path)
    assert p.exists(), f"checkpoint {p} does not exist"
    return p if p.is_file() else best_val_loss_ckpt(p)


def resolve_hparams_path(
    ckpt_path: Path, hparams: Optional[str | Path] = None
) -> Path:
    """Locate hparams.yaml for a checkpoint (reference
    scripts/generate.py:97-128): the experiment dir is ``ckpt.parents[1]``;
    among its subdirectories exactly one besides ``checkpoints/`` (and
    generated-sample dirs) holds the Lightning hparams snapshot;
    ``hparams.original.yaml`` wins over ``hparams.yaml`` when a previous
    run already patched it."""
    if hparams is not None:
        p = Path(hparams)
        assert p.exists(), f"hparams {p} does not exist"
        return p
    experiment_dir = ckpt_path.parents[1]
    dirs = [
        d for d in experiment_dir.iterdir()
        if d.is_dir()
        and d != ckpt_path.parent
        and not any(s in d.name for s in _NON_HPARAMS_DIRS)
    ]
    for d in dirs:
        for name in ("hparams.original.yaml", "hparams.yaml"):
            if (d / name).exists():
                return d / name
    raise FileNotFoundError(
        f"no hparams.yaml next to {ckpt_path} (searched {experiment_dir})"
    )


def _merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def override_hparams(
    hparams_path: Path, overridden: Optional[Dict[str, Any]] = None
) -> Path:
    """Patch hparams.yaml in place with backup/restore semantics
    (reference scripts/generate.py:71-94): the first patch backs the
    original up as ``hparams.original.yaml``; later patches start from the
    backup so overrides never stack."""
    if not overridden:
        return hparams_path
    hparams_path = Path(hparams_path)
    if hparams_path.name == "hparams.original.yaml":
        copyfile(hparams_path, hparams_path.parent / "hparams.yaml")
        hparams_path = hparams_path.parent / "hparams.yaml"
    else:
        backup = hparams_path.parent / "hparams.original.yaml"
        if not backup.exists():
            copyfile(hparams_path, backup)
    hparams = _merge(load_file(hparams_path), overridden)
    out = hparams_path.parent / "hparams.yaml"
    out.write_text(dump(hparams), encoding="utf-8")
    return out


def load_reference_experiment(
    path: str | Path,
    overridden_hparams: Optional[Dict[str, Any]] = None,
    hparams: Optional[str | Path] = None,
) -> Tuple[Dict[str, Any], Dict[str, Any], Path]:
    """Resolve + load a reference experiment: returns ``(model_cfg,
    state_dicts, ckpt_path)``. ``model_cfg`` is the patched hparams dict
    (consumable by ``build_system`` directly); ``state_dicts`` holds the
    port's ``{sampler[, dac][, encoder]}`` state dicts present in the
    Lightning state dict (the reference serializes the frozen codec and
    visual encoder into the model ckpt, ``vaura_model.py:61``), for
    ``VauraSystem.load_state_dicts``."""
    from vaura_tpu_torch.models.convert import convert_vaura_checkpoint

    ckpt_path = resolve_ckpt(path)
    hp_path = resolve_hparams_path(ckpt_path, hparams)
    if overridden_hparams is None:
        overridden_hparams = DEFAULT_OVERWRITE_HPARAMS
    # merge IN MEMORY: loading must never mutate the experiment tree
    # (read-only mounts, concurrent runs). The reference's on-disk
    # hparams patching (scripts/generate.py:71-94) stays available as
    # the explicit :func:`override_hparams`.
    model_cfg = load_file(hp_path)
    if overridden_hparams:
        model_cfg = _merge(model_cfg, overridden_hparams)
    logger.info("reference experiment: ckpt=%s hparams=%s", ckpt_path, hp_path)
    params = convert_vaura_checkpoint(str(ckpt_path))
    return model_cfg, params, ckpt_path
