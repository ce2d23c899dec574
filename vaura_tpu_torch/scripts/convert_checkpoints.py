"""Checkpoint conversion CLI: reference torch checkpoints -> checkpoints of
this package.

Counterpart of ``scripts/convert_checkpoints.py``, which writes orbax trees;
here the output is a checkpoint directory of the port (``state.pt``:
``{"params": {name: tensor}}`` under ``VauraSystem``'s names, CPU float32
tensors), which ``train/checkpoint.py::load_state`` reads and the actions
take as ``ckpt_path=`` (``load_trainable_``) or ``finetune.init_from=``
(``load_base_``). Supports:

  * a full V-AURA Lightning ``.ckpt`` (sampler + frozen DAC + AVCLIP
    encoder)
  * descript-audio-codec ``.pth`` weights
  * Synchformer stage-I AVCLIP ``.pt`` / Motionformer ``.pyth`` checkpoints

with the converters of ``models/convert.py``. The conversion runs on the
host; ``--device`` (the JAX CLI's ``--platform``) is accepted and touches
nothing.

Usage::

    python -m vaura_tpu_torch.scripts.convert_checkpoints vaura  model.ckpt  out_dir/
    python -m vaura_tpu_torch.scripts.convert_checkpoints dac    weights.pth out_dir/
    python -m vaura_tpu_torch.scripts.convert_checkpoints avclip ckpt.pt     out_dir/
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Dict

import torch

from vaura_tpu_torch.train.checkpoint import STATE_FILE

logger = logging.getLogger(__name__)


def save_state_dicts(state_dicts: Dict[str, Dict[str, torch.Tensor]],
                     out_dir: Path) -> Path:
    """``{"sampler": {...}, "dac": {...}, ...}`` -> ``out_dir/state.pt``
    holding ``{"params": {"sampler.<name>": tensor, ...}}``."""
    out_dir = Path(out_dir).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    params = {f"{top}.{k}": v.detach().cpu()
              for top, sd in state_dicts.items() for k, v in sd.items()}
    tmp = out_dir / (STATE_FILE + ".tmp")
    torch.save({"params": params}, tmp)
    tmp.replace(out_dir / STATE_FILE)
    logger.info("saved converted params to %s", out_dir)
    return out_dir / STATE_FILE


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("kind", choices=["vaura", "dac", "avclip", "motionformer"])
    ap.add_argument("src", type=Path)
    ap.add_argument("out", type=Path)
    ap.add_argument("--num-layers", type=int, default=None,
                    help="default: inferred from the state dict")
    ap.add_argument("--num-codebooks", type=int, default=None,
                    help="default: inferred from the state dict")
    ap.add_argument("--encoder-depth", type=int, default=None,
                    help="default: inferred from the state dict")
    ap.add_argument("--device", type=str, default=None,
                    help="accepted for the JAX CLI's --platform; the "
                         "conversion runs on the host")
    args = ap.parse_args(argv)

    from vaura_tpu_torch.models import convert as C

    if args.kind == "vaura":
        sds = C.convert_vaura_checkpoint(
            str(args.src),
            num_layers=args.num_layers,
            num_codebooks=args.num_codebooks,
            encoder_depth=args.encoder_depth,
        )
    elif args.kind == "dac":
        ckpt = torch.load(args.src, map_location="cpu", weights_only=False)
        sd = ckpt.get("state_dict", ckpt)
        sds = {"dac": C.convert_dac_state_dict(
            sd, n_codebooks=args.num_codebooks)}
    else:  # avclip / motionformer
        ckpt = torch.load(args.src, map_location="cpu", weights_only=False)
        sd = ckpt.get("state_dict", ckpt.get("model_state", ckpt))
        sd = C.strip_avclip_prefix(sd)
        sds = {"encoder": C.convert_motionformer_state_dict(
            sd, depth=args.encoder_depth)}
    save_state_dicts(sds, args.out)


if __name__ == "__main__":
    main()
