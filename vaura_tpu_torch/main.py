"""CLI entry point of the port (counterpart of the repo's ``main.py``):
layered config assembly + action dispatch.

Usage::

    python -m vaura_tpu_torch config=configs/generate_vgg.yaml [key=value ...]

``train`` and ``test`` run the train and test actions
(``vaura_tpu_torch.scripts.train``, ``.test``); ``finetune`` the finetune
action (``.finetune``: from ``finetune.init_from``, optionally with LoRA
adapters); ``generate`` and ``predict`` the generate action
(``.generate``); ``serve`` starts the micro-batching HTTP server
(``.serve``); ``eval`` computes the objective metrics of
``generated_dir`` (or ``output_dir``) against ``reference_dir``, with
``fad=true`` a Frechet audio distance under ``embedder`` (``melstats``,
``vggish`` or ``panns``, ``embedder_ckpt`` for the last two;
``.eval_metrics``). The device is ``cuda`` unless the config says
``trainer.platform=cpu``; without CUDA and without that key the action
raises.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).absolute().parents[1]

logger = logging.getLogger("vaura_tpu_torch")


def get_config(argv):
    from vaura_tpu_torch.config import assemble_config, check_mandatory

    cfg = assemble_config(
        argv,
        defaults_path=REPO_ROOT / "configs" / "vaura_defaults.yaml",
        base_dir=REPO_ROOT,
    )
    check_mandatory(cfg)
    return cfg


def main(argv=None) -> dict:
    """Run the action of the config ``argv`` assembles; returns its result
    (the train and finetune actions' ``{"dirs", "metrics", ...}``, the
    test action's ``{"test_loss"}``, the generate action's ``{"output_dir",
    "num_generated", ...}``, the eval action's report or None)."""
    argv = argv if argv is not None else sys.argv[1:]
    cfg = get_config(argv)
    action = cfg.get("action")
    logging.basicConfig(level=logging.WARNING)
    logger.setLevel(logging.INFO)
    if action == "train":
        from vaura_tpu_torch.scripts.train import train

        return train(cfg)
    if action == "test":
        from vaura_tpu_torch.scripts.test import test

        return test(cfg)
    if action in ("generate", "predict"):
        from vaura_tpu_torch.scripts.generate import generate

        return generate(cfg)
    if action == "serve":
        from vaura_tpu_torch.scripts.serve import run_server

        return run_server(cfg)
    if action == "finetune":
        from vaura_tpu_torch.scripts.finetune import finetune

        return finetune(cfg)
    if action == "eval":
        from vaura_tpu_torch.scripts.eval_metrics import run_eval

        return run_eval(cfg)
    raise ValueError(f"Unknown action {action!r}")


if __name__ == "__main__":
    main()
