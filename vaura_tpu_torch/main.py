"""CLI entry point of the port (counterpart of the repo's ``main.py``):
layered config assembly + action dispatch.

Usage::

    python -m vaura_tpu_torch config=configs/generate_vgg.yaml [key=value ...]

``train`` and ``test`` run the train and test actions
(``vaura_tpu_torch.scripts.train``, ``.test``); ``generate`` and
``predict`` run the generate action (``vaura_tpu_torch.scripts.generate``);
``serve`` starts the micro-batching HTTP server
(``vaura_tpu_torch.scripts.serve``). The other actions of ``main.py``
(``finetune``, ``eval``) raise ``NotImplementedError`` naming the ROADMAP
item that ports them. The device
is ``cuda`` unless the config says ``trainer.platform=cpu``; without CUDA
and without that key the action raises.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).absolute().parents[1]

logger = logging.getLogger("vaura_tpu_torch")

# the ROADMAP.md items ("Modules to port") that port the other actions
_NOT_PORTED = {
    "finetune": "LoRA and finetune",
    "eval": "Everything else (eval)",
}


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
    (the train action's ``{"dirs", "metrics", ...}``, the test action's
    ``{"test_loss"}``, the generate action's ``{"output_dir",
    "num_generated", ...}``)."""
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
    if action in _NOT_PORTED:
        raise NotImplementedError(
            f"action {action!r} is not ported yet (ROADMAP.md, 'Modules to "
            f"port', item '{_NOT_PORTED[action]}')")
    raise ValueError(f"Unknown action {action!r}")


if __name__ == "__main__":
    main()
