"""Test action: the teacher-forced loss over the test split from a
checkpoint.

Counterpart of ``scripts/test.py`` (reference ``scripts/test.py``, whose
stale LoRA arguments break it; this one works): a run directory with
``hparams.yaml``, the seeded initialisation of the train action, the
trainable parameters of ``trainer.ckpt_path`` (a checkpoint of this
package's Trainer, or a params-only file), and ``Trainer.test``. The device
rule is the train action's.
"""

from __future__ import annotations

import logging

from vaura_tpu_torch.data import get_datamodule_from_type
from vaura_tpu_torch.scripts.generate import config_device
from vaura_tpu_torch.scripts.train import init_system, run_directory
from vaura_tpu_torch.train.checkpoint import load_trainable_
from vaura_tpu_torch.train.loop import Trainer
from vaura_tpu_torch.train.steps import split_params

logger = logging.getLogger(__name__)


def test(cfg: dict) -> dict:
    logging.basicConfig(level=logging.INFO)
    logging.getLogger().setLevel(logging.INFO)
    trainer_cfg = cfg["trainer"]
    model_cfg = cfg["model"]
    device = config_device(cfg)
    dirs = run_directory(trainer_cfg,
                         trainer_cfg.get("experiment_name", "test"), cfg)

    datamodule = get_datamodule_from_type(
        cfg["dataloader"]["dataset_type"], cfg["dataloader"]
    )
    datamodule.setup("test")

    system, _ = init_system(cfg, device)
    system.load_dac_embeddings_into_sampler()
    # frozen leaves (codec, a frozen encoder) record no graph
    split_params(system)

    ckpt_path = trainer_cfg.get("ckpt_path")
    if ckpt_path:
        load_trainable_(system, ckpt_path, model_cfg, trainer_cfg)
        logger.info("Loaded checkpoint %s", ckpt_path)

    trainer = Trainer(system, trainer_cfg, model_cfg, dirs)
    try:
        metrics = trainer.test(datamodule)
    finally:
        trainer.tb.close()
    logger.info("test: %s", metrics)
    return metrics
