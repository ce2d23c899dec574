"""Train action: build the datamodule and the system from a config, fit
with the Trainer, then run the test loop on the best checkpoint.

Counterpart of ``scripts/train.py`` (reference ``scripts/train.py``): a
timestamped run directory with ``hparams.yaml``, the seeded initialisation,
pretrained frozen submodules (``maybe_load_pretrained``), the DAC
embeddings folded into the sampler, ``Trainer.fit`` (resuming from
``trainer.ckpt_path``), and the test loss of the best checkpoint, or of
the current parameters when none can be restored.

The device is ``cuda`` unless the config says ``trainer.platform: cpu``
(``config_device``). Training runs on one device: the ``trainer.mesh`` keys
are accepted and have no effect, and a log line says so when several cards
are visible.
"""

from __future__ import annotations

import logging

import torch

from vaura_tpu_torch.data import get_datamodule_from_type
from vaura_tpu_torch.models.factory import build_system, maybe_load_pretrained
from vaura_tpu_torch.scripts.generate import config_device
from vaura_tpu_torch.train.loop import Trainer
from vaura_tpu_torch.utils import seeded_init_
from vaura_tpu_torch.utils.experiment import init_log_directory, save_hparams
from vaura_tpu_torch.utils.seeding import seed_everything

logger = logging.getLogger(__name__)


def training_device(cfg: dict) -> torch.device:
    """``config_device``, with the log line of a run that sees several
    cards and trains on one."""
    device = config_device(cfg)
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        logger.info("%d CUDA devices are visible; the port trains on one "
                    "(%s); trainer.mesh has no effect",
                    torch.cuda.device_count(), device)
    return device


def init_system(cfg: dict, device: torch.device):
    """``(system, generator)``: the system of ``cfg["model"]`` at the
    trainer's precision, every weight drawn from the seeded generator (the
    LM head zero, as the JAX package initialises it) and the DAC codebooks
    folded into the sampler's embeddings."""
    trainer_cfg = cfg["trainer"]
    system = build_system(cfg["model"], precision=trainer_cfg.get("precision"),
                          device=device)
    generator = seed_everything(int(trainer_cfg.get("seed", 666)), device)
    seeded_init_(system, generator)
    torch.nn.init.zeros_(system.sampler.lm_head.weight)
    return system, generator


def train(cfg: dict) -> dict:
    logging.basicConfig(level=logging.INFO)
    logging.getLogger().setLevel(logging.INFO)
    trainer_cfg = cfg["trainer"]
    model_cfg = cfg["model"]
    device = training_device(cfg)
    dirs = init_log_directory(
        trainer_cfg.get("log_dir", "./logs"), trainer_cfg["experiment_name"]
    )
    save_hparams(dirs["experiment"], cfg)
    logger.info("Logging to %s", dirs["root"])

    datamodule = get_datamodule_from_type(
        cfg["dataloader"]["dataset_type"], cfg["dataloader"]
    )
    datamodule.setup()

    system, generator = init_system(cfg, device)
    maybe_load_pretrained(system, model_cfg)
    system.load_dac_embeddings_into_sampler()

    trainer = Trainer(system, trainer_cfg, model_cfg, dirs)
    try:
        trainer.fit(
            datamodule, generator, resume_path=trainer_cfg.get("ckpt_path")
        )
        # test with the best checkpoint (reference scripts/train.py:94)
        try:
            best_params = trainer.ckpt.restore_best()["params"]
        except Exception as e:  # no ckpt / failed restore: test in memory
            logger.warning("best-ckpt restore failed (%s); testing current "
                           "params", e)
            best_params = None
        metrics = trainer.test(datamodule, best_params)
    finally:
        trainer.tb.close()
    logger.info("test: %s", metrics)
    return {"dirs": dirs, "metrics": metrics, "stats": trainer.stats}
