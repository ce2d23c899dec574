"""Finetune action: continue training from a checkpoint, optionally with
LoRA adapters on the sampler.

Counterpart of ``scripts/finetune.py``: ``finetune.init_from`` names the
weights to start from (``train/checkpoint.py::load_base_``: a whole tree or
a training run's checkpoint of this package, or a reference checkpoint; an
orbax tree of the JAX package raises ``ValueError``), the optimizer starts
anew, ``finetune.unfreeze_encoder`` trains the visual encoder, and
``finetune.lora_rank`` (with ``lora_target_modules`` and ``lora_alpha``)
trains adapters on the sampler's dense layers while the base sampler stays
frozen and out of the run's checkpoints. The ``lora_*`` keys are copied
into the model config saved in ``hparams.yaml``, so the generate action
and the server rebuild the same system from the run (and its base from
``init_from``). Then ``Trainer.fit`` and ``Trainer.test`` on the final
parameters, as the train action runs them. The device rule is the train
action's.
"""

from __future__ import annotations

import logging

from vaura_tpu_torch.data import get_datamodule_from_type
from vaura_tpu_torch.models.factory import maybe_load_pretrained
from vaura_tpu_torch.scripts.train import init_system, training_device
from vaura_tpu_torch.train.checkpoint import load_base_
from vaura_tpu_torch.train.lora import count_lora_params
from vaura_tpu_torch.train.loop import Trainer
from vaura_tpu_torch.utils.experiment import init_log_directory, save_hparams

logger = logging.getLogger(__name__)


def finetune(cfg: dict) -> dict:
    logging.basicConfig(level=logging.INFO)
    logging.getLogger().setLevel(logging.INFO)
    trainer_cfg = cfg["trainer"]
    model_cfg = dict(cfg["model"])
    ft_cfg = cfg.get("finetune") or {}
    if ft_cfg.get("unfreeze_encoder"):
        model_cfg["freeze_feature_extractor"] = False
    for key in ("lora_rank", "lora_target_modules", "lora_alpha"):
        if ft_cfg.get(key) is not None:
            model_cfg[key] = ft_cfg[key]
    cfg = {**cfg, "model": model_cfg}
    device = training_device(cfg)

    dirs = init_log_directory(
        trainer_cfg.get("log_dir", "./logs"),
        trainer_cfg.get("experiment_name", "finetune"),
    )
    save_hparams(dirs["experiment"], cfg)

    datamodule = get_datamodule_from_type(
        cfg["dataloader"]["dataset_type"], cfg["dataloader"]
    )
    datamodule.setup()

    system, generator = init_system(cfg, device)
    maybe_load_pretrained(system, model_cfg)
    system.load_dac_embeddings_into_sampler()
    init_from = ft_cfg.get("init_from")
    if init_from:
        load_base_(system, init_from)
        logger.info("finetuning from %s", init_from)
    else:
        logger.warning("finetune.init_from not set: training from scratch")
    if system.lora_sampler is not None:
        logger.info("LoRA finetuning: rank %d, %d adapter params",
                    system.lora_rank, count_lora_params(system.lora_sampler))

    trainer = Trainer(system, trainer_cfg, model_cfg, dirs)
    try:
        trainer.fit(datamodule, generator)
        metrics = trainer.test(datamodule)
    finally:
        trainer.tb.close()
    logger.info("finetune test: %s", metrics)
    return {"dirs": dirs, "metrics": metrics, "stats": trainer.stats}
