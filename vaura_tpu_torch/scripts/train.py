"""Train action: build the datamodule and the system from a config, fit
with the Trainer, then run the test loop on the best checkpoint.

Counterpart of ``scripts/train.py`` (reference ``scripts/train.py``): a
timestamped run directory with ``hparams.yaml``, the seeded initialisation,
pretrained frozen submodules (``maybe_load_pretrained``), the DAC
embeddings folded into the sampler, ``Trainer.fit`` (resuming from
``trainer.ckpt_path``), and the test loss of the best checkpoint, or of
the current parameters when none can be restored.

The device is ``cuda`` unless the config says ``trainer.platform: cpu``
(``config_device``). A run started by ``torchrun`` (one process per card:
``torchrun --nproc_per_node=N -m vaura_tpu_torch config=... action=train``)
trains on a ``(data, fsdp, model)`` mesh read from ``trainer.mesh`` as the
JAX action reads it (``data: -1`` absorbs the ranks left), with the JAX
action's fallback: when ``dataloader.batch_size`` is not divisible by
``data * fsdp`` the run goes unsharded (every rank computes the whole batch)
with the same warning. Rank 0 alone writes the run directory's files.
"""

from __future__ import annotations

import logging

import torch

from vaura_tpu_torch.data import get_datamodule_from_type
from vaura_tpu_torch.models.factory import build_system, maybe_load_pretrained
from vaura_tpu_torch.parallel import multihost
from vaura_tpu_torch.scripts.generate import config_device
from vaura_tpu_torch.train.loop import Trainer
from vaura_tpu_torch.utils import seeded_init_
from vaura_tpu_torch.utils.experiment import init_log_directory, save_hparams
from vaura_tpu_torch.utils.seeding import seed_everything

logger = logging.getLogger(__name__)


def training_mesh(cfg: dict, device: torch.device):
    """The mesh of a launched run (``multihost.launched``), or None: the
    JAX action's rules (``scripts/train.py:43-63``), over the processes of
    the run where JAX counts devices."""
    if not multihost.launched():
        return None
    from vaura_tpu_torch.parallel import make_mesh

    mesh_cfg = cfg["trainer"].get("mesh") or {}
    mesh = make_mesh(data=int(mesh_cfg.get("data", -1)),
                     fsdp=int(mesh_cfg.get("fsdp", 1)),
                     model=int(mesh_cfg.get("model", 1)),
                     device_type=device.type)
    batch_ways = mesh.size(0) * mesh.size(1)
    batch_size = int(cfg["dataloader"].get("batch_size", 1))
    if batch_size % batch_ways != 0:
        logger.warning("batch_size %d not divisible by data*fsdp=%d; "
                       "running unsharded", batch_size, batch_ways)
        return None
    logger.info("Mesh: %s", dict(zip(mesh.mesh_dim_names, mesh.shape)))
    return mesh


def run_directory(trainer_cfg: dict, experiment_name: str, cfg: dict) -> dict:
    """The run directory, made (with ``hparams.yaml``) by rank 0 and named
    alike on every rank."""
    dirs = None
    if multihost.is_main_process():
        dirs = init_log_directory(trainer_cfg.get("log_dir", "./logs"),
                                  experiment_name)
        save_hparams(dirs["experiment"], cfg)
    return multihost.broadcast_object(dirs)


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
    device = config_device(cfg)
    dirs = run_directory(trainer_cfg, trainer_cfg["experiment_name"], cfg)
    logger.info("Logging to %s", dirs["root"])

    datamodule = get_datamodule_from_type(
        cfg["dataloader"]["dataset_type"], cfg["dataloader"]
    )
    datamodule.setup()

    system, generator = init_system(cfg, device)
    maybe_load_pretrained(system, model_cfg)
    system.load_dac_embeddings_into_sampler()

    trainer = Trainer(system, trainer_cfg, model_cfg, dirs,
                      mesh=training_mesh(cfg, device))
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
