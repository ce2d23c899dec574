"""Datamodule registry: ``DATALOADER_TYPES`` + ``get_datamodule_from_type``
(counterpart of ``vaura_tpu/data/__init__.py``, every type of it).
"""

from __future__ import annotations

from typing import Callable, Dict

from vaura_tpu_torch.data.core import DataLoader, DataModule, Dataset, default_collate
from vaura_tpu_torch.data.dummy import DummyDataModule, DummyDataset


def _lazy(modpath: str, attr: str) -> Callable:
    def factory(**kwargs):
        import importlib

        mod = importlib.import_module(modpath)
        return getattr(mod, attr)(**kwargs)

    return factory


DATALOADER_TYPES: Dict[str, Callable] = {
    "dummy": DummyDataModule,
    "vggsound": _lazy("vaura_tpu_torch.data.vggsound", "VggSoundDataModule"),
    "visualsound": _lazy("vaura_tpu_torch.data.vggsound", "VggSoundDataModule"),
    "audioset": _lazy("vaura_tpu_torch.data.audioset", "AudioSetDataModule"),
    "greatesthit": _lazy("vaura_tpu_torch.data.greatesthit",
                         "GreatestHitDataModule"),
    "video": _lazy("vaura_tpu_torch.data.video_dataset", "VideoDataModule"),
    "vjepa": _lazy("vaura_tpu_torch.data.vjepa", "VJEPADataModule"),
    "vjepa_gen": _lazy("vaura_tpu_torch.data.vjepa", "VJEPAGenDataModule"),
    "motionformer": _lazy("vaura_tpu_torch.data.motionformer_data",
                          "MotionFormerDataModule"),
    "motionformer_gen": _lazy("vaura_tpu_torch.data.motionformer_data",
                              "MotionFormerGenDataModule"),
}


def get_datamodule_from_type(dataset_type: str, cfg: dict) -> DataModule:
    """Build the datamodule named by ``dataset_type`` from a dataloader
    config block."""
    if dataset_type not in DATALOADER_TYPES:
        raise ValueError(
            f"Unknown dataset_type {dataset_type!r}; known: "
            f"{sorted(DATALOADER_TYPES)}"
        )
    kwargs = {k: v for k, v in cfg.items() if k != "dataset_type"}
    return DATALOADER_TYPES[dataset_type](**kwargs)


__all__ = [
    "DATALOADER_TYPES",
    "DataLoader",
    "DataModule",
    "Dataset",
    "DummyDataModule",
    "DummyDataset",
    "default_collate",
    "get_datamodule_from_type",
]
