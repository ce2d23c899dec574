"""Greatest Hits dataset/datamodule (counterpart of
``vaura_tpu/data/greatesthit.py``; reference
``models/data/greatesthit_dataset.py`` / ``greatesthit_datamodule.py``).

Fidelity notes:
  * file discovery globs each split basename for its preprocessed clips:
    ``{basename}_denoised*`` for train/val/test, ``{basename}*`` for
    predict (reference ``greatesthit_dataset.py:191-197``).
  * label / material / motion come from the annotation meta CSV
    (``filename,start_time,occurring_time,end_time,material,action_type,
    effect`` — label=action_type col 5, material col 4, motion=effect
    col 6, keyed by clip file NAME; reference ``:183-185,271-282``).
  * eval start points are lazily fixed per clip so repeated epochs see
    identical crops (reference ``:135-140``).
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path
from typing import List

import numpy as np

from vaura_tpu_torch.data.vggsound import EPS, VggSoundDataModule, VggSoundDataset

logger = logging.getLogger(__name__)


class GreatestHitDataset(VggSoundDataset):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # annotation maps keyed by clip file name
        # (reference greatesthit_dataset.py:271-282)
        with self.meta_path.open(encoding="utf-8") as f:
            rows = list(csv.reader(f))[1:]
        self.filename2label = {r[0]: r[5] for r in rows if len(r) > 6}
        self.filename2material = {r[0]: r[4] for r in rows if len(r) > 6}
        self.filename2motion = {r[0]: r[6] for r in rows if len(r) > 6}
        self._lazy_start_pts = {}

    @staticmethod
    def _split_prefix(split_dir_path: Path) -> str:
        return "greatesthit"

    def _restrict_split_names(self, names: List[str], meta_rows) -> List[str]:
        return names  # split basenames expand by glob below

    def _clip_path(self, name: str) -> Path:
        return self.data_path / f"{Path(name).stem}.mp4"

    def _apply_file_filters(self, files, *args, **kwargs):
        # expand split basenames into their preprocessed clips
        # (reference greatesthit_dataset.py:79-83,191-197); then apply the
        # shared exclusion plumbing to the expanded list
        expanded: List[Path] = []
        for f in files:
            pattern = (
                f"{f.stem}_denoised*" if self.split != "predict" else f"{f.stem}*"
            )
            # constrain to videos: precompute_codes.py writes .codes.npy
            # sidecars next to the clips, which the bare glob would match
            expanded.extend(
                p for p in sorted(self.data_path.glob(pattern))
                if p.suffix == ".mp4"
            )
        return super()._apply_file_filters(expanded or files, *args, **kwargs)

    def _crops_seed_dependent(self) -> bool:
        # eval start points are drawn from the seeded per-stem rng below,
        # so precomputed codes only align under the same seed
        return True

    def _start_pts(self, path: Path, duration: float) -> float:
        if self.split != "train":
            # fixed eval start point per file so repeated epochs see
            # identical crops (reference greatesthit_dataset.py:135-140).
            # Keyed by (seed, stem) rather than drawn lazily from the
            # shared rng stream: the reference's lazy draw makes eval
            # crops depend on item *access order* (and, across processes,
            # on PYTHONHASHSEED via hash()), which breaks reproducibility
            # and precomputed-code alignment.
            if path.stem not in self._lazy_start_pts:
                import zlib

                hi = max(duration - self.video_len - EPS, 0.0)
                r = np.random.default_rng(
                    (self.seed, zlib.crc32(path.stem.encode()))
                )
                self._lazy_start_pts[path.stem] = float(r.uniform(0, hi))
            return self._lazy_start_pts[path.stem]
        return super()._start_pts(path, duration)

    def __getitem__(self, idx: int) -> dict:
        item = super().__getitem__(idx)
        name = Path(item["meta"]["filepath"]).name
        # reference greatesthit_dataset.py:183-185
        item["meta"]["label"] = self.filename2label.get(name, "")
        item["meta"]["material"] = self.filename2material.get(name, "")
        item["meta"]["motion"] = self.filename2motion.get(name, "")
        return item


class GreatestHitDataModule(VggSoundDataModule):
    dataset_cls = GreatestHitDataset
