"""AudioSet dataset/datamodule (counterpart of ``vaura_tpu/data/audioset.py``;
reference ``models/data/audioset_dataset.py`` / ``audioset_datamodule.py``).

Fidelity notes vs the VGGSound base:
  * split entries may carry a subdirectory (``balanced_train_segments/<id>_
    <ms>_<ms>``) and are used as-is — NO meta ∩ split intersection
    (reference ``audioset_dataset.py:189-193``: clip paths come straight
    from the split file, ``data_path / f"{c}.mp4"``).
  * a label metadata CSV (``index,/m/...,"display name"`` rows, default
    ``<meta dir>/audioset_labels.csv``) is required and loaded into
    mid/display-name maps (reference ``audioset_dataset.py:87-92``).
  * missing fixed eval start points default to 6.66 s (reference
    ``audioset_dataset.py:180``), not 0.0.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import List, Optional

from vaura_tpu_torch.data.vggsound import VggSoundDataModule, VggSoundDataset


class AudioSetDataset(VggSoundDataset):
    EVAL_DEFAULT_START = 6.66  # reference audioset_dataset.py:180

    def __init__(self, *args, label_meta_path: Optional[str] = None, **kwargs):
        super().__init__(*args, **kwargs)
        if label_meta_path is None:
            label_meta_path = self.meta_path.parent / "audioset_labels.csv"
        label_meta_path = Path(label_meta_path)
        assert label_meta_path.is_file(), f"missing label CSV {label_meta_path}"
        # rows: index, MID (/m/...), "display name" — no header
        self.index2mid = {}
        self.mid2label = {}
        with open(label_meta_path, encoding="utf-8") as f:
            for row in csv.reader(f):
                if len(row) >= 3:
                    self.index2mid[int(row[0])] = row[1]
                    self.mid2label[row[1]] = row[2]

    @staticmethod
    def _split_prefix(split_dir_path: Path) -> str:
        return "audioset"

    def _restrict_split_names(self, names: List[str], meta_rows) -> List[str]:
        # reference audioset_dataset.py:189-193: the split file IS the clip
        # list; the meta CSV does not gate membership
        return names

    def _clip_path(self, name: str) -> Path:
        # keep the relative subdirectory (balanced_train_segments/...)
        return self.data_path / f"{name}.mp4"

    def _start_pts(self, path: Path, duration: float) -> float:
        if self.split == "train":
            return super()._start_pts(path, duration)
        return self.fixed_start_pts.get(path.stem, self.EVAL_DEFAULT_START)


class AudioSetDataModule(VggSoundDataModule):
    dataset_cls = AudioSetDataset

    def __init__(self, *args, label_meta_path: Optional[str] = None, **kwargs):
        super().__init__(*args, **kwargs)
        if label_meta_path is not None:
            self.kwargs["label_meta_path"] = label_meta_path
