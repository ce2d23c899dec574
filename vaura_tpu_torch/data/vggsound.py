"""VGGSound / VisualSound split-file dataset (counterpart of
``vaura_tpu/data/vggsound.py``; reference ``models/data/vggsound_dataset.py``
/ ``vggsound_datamodule.py``).

Contract per item (matching the reference's output dict,
``vggsound_dataset.py:274-278``):
  * ``frames``: [num_clips, C, frames_per_clip, H, W] float32
  * ``audio``: [1, ceil(video_length * sr_audio)] float32
  * ``meta``: filepath, target/label, start_pts, clip_indices

Filtering plumbing mirrors the reference: split txt files
(``{vggsound|visualsound}_{split}.txt``), meta CSV (video id, start, label),
excluded/included file lists, fixed eval start-points CSV, ImageBind-score
JSON filtering, in-sync CSV filtering (``vggsound_dataset.py:126-167,
321-362``). Decoding uses the native libav module; bad media triggers the
retry-with-random-index policy (``:219-230``).
"""

from __future__ import annotations

import csv
import json
import logging
import zlib
from math import ceil, floor
from pathlib import Path
from typing import List, Optional

import numpy as np

from vaura_tpu_torch.data.core import DataLoader, DataModule, Dataset
from vaura_tpu_torch.data.transforms import build_transforms
from vaura_tpu_torch.data.vjepa import get_clip_indices

logger = logging.getLogger(__name__)
EPS = 0.01  # reference vggsound_dataset.py:24


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except (TypeError, ValueError):
        return False


def _clip_id(stem: str) -> str:
    """``{video_id}_{start_ms}_{end_ms}`` -> bare video id (ids may contain
    underscores, so strip exactly the two trailing numeric fields)."""
    return stem.rsplit("_", 2)[0]


class VggSoundDataset(Dataset):
    def __init__(
        self,
        split: str,
        split_dir_path: str | Path,
        data_path: str | Path,
        meta_path: str | Path,
        excluded_files_path: Optional[str | Path] = None,
        included_files_path: Optional[str | Path] = None,
        fixed_start_pts_file_path: Optional[str | Path] = None,
        video_length: float = 2.56,
        sample_rate_audio: int = 44100,
        sample_rate_video: float = 25.0,
        audio_transforms: Optional[list] = None,
        video_transforms: Optional[list] = None,
        run_additional_checks: bool = True,
        original_video_file_len: float = 10.0,
        frames_per_clip: int = 16,
        num_clips: int = 4,
        frame_step: int = 1,
        partition_audio_to_clips: bool = False,
        partition_video_to_clips: bool = True,
        filter_by_imagebind_score: bool = False,
        imagebind_score_threshold: float = 0.0,
        imagebind_score_file_path: Optional[str] = None,
        filter_by_insync: bool = False,
        insync_filter_key: str = "is_correct",
        insync_filter_threshold: int = -1,
        insync_file_path: Optional[str] = None,
        max_load_attempts: int = 10,
        codes_dir: Optional[str | Path] = None,
        deterministic_train_crops: bool = False,
        seed: int = 0,
        **_,
    ):
        split_dir_path = Path(split_dir_path)
        self.split = split
        self.split_file_path = (
            split_dir_path / f"{self._split_prefix(split_dir_path)}_{split}.txt"
        )
        assert self.split_file_path.is_file(), f"missing {self.split_file_path}"
        self.data_path = Path(data_path)
        self.meta_path = Path(meta_path)

        self.fixed_start_pts = {}
        if fixed_start_pts_file_path is not None:
            with open(fixed_start_pts_file_path, encoding="utf-8") as f:
                reader = csv.reader(f)
                next(reader)
                self.fixed_start_pts = {row[0]: float(row[1]) for row in reader}

        self.a_sr = sample_rate_audio
        self.v_sr = sample_rate_video
        self.video_len = video_length
        self.video_len_in_samples = ceil(video_length * sample_rate_video)
        self.audio_len_in_samples = ceil(video_length * sample_rate_audio)
        self.original_video_file_len = original_video_file_len
        self.frames_per_clip = frames_per_clip
        self.frame_step = frame_step
        self.num_clips = floor(
            (self.video_len_in_samples / frame_step) / frames_per_clip
        )
        self.partition_audio_to_clips = partition_audio_to_clips
        self.partition_video_to_clips = partition_video_to_clips
        self.max_load_attempts = max_load_attempts
        # precomputed DAC tokens (scripts/precompute_codes.py): training
        # consumes the `codes` batch key and skips the per-step frozen
        # encode (measured 274 -> 200 ms/step on v5e). Codes are crop-
        # aligned only for fixed start points — with random train crops
        # the npy must have been produced over the same crops.
        self.codes_dir = Path(codes_dir) if codes_dir else None
        self.deterministic_train_crops = bool(deterministic_train_crops)
        if (
            self.codes_dir is not None
            and split == "train"
            and not self.deterministic_train_crops
        ):
            # Random train crops re-sample every epoch, so codes encoded
            # from one crop silently mismatch the frames/audio they are
            # paired with. Fail fast: precompute_codes.py forces
            # deterministic crops for the train split; training with
            # codes_dir must opt into the same.
            raise ValueError(
                "codes_dir with the train split requires "
                "deterministic_train_crops=true so the precomputed codes "
                "align with the crops seen during training "
                "(scripts/precompute_codes.py sets it automatically)"
            )
        self.seed = seed
        # crc32, not hash(): str hash() is PYTHONHASHSEED-randomized, which
        # would make the per-split rng stream differ across processes
        self._rng = np.random.default_rng((seed, zlib.crc32(split.encode())))
        self.audio_transforms = build_transforms(audio_transforms)
        self.video_transforms = build_transforms(video_transforms)
        self.run_additional_checks = run_additional_checks

        # label map from meta CSV (id, start_sec, label) — keyed by bare
        # video id (reference vggsound_dataset.py:116-127)
        with self.meta_path.open() as f:
            meta_rows = list(csv.reader(f))[1:]
        unique = sorted({row[2] for row in meta_rows if len(row) > 2})
        self.label2target = {label: i for i, label in enumerate(unique)}
        self.target2label = {i: label for label, i in self.label2target.items()}
        self.video2target = {
            row[0]: self.label2target[row[2]] for row in meta_rows if len(row) > 2
        }

        with self.split_file_path.open(encoding="utf-8") as f:
            names = [line.strip() for line in f if line.strip()]
        names = self._restrict_split_names(names, meta_rows)
        files = [self._clip_path(n) for n in names]

        files = self._apply_file_filters(
            files,
            excluded_files_path,
            included_files_path,
            filter_by_imagebind_score,
            imagebind_score_threshold,
            imagebind_score_file_path,
            filter_by_insync,
            insync_filter_key,
            insync_filter_threshold,
            insync_file_path,
        )
        self.files = files
        if self.codes_dir is not None:
            # Every batch must carry a consistent key set: default_collate
            # iterates the first item's keys, so a per-item-optional
            # 'codes' key would either KeyError or silently drop codes for
            # the whole batch (and change the batch structure from one batch to the next).
            # Pre-scan and drop clips without a sidecar, loudly.
            with_codes = [
                f for f in files
                if (self.codes_dir / f"{f.stem}.codes.npy").exists()
            ]
            if len(with_codes) != len(files):
                logger.warning(
                    "codes_dir=%s: dropping %d/%d clips without a "
                    ".codes.npy sidecar (run scripts/precompute_codes.py "
                    "over the full split)",
                    self.codes_dir, len(files) - len(with_codes), len(files),
                )
            if not with_codes:
                raise FileNotFoundError(
                    f"codes_dir {self.codes_dir} has no .codes.npy sidecar "
                    f"for any of the {len(files)} {split} clips"
                )
            self.files = with_codes
            self._verify_codes_manifest()
        logger.info("%s split: %d files", split, len(self.files))

    # -------------------------------------------------------------- #
    def _crops_seed_dependent(self) -> bool:
        """Whether this split's crop windows depend on the dataset seed
        (deterministic train crops do; VggSound eval starts come from the
        fixed-start CSV and do not). Subclasses with seeded eval starts
        (GreatestHit) override."""
        return self.split == "train"

    def _verify_codes_manifest(self) -> None:
        """Precomputed codes are only aligned with this dataset's crops if
        the precompute run used the same crop parameters. precompute_codes
        writes ``codes_meta.<split>.json`` recording them; verify when
        present (old sidecar dirs without a manifest only get a warning)."""
        mf = self.codes_dir / f"codes_meta.{self.split}.json"
        if not mf.exists():
            logger.warning(
                "codes_dir=%s: no %s manifest — cannot verify that the "
                "precompute run used the same seed/video_length as this "
                "dataset (re-run scripts/precompute_codes.py to write one)",
                self.codes_dir, mf.name,
            )
            return
        m = json.loads(mf.read_text(encoding="utf-8"))
        problems = []
        if abs(float(m.get("video_len", self.video_len)) - self.video_len) > 1e-6:
            problems.append(
                f"video_length {m.get('video_len')} != {self.video_len}"
            )
        if self._crops_seed_dependent() and int(m.get("seed", self.seed)) != int(
            self.seed
        ):
            problems.append(f"seed {m.get('seed')} != {self.seed}")
        if problems:
            raise ValueError(
                f"codes_dir {self.codes_dir} was precomputed with different "
                f"crop parameters ({'; '.join(problems)}); the sidecar codes "
                "would silently pair with the wrong audio/frames — re-run "
                "scripts/precompute_codes.py with this config"
            )

    @staticmethod
    def _split_prefix(split_dir_path: Path) -> str:
        """Split files are ``{prefix}_{split}.txt`` (reference
        vggsound_dataset.py:63-66)."""
        return "vggsound" if "vggsound" in split_dir_path.name else "visualsound"

    def _restrict_split_names(self, names: List[str], meta_rows) -> List[str]:
        """clips = meta ∩ split: meta rows name a source video + start sec;
        the clip name is {id}_{start_ms}_{start+10s ms} (reference
        vggsound_dataset.py:126-133). Subclasses with a different membership
        policy (AudioSet keeps the split list as-is) override this."""
        meta_available = {
            f"{r[0]}_{int(float(r[1])) * 1000}_{(int(float(r[1])) + 10) * 1000}"
            for r in meta_rows
            if len(r) > 1 and _is_number(r[1])
        }
        if meta_available:
            names = [n for n in names if n in meta_available]
        return names

    def _clip_path(self, name: str) -> Path:
        return self.data_path / Path(name).with_suffix(".mp4").name

    def _apply_file_filters(
        self,
        files: List[Path],
        excluded,
        included,
        filter_ib,
        ib_threshold,
        ib_path,
        filter_insync,
        insync_key,
        insync_threshold,
        insync_path,
    ) -> List[Path]:
        def read_list(p) -> set:
            p = Path(p)
            out = set()
            if p.is_file():
                with open(p, encoding="utf-8") as f:
                    out |= {
                        Path(line.strip()).with_suffix(".mp4").name
                        for line in f
                        if line.strip()
                    }
            elif p.is_dir():
                # only *.txt line-lists count as exclusion files in a dir —
                # the reference dir also holds the ImageBind score JSONs,
                # which are consumed via imagebind_score_file_path instead
                # (reference vggsound_dataset.py:297-302)
                for sub in p.glob("*.txt"):
                    out |= read_list(sub)
            return out

        if excluded is not None:
            bad = read_list(excluded)
            files = [f for f in files if f.name not in bad]
        if included is not None:
            good = read_list(included)
            files = [f for f in files if f.name in good]
        if filter_ib and ib_path and self.split != "predict":
            # ImageBind AV-alignment score filtering: JSON {path: score};
            # exclude clips scoring below the threshold (keys may be full
            # paths — compare by stem; test/val kept comparable by applying
            # the same file; reference vggsound_dataset.py:142-153,321-327)
            with open(ib_path) as f:
                scores = json.load(f)
            bad = {Path(k).stem for k, v in scores.items() if v < ib_threshold}
            files = [f for f in files if f.stem not in bad]
        if filter_insync and insync_path and self.split != "predict":
            # Synchformer in-sync prediction filtering: header-less rows
            # vid,offset,vstart,is_correct,is_correct_within_1cls_tol —
            # several rows per vid; exclude when the per-vid SUM of the
            # chosen key falls below the threshold (defaults 25 train /
            # 5 eval; reference vggsound_dataset.py:155-162,329-362)
            insync_key = insync_key.lower()
            assert insync_key in ("is_correct", "is_correct_within_1cls_tol"), (
                f"invalid insync key {insync_key!r}"
            )
            if insync_threshold < 0:
                insync_threshold = 25 if self.split == "train" else 5
            col = 3 if insync_key == "is_correct" else 4
            totals: dict = {}
            with open(insync_path, encoding="utf-8") as f:
                for row in csv.reader(f):
                    if len(row) > col:
                        totals[row[0]] = totals.get(row[0], 0) + int(row[col])
            bad = {v for v, s in totals.items() if s < insync_threshold}
            files = [f for f in files if f.stem not in bad]
        return files

    def __len__(self) -> int:
        return len(self.files)

    def _start_pts(self, path: Path, duration: float) -> float:
        """Reference vggsound_dataset.py:205-214: train -> uniform random;
        eval -> fixed start point keyed by clip stem (0.0 when absent or
        when the crop covers most of the 10 s source, video_len > 5.12)."""
        if self.split == "train":
            hi = max(duration - self.video_len - EPS, 0.0)
            if self.deterministic_train_crops:
                # stable per-clip crop (process-independent: crc32, not
                # hash()) so precomputed codes and training see the same
                # frames/audio window every epoch
                r = np.random.default_rng(
                    (self.seed, zlib.crc32(path.stem.encode()))
                )
                return float(r.uniform(0, hi))
            return float(self._rng.uniform(0, hi))
        if self.video_len > 5.12:
            return 0.0
        return self.fixed_start_pts.get(path.stem, 0.0)

    def _load_one(self, path: Path):
        from vaura_tpu_torch.data import media

        info = media.probe(path)
        start = self._start_pts(path, info["duration"] or self.original_video_file_len)
        frames, audio, dec = media.read_video(
            path,
            start=start,
            duration=self.video_len + EPS,
            fps=self.v_sr,
            sample_rate=self.a_sr,
        )
        if frames is None or audio is None:
            raise RuntimeError(f"missing streams in {path}")
        if self.run_additional_checks:
            # FPS/SR contract check (reference vggsound_dataset.py:280-291)
            assert abs(dec["video_fps"] - self.v_sr) < 1.0, dec
            assert dec["audio_fps"] == self.a_sr, dec
        if frames.shape[0] < self.video_len_in_samples:
            raise RuntimeError(f"short video {path}: {frames.shape}")
        if audio.shape[-1] < self.audio_len_in_samples:
            raise RuntimeError(f"short audio {path}: {audio.shape}")
        frames = frames[: self.video_len_in_samples]
        audio = audio[:, : self.audio_len_in_samples]
        return frames, audio.astype(np.float32), start

    def __getitem__(self, idx: int) -> dict:
        for _ in range(self.max_load_attempts):
            path = self.files[idx]
            try:
                frames, audio, start = self._load_one(path)
                break
            except Exception as e:
                logger.warning("failed to load %s (%s); resampling", path.name, e)
                idx = int(self._rng.integers(0, len(self)))
        else:
            raise RuntimeError(
                f"no loadable video after {self.max_load_attempts} attempts"
            )

        if self.audio_transforms is not None:
            audio = self.audio_transforms(audio)
        if self.video_transforms is not None:
            frames = self.video_transforms(frames)
            if frames.shape[-1] == 3:  # transforms left channels-last
                frames = np.transpose(frames, (3, 0, 1, 2))
            frames = np.ascontiguousarray(frames, dtype=np.float32)
        else:
            frames = np.transpose(frames, (3, 0, 1, 2)).astype(np.float32) / 255.0

        meta = {
            "filepath": str(path),
            "target": self.video2target.get(_clip_id(path.stem), -1),
            "start_pts": start,
            "video_fps": self.v_sr,
            "audio_fps": self.a_sr,
        }
        if self.partition_video_to_clips:
            from vaura_tpu_torch.data.vjepa import partition_video

            frames = partition_video(
                frames, self.frames_per_clip, self.frame_step, self.num_clips
            )
            meta["clip_indices"] = get_clip_indices(
                self.num_clips * self.frames_per_clip * self.frame_step,
                self.num_clips,
                self.frames_per_clip,
                self.frame_step,
            )
        if self.partition_audio_to_clips:
            from vaura_tpu_torch.data.vjepa import partition_audio

            audio = partition_audio(
                audio, self.frames_per_clip, self.frame_step, self.v_sr, self.a_sr,
                self.num_clips,
            )
        item = {"frames": frames, "audio": audio, "meta": meta}
        if self.codes_dir is not None:
            # membership pre-scanned in __init__, so the key set is
            # consistent across every item of a batch
            cp = self.codes_dir / f"{path.stem}.codes.npy"
            item["codes"] = np.load(cp).astype(np.int32)
        return item


class VggSoundDataModule(DataModule):
    """Reference ``vggsound_datamodule.py``: all four splits, per-split
    transform stacks, predict loader with batch 1. Accepts the reference's
    config parameter names (``data_dir``/``split_dir``/``meta_file``/...)."""

    dataset_cls = VggSoundDataset

    def __init__(
        self,
        batch_size: int,
        num_workers: int = 0,
        seed: int = 0,
        data_dir: Optional[str] = None,
        split_dir: Optional[str] = None,
        meta_file: Optional[str] = None,
        excluded_files: Optional[str] = None,
        included_files: Optional[str] = None,
        fixed_start_pts_file: Optional[str] = None,
        audio_transforms_train: Optional[list] = None,
        audio_transforms_test: Optional[list] = None,
        video_transforms_train: Optional[list] = None,
        video_transforms_test: Optional[list] = None,
        video_length: float = 2.56,
        **kwargs,
    ):
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.seed = seed
        self.paths = dict(
            data_path=data_dir,
            split_dir_path=split_dir,
            meta_path=meta_file,
            excluded_files_path=excluded_files,
            included_files_path=included_files,
            fixed_start_pts_file_path=fixed_start_pts_file,
        )
        self.transforms = {
            "train": (audio_transforms_train, video_transforms_train),
            "eval": (audio_transforms_test, video_transforms_test),
        }
        self.video_length = video_length
        # drop torch-dataloader-only knobs
        kwargs.pop("pin_memory", None)
        kwargs.pop("samples_per_video", None)
        kwargs.pop("dataset_to_use", None)
        kwargs.pop("rand_transform_prob", None)
        self.kwargs = kwargs
        self.datasets = {}

    def setup(self, stage: Optional[str] = None) -> None:
        for split in ["train", "validation", "test", "predict"]:
            a_tf, v_tf = self.transforms["train" if split == "train" else "eval"]
            try:
                self.datasets[split] = self.dataset_cls(
                    split=split if split != "predict" else "test",
                    seed=self.seed,
                    video_length=self.video_length,
                    audio_transforms=a_tf,
                    video_transforms=v_tf,
                    **self.paths,
                    **self.kwargs,
                )
            except (AssertionError, TypeError) as e:
                if stage is not None and str(stage).startswith(split):
                    raise

    def train_dataloader(self) -> DataLoader:
        return DataLoader(
            self.datasets["train"], self.batch_size, shuffle=True,
            seed=self.seed, num_workers=self.num_workers,
        )

    def val_dataloader(self) -> DataLoader:
        return DataLoader(
            self.datasets["validation"], self.batch_size,
            num_workers=self.num_workers,
        )

    def test_dataloader(self) -> DataLoader:
        return DataLoader(
            self.datasets["test"], self.batch_size, num_workers=self.num_workers
        )

    def predict_dataloader(self) -> DataLoader:
        return DataLoader(self.datasets["predict"], 1)
