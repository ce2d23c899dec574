"""The port's remaining datamodules against ``vaura_tpu.data``: ``audioset``,
``greatesthit`` (split-file datasets, subclasses of the VGGSound one),
``vjepa``, ``vjepa_gen``, ``motionformer`` and ``motionformer_gen`` (JSONL
metadata datasets), each built through ``get_datamodule_from_type`` on both
sides from one dataloader config and one seed, and ``generate_metadata``'s
``probe_to_meta``, on synthetic MP4s written with the native media module
(skipped where it is unavailable, as ``tests/test_torch_data.py`` is). Both
packages compute in numpy: every batch of every split must be equal. The
random crops of the train splits draw from python's ``random`` (the
segment transform) and from each dataset's seeded numpy generator; python's
is seeded alike before each side's pass."""

import csv
import random

import numpy as np
import pytest

from vaura_tpu.data import get_datamodule_from_type as j_get
from vaura_tpu.data import media as j_media
from vaura_tpu_torch.data import get_datamodule_from_type as t_get
from vaura_tpu_torch.data import media as t_media

from torch_port_util import assert_same

SR = 44100
TRANSFORMS = [
    {"target": "vaura_tpu.data.transforms.Resize", "params": {"size": 40}},
    {"target": "vaura_tpu.data.transforms.CenterCrop",
     "params": {"size": [32, 32]}},
    {"target": "vaura_tpu.data.transforms.ToFloat32DType"},
]


@pytest.fixture(scope="module")
def media_ok():
    if not t_media.available():
        pytest.skip("native media module unavailable")


def _write_clip(path, seconds, seed):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, size=(int(seconds * 25), 48, 48, 3),
                          dtype=np.uint8)
    audio = (rng.standard_normal(int(seconds * SR)) * 0.1).astype(np.float32)
    path.parent.mkdir(parents=True, exist_ok=True)
    j_media.write_video(path, frames, fps=25.0, audio=audio,
                        audio_sample_rate=SR)


@pytest.fixture(scope="module")
def roots(tmp_path_factory, media_ok):
    """Synthetic datasets of the three layouts: AudioSet (split entries with
    a subdirectory, a label CSV), Greatest Hits (split basenames that expand
    to ``_denoised`` clips, an annotation CSV) and JSONL metadata of 2.4 s
    clips, with a CSV of fixed start points."""
    from vaura_tpu.data.generate_metadata import write_meta_file

    root = tmp_path_factory.mktemp("datasets")
    # AudioSet
    aset = root / "audioset"
    names = [f"balanced_train_segments/vid{i}_0_10000" for i in range(3)]
    for i, n in enumerate(names):
        _write_clip(aset / "videos" / f"{n}.mp4", 1.6, i)
    (aset / "splits" / "audioset").mkdir(parents=True)
    for split in ("train", "validation", "test"):
        (aset / "splits" / "audioset" / f"audioset_{split}.txt").write_text(
            "\n".join(names) + "\n")
    (aset / "meta").mkdir()
    (aset / "meta" / "audioset.csv").write_text("filename,start,label\n")
    with open(aset / "meta" / "audioset_labels.csv", "w", newline="") as f:
        csv.writer(f).writerows([["0", "/m/09x0r", "Speech"],
                                 ["1", "/m/05zppz", "Male speech"]])
    # the eval splits start at 6.66 s unless pinned: pin inside the clips
    with open(aset / "fixed.csv", "w", newline="") as f:
        csv.writer(f).writerows([["file", "start_sec"]] + [
            [n.rsplit("/", 1)[1], 0.3 * i] for i, n in enumerate(names)])
    # Greatest Hits
    gh = root / "greatesthit"
    base = "2015-02-16-16-49-06"
    clips = [f"{base}_denoised_{i}.mp4" for i in (1, 2)]
    for i, c in enumerate(clips):
        _write_clip(gh / "videos" / c, 1.6, 10 + i)
    _write_clip(gh / "videos" / f"{base}_raw.mp4", 1.6, 12)
    (gh / "splits" / "greatesthit").mkdir(parents=True)
    for split in ("train", "validation", "test", "predict"):
        (gh / "splits" / "greatesthit" / f"greatesthit_{split}.txt"
         ).write_text(base + "\n")
    with open(gh / "greatesthit.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["filename", "start_time", "occurring_time", "end_time",
                    "material", "action_type", "effect"])
        w.writerow([clips[0], 0.38, 1.38, 2.38, "grass", "scratch", "scatter"])
        w.writerow([clips[1], 0.92, 1.92, 2.92, "dirt", "hit", "deform"])
    # JSONL metadata
    vid = root / "videos"
    for i in range(3):
        _write_clip(vid / f"v{i}.mp4", 2.4, 20 + i)
    write_meta_file(sorted(vid.glob("*.mp4")), vid / "data.jsonl")
    with open(root / "fixed.csv", "w", newline="") as f:
        csv.writer(f).writerows([["v1.mp4", 0.52], ["v2.mp4", 1.0]])
    return {"audioset": aset, "greatesthit": gh, "videos": vid,
            "fixed": root / "fixed.csv"}


def _config(kind, roots):
    split_file = {"batch_size": 1, "seed": 3, "video_length": 0.64,
                  "frames_per_clip": 16, "num_clips": 1,
                  "run_additional_checks": False,
                  "original_video_file_len": 1.6,
                  "video_transforms_train": TRANSFORMS,
                  "video_transforms_test": TRANSFORMS}
    jsonl = {"batch_size": 1, "seed": 3, "data_dir": str(roots["videos"]),
             "sample_duration": 1.28, "frames_per_clip": 16}
    return {
        "audioset": dict(split_file, dataset_type="audioset",
                         data_dir=str(roots["audioset"] / "videos"),
                         split_dir=str(roots["audioset"] / "splits" / "audioset"),
                         meta_file=str(roots["audioset"] / "meta" / "audioset.csv"),
                         fixed_start_pts_file=str(roots["audioset"]
                                                  / "fixed.csv")),
        "greatesthit": dict(split_file, dataset_type="greatesthit",
                            data_dir=str(roots["greatesthit"] / "videos"),
                            split_dir=str(roots["greatesthit"] / "splits"
                                          / "greatesthit"),
                            meta_file=str(roots["greatesthit"]
                                          / "greatesthit.csv")),
        "vjepa": dict(jsonl, dataset_type="vjepa",
                      partition_audio_to_clips=True),
        "vjepa_gen": dict(jsonl, dataset_type="vjepa_gen",
                          fixed_start_pts_csv=str(roots["fixed"])),
        "motionformer": dict(jsonl, dataset_type="motionformer",
                             partition_audio_to_clips=True),
        "motionformer_gen": dict(jsonl, dataset_type="motionformer_gen",
                                 fixed_start_pts_csv=str(roots["fixed"])),
    }[kind]


KINDS = ["audioset", "greatesthit", "vjepa", "vjepa_gen", "motionformer",
         "motionformer_gen"]


@pytest.mark.parametrize("kind", KINDS)
def test_datamodule_batches_match_jax(roots, kind):
    cfg = _config(kind, roots)
    j = j_get(cfg["dataset_type"], cfg)
    t = t_get(cfg["dataset_type"], cfg)
    assert type(t).__name__ == type(j).__name__
    j.setup()
    t.setup()
    assert sorted(t.datasets) == sorted(j.datasets)
    n_items = 0
    for name in ("train_dataloader", "val_dataloader", "test_dataloader",
                 "predict_dataloader"):
        if name.split("_")[0].replace("val", "validation") not in j.datasets:
            continue
        jl, tl = getattr(j, name)(), getattr(t, name)()
        for loader in (jl, tl):
            loader.set_epoch(1)
        assert len(tl) == len(jl)
        random.seed(7)
        want = list(jl)
        random.seed(7)
        got = list(tl)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_same(a, b)
        n_items += len(got)
    assert n_items >= 4


def test_probe_to_meta_matches_jax(roots):
    from vaura_tpu.data.generate_metadata import probe_to_meta as j_probe
    from vaura_tpu_torch.data.generate_metadata import (
        probe_to_meta,
        write_meta_file,
    )

    for p in sorted(roots["videos"].glob("*.mp4")):
        got = probe_to_meta(p)
        assert got == j_probe(p)
        assert got["audio_fps"] == SR and got["video_width"] == 48
    assert probe_to_meta(roots["videos"] / "missing.mp4") is None
    out = roots["videos"] / "port.jsonl"
    assert write_meta_file(sorted(roots["videos"].glob("*.mp4")), out) == 3
    assert out.read_text() == (roots["videos"] / "data.jsonl").read_text()
