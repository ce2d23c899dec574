"""The port's data layer against ``vaura_tpu.data``: the dummy datamodule's
batches under one seed (serial, thread and process workers), every
transform on seeded arrays (the random ones with python's and numpy's
generators seeded alike on both sides), ``build_transforms`` from the
repo's config lists, the clip partitioning, and ``VggSoundDataset`` /
``VideoDataset`` on synthetic MP4s written with the native media module
(skipped where it is unavailable, as ``tests/test_media.py`` is). Both
packages compute in numpy, so the results must be equal."""

import csv
import random

import numpy as np
import pytest

from vaura_tpu.data import dummy as JD
from vaura_tpu.data import media as j_media
from vaura_tpu.data import transforms as JT
from vaura_tpu.data import vjepa as JV
from vaura_tpu_torch import data as t_data
from vaura_tpu_torch.data import dummy as TD
from vaura_tpu_torch.data import media as t_media
from vaura_tpu_torch.data import transforms as TT
from vaura_tpu_torch.data import vjepa as TV
from torch_port_util import assert_same



@pytest.fixture(scope="module")
def media_ok():
    """Skip where the native media module is unavailable, as
    ``tests/test_media.py`` does; decided here and not while the module is
    imported (the port's loader builds the library once, under a lock, when
    several workers reach it together)."""
    if not t_media.available():
        pytest.skip("native media module unavailable")


DUMMY = dict(batch_size=3, seed=5, sample_rate_audio=150, frame_shape=(8, 8),
             num_clips=2, video_length=1.28)


@pytest.mark.parametrize("workers,worker_type", [(0, "thread"), (2, "thread"),
                                                 (2, "process")])
def test_dummy_batches_match_jax(workers, worker_type):
    j = JD.DummyDataModule(num_workers=workers, **DUMMY)
    t = TD.DummyDataModule(num_workers=workers, **DUMMY)
    j.setup("fit")
    t.setup("fit")
    for name in ("train_dataloader", "val_dataloader", "test_dataloader",
                 "predict_dataloader"):
        jl, tl = getattr(j, name)(), getattr(t, name)()
        jl.worker_type = tl.worker_type = worker_type
        tl.set_epoch(3)
        jl.set_epoch(3)
        assert len(jl) == len(tl)
        n = 0
        for a, b in zip(jl, tl):  # to the end: the workers stop with it
            assert_same(a, b)
            n += 1
        assert n == len(tl)


def _lazy_target(factory):
    """``(module path, attribute)`` of a registry entry made by ``_lazy``."""
    cells = dict(zip(factory.__code__.co_freevars,
                     (c.cell_contents for c in factory.__closure__)))
    return cells["modpath"], cells["attr"]


def test_datamodule_registry():
    dm = t_data.get_datamodule_from_type("dummy", {"dataset_type": "dummy",
                                                   "batch_size": 1})
    assert isinstance(dm, TD.DummyDataModule)
    with pytest.raises(ValueError, match="Unknown dataset_type"):
        t_data.get_datamodule_from_type("nope", {"batch_size": 1})
    import importlib

    from vaura_tpu.data import DATALOADER_TYPES as J_TYPES

    assert set(t_data.DATALOADER_TYPES) == set(J_TYPES)
    # every lazily imported type names the port's module and class of the
    # JAX package's own (``tests/test_torch_data_more.py`` holds their items)
    for name, factory in t_data.DATALOADER_TYPES.items():
        if name == "dummy":
            continue
        mod, attr = _lazy_target(factory)
        j_mod, j_attr = _lazy_target(J_TYPES[name])
        assert (mod, attr) == (j_mod.replace("vaura_tpu.", "vaura_tpu_torch."),
                               j_attr), name
        assert issubclass(getattr(importlib.import_module(mod), attr),
                          t_data.DataModule), name


def _video(seed=0, shape=(6, 30, 40, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


VIDEO_CASES = [
    ("Resize", dict(size=24), {}),
    ("Resize", dict(size=[20, 16]), {}),
    ("Resize", dict(size=17, channels_last=False), dict(chw=True)),
    ("CenterCrop", dict(size=[20, 24]), {}),
    ("CenterCrop", dict(size=16, channels_last=False), dict(chw=True)),
    ("RandomCrop", dict(size=[20, 24]), {}),
    ("RandomHorizontalFlip", dict(p=0.5), {}),
    ("RandomHorizontalFlip", dict(p=1.0, channels_last=False), dict(chw=True)),
    ("ToFloat32DType", {}, {}),
    ("ToFloat32DType", dict(scale=False), {}),
    ("Div255", {}, {}),
    ("Normalize", dict(mean=[0.5, 0.4, 0.3], std=[0.2, 0.3, 0.4]), {}),
    ("Permute", dict(dims=[3, 0, 1, 2]), {}),
    ("Permute", dict(permutation=[0, 3, 1, 2]), {}),
    ("UniformTemporalSubsample", dict(target_fps=2, clip_duration=2.0), {}),
    ("RandomNullify", dict(p=0.5), {}),
]


@pytest.mark.parametrize("name,kw,opts", VIDEO_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(VIDEO_CASES)])
def test_video_transforms_match_jax(name, kw, opts):
    for seed in range(4):
        x = _video(seed)
        if opts.get("chw"):
            x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
        random.seed(seed)
        want = getattr(JT, name)(**kw)(x)
        random.seed(seed)
        got = getattr(TT, name)(**kw)(x)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_generate_multiple_segments_matches_jax():
    for start_random in (False, True):
        for seed in range(3):
            item = lambda: {
                "video": _video(seed, (40, 4, 4, 3)),
                "audio": np.random.default_rng(seed).standard_normal(16000),
                "meta": {"video": {"fps": [25]},
                         "audio": {"framerate": [10000]}},
            }
            kw = dict(segment_size_vframes=8, n_segments=3,
                      is_start_random=start_random, audio_jitter_sec=0.05,
                      step_size_seg=0.5)
            random.seed(seed)
            want = JT.GenerateMultipleSegments(**kw)(item(), segment_a=True)
            random.seed(seed)
            got = TT.GenerateMultipleSegments(**kw)(item(), segment_a=True)
            assert_same(got, want)


AUDIO_CASES = [
    ("AudioStandardNormalize", {}),
    ("AudioLoudnessNormalize", dict(target_loudness=-20.0)),
    ("AudioStereoToMono", {}),
    ("AudioStereoToMono", dict(keepdim=False)),
    ("AudioResample", dict(orig_freq=16000, new_freq=8000)),
    ("AudioResample", dict(target_sr=8000, clip_duration=0.5)),
    ("AudioTrim", dict(max_len_sec=0.1, sample_rate=16000)),
    ("AudioTrim", dict(duration=0.2, sr=16000)),
    ("AudioUnsqueeze", {}),
    ("AudioRandomVolume", dict(p=0.7, gain=2.0)),
    ("AudioRandomVolume", dict(p=1.0, gain=6.0, gain_type="db")),
    ("AudioLowpassFilter", dict(p=1.0, cutoff_freq=2000, sample_rate=16000)),
    ("AudioGaussNoise", dict(p=0.7)),
    ("AudioPitchShift", dict(p=1.0, shift=3, sample_rate=16000)),
    ("AudioReverb", dict(p=1.0, sample_rate=16000)),
    ("AudioPhaser", dict(p=1.0, sample_rate=16000)),
]


@pytest.mark.parametrize("name,kw", AUDIO_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(AUDIO_CASES)])
def test_audio_transforms_match_jax(name, kw):
    wav = (0.3 * np.random.default_rng(9).standard_normal((2, 8000))).astype(
        np.float32)
    for seed in range(3):
        random.seed(seed)
        np.random.seed(seed)
        want = getattr(JT, name)(**kw)(wav)
        random.seed(seed)
        np.random.seed(seed)
        got = getattr(TT, name)(**kw)(wav)
        np.testing.assert_array_equal(got, want)


def test_build_transforms_from_the_repo_configs_matches_jax():
    """The video lists of ``configs/generate_vgg.yaml`` and
    ``configs/generate_vas.yaml`` (with reference-name aliases too)."""
    from pathlib import Path

    from vaura_tpu_torch.config import load_config

    repo = Path(__file__).resolve().parents[1]
    lists = [load_config(repo / "configs/generate_vgg.yaml",
                         repo)["dataloader"]["video_transforms_test"],
             load_config(repo / "configs/generate_vas.yaml",
                         repo)["dataloader"]["video_transforms"],
             [{"target": "torchvision.transforms.v2.Resize",
               "params": {"size": 36}},
              {"target": "torchvision.transforms.v2.CenterCrop",
               "params": {"size": 32}},
              {"target": "models.data.transforms.video_transforms."
                         "ToFloat32DType"}]]
    x = _video(3, (50, 60, 80, 3))
    for cfg_list in lists:
        got = TT.build_transforms(cfg_list)(x)
        want = JT.build_transforms(cfg_list)(x)
        np.testing.assert_array_equal(got, want)
    assert TT.build_transforms([]) is None


@pytest.mark.parametrize("args", [
    (64, 4, 16, 1), (40, 4, 16, 1), (100, 2, 8, 2), (20, 3, 16, 1),
    (64, 4, 16, 1, False, False), (30, 3, 16, 2, False, False),
])
def test_clip_partitioning_matches_jax(args):
    np.testing.assert_array_equal(TV.get_clip_indices(*args),
                                  JV.get_clip_indices(*args))
    video = _video(1, (3, 70, 4, 4))
    np.testing.assert_array_equal(TV.partition_video(video, 16, 2, 2),
                                  JV.partition_video(video, 16, 2, 2))
    audio = np.random.default_rng(0).standard_normal((1, 44100))
    np.testing.assert_array_equal(
        TV.partition_audio(audio, 16, 1, 25.0, 16000, 2),
        JV.partition_audio(audio, 16, 1, 25.0, 16000, 2))


# --------------------------------------------------------------------------
# datasets over synthetic MP4s
@pytest.fixture(scope="module")
def vgg_root(tmp_path_factory, media_ok):
    """Three 1.6 s clips named as the reference names them
    (``{id}_{start_ms}_{end_ms}``), split files, a meta CSV and a fixed
    start point (``tests/test_vggsound_integration.py``)."""
    root = tmp_path_factory.mktemp("vgg")
    data_dir = root / "videos"
    data_dir.mkdir()
    rng = np.random.default_rng(0)
    names = [f"vid{i}_0_10000" for i in range(3)]
    for name in names:
        frames = rng.integers(0, 255, size=(40, 64, 64, 3), dtype=np.uint8)
        audio = (rng.standard_normal(int(1.6 * 44100)) * 0.1).astype(np.float32)
        j_media.write_video(data_dir / f"{name}.mp4", frames, fps=25.0,
                            audio=audio, audio_sample_rate=44100)
    split_dir = root / "splits" / "vggsound"
    split_dir.mkdir(parents=True)
    for split in ("train", "test"):
        (split_dir / f"vggsound_{split}.txt").write_text("\n".join(names) + "\n")
    with open(root / "meta.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "start", "label"])
        for i, name in enumerate(names):
            w.writerow([name.rsplit("_", 2)[0], 0, f"class_{i % 2}"])
    with open(root / "fixed.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["file", "start_sec"])
        w.writerow(["vid0_0_10000", 0.2])
    return root


@pytest.mark.parametrize("split", ["train", "test"])
def test_vggsound_dataset_matches_jax(vgg_root, split):
    from vaura_tpu.data.vggsound import VggSoundDataset as J
    from vaura_tpu_torch.data.vggsound import VggSoundDataset as T

    kw = dict(split=split, split_dir_path=vgg_root / "splits" / "vggsound",
              data_path=vgg_root / "videos", meta_path=vgg_root / "meta.csv",
              fixed_start_pts_file_path=vgg_root / "fixed.csv",
              video_length=0.64, frames_per_clip=16, run_additional_checks=False,
              seed=0, video_transforms=[
                  {"target": "vaura_tpu.data.transforms.Resize",
                   "params": {"size": 40}},
                  {"target": "vaura_tpu.data.transforms.CenterCrop",
                   "params": {"size": [32, 32]}},
                  {"target": "vaura_tpu.data.transforms.ToFloat32DType"}])
    j, t = J(**kw), T(**kw)
    assert [p.name for p in t.files] == [p.name for p in j.files]
    assert len(t) == 3
    for i in range(len(t)):
        got, want = t[i], j[i]
        assert got["frames"].shape == (1, 3, 16, 32, 32)
        assert_same(got, want)


def test_video_dataset_matches_jax(tmp_path, media_ok):
    from vaura_tpu.data.generate_metadata import write_meta_file
    from vaura_tpu.data.video_dataset import VideoDataset as J
    from vaura_tpu_torch.data.video_dataset import VideoDataset as T

    rng = np.random.default_rng(1)
    for i in range(2):
        frames = rng.integers(0, 255, size=(60, 48, 48, 3), dtype=np.uint8)
        audio = (rng.standard_normal(int(2.4 * 44100)) * 0.1).astype(np.float32)
        j_media.write_video(tmp_path / f"v{i}.mp4", frames, fps=25.0,
                            audio=audio, audio_sample_rate=44100)
    write_meta_file(sorted(tmp_path.glob("*.mp4")), tmp_path / "data.jsonl")
    for split in ("test", "train"):
        kw = dict(split=split, sample_duration=1.28, seed=3)
        j = J.from_meta_file(tmp_path, **kw)
        t = T.from_meta_file(tmp_path, **kw)
        assert len(t) == len(j) == 2
        for i in range(2):
            assert_same(t[i], j[i])
