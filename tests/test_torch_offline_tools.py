"""The port's host tools (``vaura_tpu_torch/scripts/``) against the JAX
package's scripts on the same inputs, through their CLIs:

* ``preprocess_greatest_hit`` (each tactic), ``generate_video`` and
  ``reencode_videos`` on synthetic media, as ``tests/test_offline_tools.py``
  and ``tests/test_bridges_reencode.py::test_reencode_cli_contract`` drive
  the JAX ones: the same files, the same decoded frames and audio (up to
  the video encoder's run-to-run variation, ``_assert_same_media``);
* ``make_demo_assets``: the same files, JSONL and score JSON, the same
  source frames and audio, and the same decoded clips (cut to 1 s, over a
  small split list);
* ``convert_checkpoints`` (``vaura``, ``dac``, ``avclip``) on a synthetic
  reference checkpoint: the tensors of the JAX converter through
  ``from_jax_params``, in a checkpoint ``load_state`` and ``ckpt_path=``
  read;
* ``io_overlap_bench --tiny --device cpu``: the JAX tool's JSON keys.

Whether the native media library is there is decided in a fixture, when a
test runs, not at import: several workers that collect at once cannot race
its build into a skip.
"""

import json
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FPS = 25.0
SR = 44100


@pytest.fixture
def media():
    from vaura_tpu_torch.data import media

    if not media.available():
        pytest.skip("native media module unavailable")
    return media


def _run_jax_cli(module_main, argv) -> None:
    old = sys.argv
    sys.argv = argv
    try:
        module_main()
    finally:
        sys.argv = old


def _time_coded_video(media, path: Path, seconds: float) -> None:
    """Every frame's red channel equals its frame index (mod 250)."""
    n, h, w = int(seconds * FPS), 64, 96
    t = (np.arange(n)[:, None, None] % 250).astype(np.uint8)
    red = np.broadcast_to(t, (n, h, w))
    frames = np.stack([red, np.zeros_like(red), np.zeros_like(red)], axis=-1)
    audio = (0.1 * np.sin(2 * np.pi * 440 * np.arange(int(seconds * SR)) / SR)
             ).astype(np.float32)
    media.write_video(path, frames.copy(), fps=FPS, audio=audio,
                      audio_sample_rate=SR)


def _assert_same_media(media, a: Path, b: Path) -> None:
    """The same decoded clip up to the encoder's run-to-run variation:
    libx264's threads make two encodes of the same frames differ by
    0.05-0.2 levels on average (up to 22 at a pixel) where each lies ~3
    levels from its source, so the mean distance is held under 1 level; a
    clip cut from another window or muxed with another track is tens of
    levels (or the tone's amplitude) away."""
    fa, aa, _ = media.read_video(a, sample_rate=SR)
    fb, ab, _ = media.read_video(b, sample_rate=SR)
    assert fa.shape == fb.shape and aa.shape == ab.shape
    assert np.abs(fa.astype(np.float64) - fb).mean() < 1.0
    assert np.abs(aa.astype(np.float64) - ab).mean() < 1e-3


def _assert_same_dirs(media, a: Path, b: Path) -> None:
    names = sorted(p.name for p in a.iterdir())
    assert names and names == sorted(p.name for p in b.iterdir())
    for name in names:
        _assert_same_media(media, a / name, b / name)


@pytest.mark.parametrize("tactic", ["annotations", "dummy", "random"])
def test_preprocess_greatest_hit_matches_jax(media, tmp_path, tactic):
    from scripts.preprocess_greatest_hit import main as jax_main
    from vaura_tpu_torch.scripts.preprocess_greatest_hit import main

    src = tmp_path / "src"
    src.mkdir()
    _time_coded_video(media, src / "vid1_denoised.mp4", 8.0)
    # two in-range hits (one early: its start clamps to 0) + one past EOF
    (src / "vid1_times.txt").write_text(
        "0.5 wood hit\n4.0 metal scratch\n99.0 x y\n")
    flags = ["--tactic", tactic, "--clip-duration", "2.56", "--min-side",
             "48", "--clips-per-video", "2"]
    _run_jax_cli(jax_main, ["preprocess_greatest_hit.py", str(src),
                            str(tmp_path / "jax"), *flags])
    main([str(src), str(tmp_path / "port"), *flags])
    _assert_same_dirs(media, tmp_path / "jax", tmp_path / "port")
    if tactic == "annotations":
        assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
            "vid1_denoised_0_wood_hit.mp4",
            "vid1_denoised_1_metal_scratch.mp4"]


def test_generate_video_matches_jax(media, tmp_path):
    from scripts.generate_video import main as jax_main
    from vaura_tpu_torch.scripts.generate_video import main

    vid_dir, wav_dir = tmp_path / "v", tmp_path / "w"
    vid_dir.mkdir(), wav_dir.mkdir()
    _time_coded_video(media, vid_dir / "clip.mp4", 2.0)
    gen = (0.2 * np.sin(2 * np.pi * 880 * np.arange(int(2.0 * SR)) / SR)
           ).astype(np.float32)
    with wave.open(str(wav_dir / "clip.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((gen * 32767).astype(np.int16).tobytes())
    # a WAV with no source video is skipped, not fatal
    (wav_dir / "orphan.wav").write_bytes((wav_dir / "clip.wav").read_bytes())
    _run_jax_cli(jax_main, ["generate_video.py", str(vid_dir), str(wav_dir),
                            str(tmp_path / "jax")])
    main([str(vid_dir), str(wav_dir), str(tmp_path / "port")])
    assert [p.name for p in (tmp_path / "port").iterdir()] == ["clip.mp4"]
    _assert_same_dirs(media, tmp_path / "jax", tmp_path / "port")


def test_reencode_videos_matches_jax(media, tmp_path):
    from scripts.reencode_videos import main as jax_main
    from vaura_tpu_torch.scripts.reencode_videos import main

    src = tmp_path / "in"
    src.mkdir()
    # off-contract source: 30 fps, 160x120, 22.05 kHz audio
    n, h, w, sr = 45, 120, 160, 22050
    base = np.random.default_rng(0).integers(0, 255, (1, h, w, 3),
                                             dtype=np.uint8)
    frames = np.broadcast_to(base, (n, h, w, 3)).copy()
    audio = (0.1 * np.sin(2 * np.pi * 440 * np.arange(int(1.5 * sr)) / sr)
             ).astype(np.float32)
    for name in ("a.mp4", "b.mp4"):
        media.write_video(src / name, frames, fps=30.0, audio=audio,
                          audio_sample_rate=sr)
    flags = ["--min-side", "64", "--workers", "1"]
    _run_jax_cli(jax_main, ["reencode_videos.py", str(src),
                            str(tmp_path / "jax"), *flags])
    main([str(src), str(tmp_path / "port"), *flags])
    for name in ("a.mp4", "b.mp4"):
        info = media.probe(tmp_path / "port" / name)
        assert info["has_video"] and info["has_audio"]
        assert info["audio_sample_rate"] == 44100
        assert min(info["width"], info["height"]) == 64
        assert info["video_fps"] == pytest.approx(25.0, rel=0.05)
    _assert_same_dirs(media, tmp_path / "jax", tmp_path / "port")


def test_make_demo_assets_matches_jax(media, tmp_path, monkeypatch):
    """Both tools over the same split lists, every clip cut to 1 s: the
    same file tree, JSONL lines, score JSON bytes and decoded clips."""
    import scripts.make_demo_assets as J
    from vaura_tpu_torch.scripts import make_demo_assets as T

    for mod in (J, T):
        make_clip = mod.make_clip
        monkeypatch.setattr(
            mod, "make_clip",
            lambda path, seed, seconds, fps, hw, sr, make_clip=make_clip:
            make_clip(path, seed, 1.0, fps, hw, sr))
    roots = {}
    for tag, mod, run in (("jax", J, lambda root: _run_jax_cli(
            J.main, ["make_demo_assets.py", "--root", str(root)])),
            ("port", T, lambda root: T.main(["--root", str(root)]))):
        root = tmp_path / tag / "data"
        for ds, names in (("vggsound", ["a_0_1", "b_2_3"]),
                          ("visualsound", ["c_4_5"]),
                          ("audioset", ["d_6_7", "e_8_9"])):
            split = root / "splits" / ds
            split.mkdir(parents=True)
            (split / f"{ds}_test.txt").write_text("\n".join(names) + "\n")
        run(root)
        roots[tag] = root
    files = {tag: sorted(str(p.relative_to(root)) for p in root.rglob("*")
                         if p.is_file())
             for tag, root in roots.items()}
    assert files["jax"] == files["port"]
    assert len([f for f in files["port"] if f.endswith(".mp4")]) == 7
    for rel in files["port"]:
        a, b = roots["jax"] / rel, roots["port"] / rel
        if rel.endswith(".mp4"):
            _assert_same_media(media, a, b)
        else:  # JSONL (filepaths relative to the root's parent), JSON
            assert a.read_bytes() == b.read_bytes(), rel
    lines = (roots["port"] / "demo/test/data.jsonl").read_text().splitlines()
    assert json.loads(lines[0])["filepath"].startswith("data/demo/")
    # what the clips encode is the same, exactly
    for seed in (100, 201):
        np.testing.assert_array_equal(T._pattern_frames(seed, 30, 288, 384),
                                      J._pattern_frames(seed, 30, 288, 384))
        np.testing.assert_array_equal(T._event_audio(seed + 1, 10.0, SR),
                                      J._event_audio(seed + 1, 10.0, SR))


@pytest.fixture(scope="module")
def reference_ckpt(tmp_path_factory):
    from torch_reference_util import BEST, write_reference_experiment

    root = write_reference_experiment(tmp_path_factory.mktemp("ref_exp"))
    return root, root / "checkpoints" / BEST


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@pytest.mark.parametrize("kind", ["vaura", "dac", "avclip"])
def test_convert_checkpoints_matches_jax(reference_ckpt, tmp_path, kind):
    """The port's CLI writes a checkpoint of the port whose tensors are the
    JAX converter's through ``from_jax_params``, exactly."""
    from vaura_tpu.models import convert as J
    from vaura_tpu_torch.convert import from_jax_params
    from vaura_tpu_torch.scripts.convert_checkpoints import main
    from vaura_tpu_torch.train.checkpoint import load_state

    _, ckpt = reference_ckpt
    sd = torch.load(ckpt, weights_only=False)["state_dict"]
    if kind == "vaura":
        src = ckpt
        tree = J.convert_vaura_checkpoint(str(ckpt))
    elif kind == "dac":
        src = tmp_path / "weights.pth"
        dac_sd = _sub(sd, "audio_encoder.model.")
        torch.save({"state_dict": dac_sd}, src)
        tree = {"dac": J.convert_dac_state_dict(dac_sd)}
    else:  # the visual branch under Synchformer's prefix
        src = tmp_path / "avclip.pt"
        enc_sd = {f"module.v_encoder.{k}": v for k, v in
                  _sub(sd, "visual_feature_extractor.").items()}
        torch.save({"state_dict": enc_sd}, src)
        tree = {"encoder": J.convert_motionformer_state_dict(
            J.strip_avclip_prefix(enc_sd))}
    main([kind, str(src), str(tmp_path / "out"), "--device", "cpu"])
    got = load_state(tmp_path / "out")["params"]
    want = {f"{top}.{k}": v for top, part in from_jax_params(tree).items()
            for k, v in part.items()}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k


def test_converted_vaura_checkpoint_is_a_ckpt_path(reference_ckpt, tmp_path):
    """``ckpt_path=`` of the converted checkpoint restores the trainable
    weights of the experiment's model, as the reference checkpoint does."""
    from vaura_tpu_torch.models.factory import build_system
    from vaura_tpu_torch.scripts.convert_checkpoints import main
    from vaura_tpu_torch.train.checkpoint import load_trainable_
    from vaura_tpu_torch.utils import reference_ckpt as TR

    root, ckpt = reference_ckpt
    model_cfg, sds, _ = TR.load_reference_experiment(root)
    main(["vaura", str(ckpt), str(tmp_path / "out")])
    system = build_system(model_cfg, device="cpu")
    load_trainable_(system, tmp_path / "out", model_cfg)
    for name, t in system.sampler.state_dict().items():
        assert torch.equal(t, sds["sampler"][name]), name


def test_io_overlap_bench_prints_jax_keys(media, monkeypatch, capsys):
    """The tiny run on the CPU (its codec's input cut to 8 hops so that the
    float32 DAC encoder stays cheap here) prints one JSON line with every
    key of the JAX tool's line, and ``device``."""
    from vaura_tpu_torch.scripts import io_overlap_bench

    keys = ("synthetic_floor_ms_per_step", "real_loader_sync_ms_per_step",
            "real_loader_prefetch_ms_per_step", "overlap_gain_pct", "batch",
            "workers")
    jax_src = (REPO / "scripts" / "io_overlap_bench.py").read_text()
    assert all(f'"{k}"' in jax_src for k in keys)
    monkeypatch.setattr(io_overlap_bench, "AUDIO_SAMPLES", 8 * 512)
    out = io_overlap_bench.main(["--tiny", "--device", "cpu", "--steps", "1",
                                 "--batch", "2", "--clips", "2",
                                 "--workers", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out and set(line) == set(keys) | {"device"}
    assert line["device"] == "cpu" and line["batch"] == 2
    assert all(np.isfinite(line[k]) and line[k] > 0 for k in keys[:3])
