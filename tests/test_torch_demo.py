"""The port's demo (``vaura_tpu_torch/demo.py``,
``vaura_tpu_torch/utils/demo_utils.py``) against the JAX package's.

  * ``run_demo`` with greedy decoding on the tiny float32 system, loaded
    with the JAX system's converted weights: codes token for token equal to
    JAX's ``VauraSystem.generate`` on the same frames, audio within 1e-4
    (the DAC test's tolerance);
  * ``load_demo_model``: a tree on disk loads (the best checkpoint of a
    synthetic reference experiment), an absent one raises naming both
    URLs, which are JAX's;
  * ``--frames``: raw ``[N, H, W, 3]`` uint8 frames and ``[S, 3, T, 224,
    224]`` segments, through the command line on the CPU with the tiny
    model of ``configs/experiments/dummy.yaml``, to a WAV of the expected
    length.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (
    CPU,
    init_jax_system,
    port_dac_config,
    port_encoder_config,
    port_sampler_config,
)

from vaura_tpu.utils import demo_utils as j_demo_utils
from vaura_tpu_torch import demo
from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.models.vaura import VauraSystem as TSystem
from vaura_tpu_torch.ops.audio import read_wav
from vaura_tpu_torch.utils import demo_utils

REPO = Path(__file__).resolve().parents[1]


def test_greedy_demo_matches_jax_generate(tmp_path):
    jsys, tree = init_jax_system(seed=0)
    tsys = TSystem(port_sampler_config(), port_dac_config(),
                   port_encoder_config(), device=CPU)
    tsys.load_state_dicts(from_jax_params(tree))
    frames = np.random.default_rng(1).standard_normal(
        (1, 2, 3, 4, 16, 16)).astype(np.float32)
    got = demo.run_demo(tsys, frames, tmp_path, duration=0.3, greedy=True,
                        cfg_scale=6.0)
    tokens = int(0.3 * 86)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    want = jsys.generate(jp, jnp.asarray(frames[:, :1]), jax.random.PRNGKey(0),
                         max_new_tokens=tokens, tokens_per_frame=7,
                         use_sampling=False, cfg_scale=6.0)
    assert got["codes"].shape == (1, 3, tokens)
    np.testing.assert_array_equal(got["codes"].numpy(),
                                  np.asarray(want["codes"]))
    want_audio = np.clip(np.asarray(want["audio"], np.float32), -1, 1)
    np.testing.assert_allclose(got["audio"], want_audio, rtol=0, atol=1e-4)
    wav, sr = read_wav(tmp_path / "generated.wav")
    assert sr == 44100 and wav.shape == (1, tokens * port_dac_config().hop_length)


def test_load_demo_model_reads_a_tree_on_disk_or_names_the_urls(tmp_path):
    assert demo_utils.VAURA_CKPT_URL == j_demo_utils.VAURA_CKPT_URL
    assert demo_utils.AVCLIP_CKPT_URL == j_demo_utils.AVCLIP_CKPT_URL
    with pytest.raises(FileNotFoundError) as e:
        demo_utils.load_demo_model(tmp_path / "empty")
    assert demo_utils.VAURA_CKPT_URL in str(e.value)
    assert demo_utils.AVCLIP_CKPT_URL in str(e.value)
    from torch_reference_util import BEST, write_reference_experiment

    write_reference_experiment(tmp_path / demo_utils.EXTRACTED)
    model_cfg, sds, path = demo_utils.load_demo_model(tmp_path)
    assert path.name == BEST
    assert {"sampler", "dac", "encoder"} <= set(sds)
    assert "sampler_config" in model_cfg


def test_frames_files_in_both_layouts():
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, (40, 240, 250, 3)).astype(np.uint8)
    seg = demo.segments_from_rgb(raw, 16)
    assert seg.shape == (1, 2, 3, 16, 224, 224) and seg.dtype == np.float32
    # the centre crop, scaled to [-1, 1]: frame 17's pixel (8, 13) is
    # segment 1, time 1, at crop offsets (8, 13)
    assert seg[0, 1, :, 1, 0, 0].tolist() == pytest.approx(
        ((raw[17, 8, 13] / 255.0 - 0.5) / 0.5).tolist())
    with pytest.raises(ValueError, match="fewer than one segment"):
        demo.segments_from_rgb(raw[:10], 16)


@pytest.mark.parametrize("layout", ["raw", "segments"])
def test_demo_cli_from_a_frames_file(tmp_path, layout):
    rng = np.random.default_rng(2)
    if layout == "raw":
        frames = rng.integers(0, 256, (20, 230, 240, 3)).astype(np.uint8)
    else:
        frames = rng.standard_normal((1, 3, 16, 224, 224)).astype(np.float32)
    path = tmp_path / "frames.npy"
    np.save(path, frames)
    out = tmp_path / "out"
    r = demo.main(["--frames", str(path), "--config",
                   str(REPO / "configs/experiments/dummy.yaml"), "--platform",
                   "cpu", "--greedy", "--duration", "0.3", "--out", str(out)])
    tokens = int(0.3 * 86)
    wav, sr = read_wav(out / "generated.wav")
    assert sr == 44100 and wav.shape == (1, tokens * 8)  # the tiny hop: 8
    assert np.isfinite(wav).all()
    assert r["codes"].shape == (1, 3, tokens)
    assert sorted(p.name for p in out.iterdir()) == ["generated.wav"]
    # the same frames, the same weights: the same greedy codes
    again = demo.main(["--frames", str(path), "--config",
                       str(REPO / "configs/experiments/dummy.yaml"),
                       "--platform", "cpu", "--greedy", "--duration", "0.3",
                       "--out", str(tmp_path / "again")])
    assert torch.equal(again["codes"], r["codes"])


def test_demo_needs_a_device_unless_the_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo.main(["--frames", str(tmp_path / "none.npy"), "--config",
                   str(REPO / "configs/experiments/dummy.yaml"),
                   "--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
