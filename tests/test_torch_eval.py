"""The port's eval stack (``vaura_tpu_torch/ops/fad.py``, ``ops/vggish.py``,
``ops/panns.py``, ``scripts/eval_metrics.py`` and ``action=eval``) against
the JAX package's (``vaura_tpu/ops/{fad,vggish,panns}.py``,
``scripts/eval_metrics.py``).

The metric math (numpy in both) agrees to 1e-10 relative. The embedding
networks run from one seeded torch state dict at their published widths:
through the JAX package's converter and its network, and through the
port's module, which loads the state dict as it is; the embeddings agree
within 1e-4 relative to their largest value (float32 convolutions summed in
other orders). The eval action runs on three pairs of 1 s WAVs with each
embedder, and its report equals ``evaluate_dirs`` of the JAX package within
1e-3 relative (FAD of 3 rows of 128 or 2048 dimensions: a covariance of rank
2, whose square roots amplify the embeddings' differences)."""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import vaura_tpu.ops.fad as jfad
import vaura_tpu_torch.ops.fad as tfad
from vaura_tpu.ops.panns import cnn14_forward, convert_cnn14_state_dict
from vaura_tpu.ops.vggish import convert_vggish_state_dict, vggish_embed
from vaura_tpu_torch.main import main as port_main
from vaura_tpu_torch.ops.audio import write_wav
from vaura_tpu_torch.ops.panns import Cnn14, log_mel_spectrogram
from vaura_tpu_torch.ops.vggish import VGGish, load_checkpoint, log_mel_patches
from vaura_tpu_torch.utils import seeded_init_

EMB_RTOL = 1e-4
REPORT_RTOL = 1e-3
SR = 16000


def test_fad_kld_and_melstats_match_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((40, 12))
    b = 0.8 * rng.standard_normal((30, 12)) + 0.3
    for got, want in (
        (tfad.frechet_audio_distance(a, b), jfad.frechet_audio_distance(a, b)),
        (tfad.paired_kl_divergence(a[:30], b), jfad.paired_kl_divergence(
            a[:30], b)),
        (tfad.paired_kl_divergence_from_probs(np.abs(a[:30]), np.abs(b)),
         jfad.paired_kl_divergence_from_probs(np.abs(a[:30]), np.abs(b))),
    ):
        assert got > 0
        np.testing.assert_allclose(got, want, rtol=1e-10)
    assert abs(tfad.frechet_audio_distance(a, a)) < 1e-9
    wav = (0.1 * rng.standard_normal(SR)).astype(np.float32)
    np.testing.assert_allclose(tfad.MelStatsEmbedder()(wav, SR),
                               jfad.MelStatsEmbedder()(wav, SR), rtol=1e-10)


def test_front_ends_match_jax():
    from vaura_tpu.ops.panns import log_mel_spectrogram as j_panns_mel
    from vaura_tpu.ops.vggish import log_mel_patches as j_patches

    rng = np.random.default_rng(1)
    for sr in (16000, 44100):
        wav = (0.1 * rng.standard_normal(int(2.0 * sr))).astype(np.float32)
        np.testing.assert_array_equal(log_mel_patches(wav, sr),
                                      j_patches(wav, sr))
        np.testing.assert_array_equal(log_mel_spectrogram(wav, sr),
                                      j_panns_mel(wav, sr))
    assert log_mel_patches(wav[:1000], sr).shape == (0, 96, 64)


def _seeded(cls, seed):
    torch.manual_seed(seed)
    net = cls("cpu").eval()
    # non-trivial BatchNorm statistics (a fresh one has mean 0, var 1)
    for m in net.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.5)
            m.running_var.uniform_(0.5, 2.0)
    return net


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def test_vggish_embeddings_match_jax():
    net = _seeded(VGGish, 0)
    assert [k for k in net.state_dict() if k.endswith("weight")] == [
        f"features.{i}.weight" for i in (0, 3, 6, 8, 11, 13)] + [
        f"embeddings.{i}.weight" for i in (0, 2, 4)]
    patches = np.random.default_rng(2).standard_normal(
        (3, 96, 64)).astype(np.float32)
    want = vggish_embed(convert_vggish_state_dict(net.state_dict()), patches)
    with torch.no_grad():
        got = net(torch.from_numpy(patches)).numpy()
    assert got.shape == (3, 128) and np.abs(got).max() > 0
    _close(got, want, EMB_RTOL)


def test_cnn14_embeddings_and_posteriors_match_jax():
    net = _seeded(Cnn14, 1)
    logmel = (np.random.default_rng(3).standard_normal((2, 96, 64)) * 10
              - 20).astype(np.float32)
    want_emb, want_probs = cnn14_forward(
        convert_cnn14_state_dict(net.state_dict()), jnp.asarray(logmel))
    with torch.no_grad():
        emb, probs = net(torch.from_numpy(logmel))
    assert emb.shape == (2, 2048) and probs.shape == (2, 527)
    _close(emb.numpy(), want_emb, EMB_RTOL)
    _close(probs.numpy(), want_probs, EMB_RTOL)


@pytest.mark.parametrize("cls,frames", [(VGGish, 96), (Cnn14, 64)])
def test_networks_run_in_full_float32(cls, frames, monkeypatch):
    """Each network turns TF32 off for its own forward (cuDNN allows it for
    float32 convolutions by default) and restores the flags after."""
    backends = torch.backends
    monkeypatch.setattr(backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(backends.cuda.matmul, "allow_tf32", True)
    net = _seeded(cls, 0)
    seen = []
    conv = next(m for m in net.modules() if isinstance(m, nn.Conv2d))
    conv.register_forward_pre_hook(lambda m, a: seen.append(
        (backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32)))
    with torch.no_grad():
        net(torch.zeros(1, frames, 64))
    assert seen == [(False, False)]
    assert backends.cudnn.allow_tf32 and backends.cuda.matmul.allow_tf32


def test_checkpoint_loader_refuses_pickled_objects(tmp_path):
    """``load_checkpoint`` reads tensors, containers and numbers only."""
    net = _seeded(VGGish, 0)
    torch.save({"state_dict": net.state_dict(), "step": 3},
               tmp_path / "ok.pth")
    load_checkpoint(tmp_path / "ok.pth", VGGish("cpu"))
    torch.save({"state_dict": net.state_dict(), "path": tmp_path},
               tmp_path / "object.pth")
    with pytest.raises(pickle.UnpicklingError, match="[Ww]eights only"):
        load_checkpoint(tmp_path / "object.pth", VGGish("cpu"))


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    """Three pairs of 1 s WAVs at 16 kHz and a seeded checkpoint of each
    network (the published files' layouts: a bare state dict for VGGish,
    ``{"model": ...}`` with the front end's tensors for Cnn14)."""
    root = tmp_path_factory.mktemp("eval")
    gen, ref = root / "gen", root / "ref"
    gen.mkdir(), ref.mkdir()
    rng = np.random.default_rng(4)
    t = np.arange(SR) / SR
    for i in range(3):
        # generated: noise at three levels; reference: tones over noise
        noise = rng.standard_normal(SR)
        write_wav(gen / f"c{i}.wav",
                  (0.05 * (i + 1) * noise)[None].astype(np.float32), SR)
        tone = 0.5 * np.sin(2 * np.pi * 440.0 * (i + 1) * t)
        write_wav(ref / f"c{i}.wav",
                  (tone + 0.02 * noise)[None].astype(np.float32), SR)
    # seeded_init_'s N(0, 1/fan_in) weights and zero biases keep the
    # embeddings apart (torch's default init and random BatchNorm
    # statistics make them all but equal: FAD ~ 1e-10, rounding noise)
    torch.save(seeded_init_(VGGish("cpu"), torch.Generator().manual_seed(5)
                            ).state_dict(), root / "vggish.pth")
    sd = seeded_init_(Cnn14("cpu"), torch.Generator().manual_seed(6)
                      ).state_dict()
    sd["spectrogram_extractor.stft.conv_real.weight"] = torch.zeros(513, 1,
                                                                    1024)
    sd["logmel_extractor.melW"] = torch.zeros(513, 64)
    torch.save({"model": sd, "iteration": 0}, root / "cnn14.pth")
    return root


@pytest.mark.parametrize("embedder", ["melstats", "vggish", "panns"])
def test_eval_action_matches_jax(eval_dirs, embedder, capsys):
    from scripts.eval_metrics import evaluate_dirs as j_evaluate_dirs

    ckpt = {"vggish": eval_dirs / "vggish.pth",
            "panns": eval_dirs / "cnn14.pth"}.get(embedder)
    argv = ["config=configs/experiments/dummy.yaml", "action=eval",
            "trainer.platform=cpu", f"generated_dir={eval_dirs / 'gen'}",
            f"reference_dir={eval_dirs / 'ref'}", "fad=true",
            f"embedder={embedder}"] + ([f"embedder_ckpt={ckpt}"] if ckpt
                                       else [])
    got = port_main(argv)
    assert '"melspec_l1"' in capsys.readouterr().out
    want = j_evaluate_dirs(eval_dirs / "gen", eval_dirs / "ref", fad=True,
                           embedder=embedder,
                           embedder_ckpt=str(ckpt) if ckpt else None)
    assert got["n"] == want["n"] == 3
    assert got["mean"][f"fad_{embedder}"] > 1e-3
    keys = {"melspec_l1", "si_snr_db", "loudness_delta_lufs",
            f"fad_{embedder}"} | ({"kld_panns"} if embedder == "panns"
                                  else set())
    assert set(got["mean"]) == set(want["mean"]) == keys
    for k in keys:
        assert np.isfinite(got["mean"][k]), k
        np.testing.assert_allclose(got["mean"][k], want["mean"][k],
                                   rtol=REPORT_RTOL, err_msg=k)


def test_eval_action_without_directories_points_the_way(capsys):
    assert port_main(["config=configs/experiments/dummy.yaml", "action=eval",
                      "trainer.platform=cpu"]) is None
    assert "generated_dir=... reference_dir=..." in capsys.readouterr().out
