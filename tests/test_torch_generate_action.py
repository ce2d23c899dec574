"""The slice as a whole: the port's generate action against the JAX
package's ``scripts/generate.generate`` on one synthetic reference
experiment (``torch_reference_util``: the tiny ``dummy.yaml`` model under
the reference's own target names, a Lightning ``.ckpt`` beside a decoy).

* Both actions run end to end, as shipped (bf16 weights), and must write the
  same files: WAVs of the same names, sample rate and length, codes of the
  same shape.
* Below the action, the same pieces the action assembles, in float32 on both
  sides: the config, the converted weights, the datamodule's batch and the
  generation call with the action's arguments (one chunk with the bf16-width
  cache, ``quantize`` with the int8 cache, ``long_mode: stream_kv``). Greedy
  codes must be equal token for token, and the WAVs each package's
  ``save_results`` writes within 1e-3 relative RMS.

The JAX action costs about 40 s here (its op-by-op ``init_params``), so it
runs once, in a module fixture. With bf16 weights the two actions' codes
agree only where no rounding difference tips a greedy choice: JAX computes
inside ``jit`` on its bf16-cast parameters (the token embedding's weight
norm, for one) with roundings that op-by-op evaluation, its own included,
does not reproduce.
"""

import copy
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from torch_reference_util import write_reference_experiment

from vaura_tpu.ops.audio import read_wav

REPO = Path(__file__).resolve().parents[1]
COMMON = [
    "config=configs/experiments/dummy.yaml", "action=generate",
    "use_sampling=false", "return_sampled_indices=true", "max_batches=1",
    "dataloader.batch_size=1", "cfg_scale=3.0",
]
ONE_CHUNK = ["duration=0.15", "model_max_duration=0.64"]
MODES = {
    "one_chunk": ONE_CHUNK,
    "quantize": ONE_CHUNK + ["quantize=true"],
    "stream_kv": ["duration=1.28", "model_max_duration=0.64", "stride=0.64",
                  "long_mode=stream_kv"],
}


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    return write_reference_experiment(tmp_path_factory.mktemp("ref_exp"))


def _configs(argv):
    from vaura_tpu.config import assemble_config as j_assemble
    from vaura_tpu_torch.config import assemble_config as t_assemble

    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        return (j_assemble(argv, base_dir=REPO),
                t_assemble(argv + ["trainer.platform=cpu"], base_dir=REPO))
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def actions(experiment, tmp_path_factory):
    """Both actions, as shipped, one chunk: ``(jax dir, port dir, results)``."""
    from scripts.generate import generate as j_generate
    from vaura_tpu_torch.scripts.generate import generate as t_generate

    out = tmp_path_factory.mktemp("actions")
    argv = COMMON + ONE_CHUNK + [f"experiment_path={experiment}"]
    jc, _ = _configs(argv + [f"output_dir={out / 'jax'}"])
    _, tc = _configs(argv + [f"output_dir={out / 'port'}"])
    return out / "jax", out / "port", j_generate(jc), t_generate(tc)


def test_action_writes_the_files_of_the_jax_action(actions):
    jdir, tdir, jres, tres = actions
    assert jres["num_generated"] == tres["num_generated"] == 1
    names = sorted(p.name for p in jdir.iterdir())
    assert sorted(p.name for p in tdir.iterdir()) == names
    assert names == ["0.codes.npy", "0.wav", "config.yaml"]
    jw, jsr = read_wav(jdir / "0.wav")
    tw, tsr = read_wav(tdir / "0.wav")
    assert tsr == jsr == 44100 and tw.shape == jw.shape == (1, 12 * 8)
    assert np.isfinite(tw).all() and np.abs(tw).max() > 0
    jcodes, tcodes = np.load(jdir / "0.codes.npy"), np.load(tdir / "0.codes.npy")
    assert tcodes.shape == jcodes.shape == (3, 12)
    assert tcodes.min() >= 0 and tcodes.max() < 16
    # the port writes its config as JSON text, which YAML reads
    cfg = yaml.safe_load((tdir / "config.yaml").read_text())
    assert cfg["experiment_path"] == yaml.safe_load(
        (jdir / "config.yaml").read_text())["experiment_path"]
    assert set(tres["stage_ms"]) == {"encoder", "decode_loop", "dac"}


def _save(save_results, audio, out: Path):
    out.mkdir(parents=True, exist_ok=True)
    save_results(np.asarray(audio)[0], None, out, "0.mp4", a_fps=44100)
    return read_wav(out / "0.wav")[0]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_generation_below_the_action_matches_jax(experiment, mode, tmp_path):
    """float32 on both sides: what the action assembles, then its call."""
    from scripts.generate import save_results as j_save
    from vaura_tpu.data import get_datamodule_from_type as j_datamodule
    from vaura_tpu.models.factory import build_system as j_build
    from vaura_tpu.ops.quantization import quantize_sampler_params
    from vaura_tpu.utils.reference_ckpt import load_reference_experiment as j_load
    from vaura_tpu_torch.convert import from_jax_params
    from vaura_tpu_torch.data import get_datamodule_from_type as t_datamodule
    from vaura_tpu_torch.models.factory import build_system as t_build
    from vaura_tpu_torch.scripts.generate import _model_config, _replace_sampler
    from vaura_tpu_torch.scripts.generate import save_results as t_save

    jc, tc = _configs(COMMON + MODES[mode] + [f"experiment_path={experiment}"])
    assert {k: v for k, v in tc.items() if k != "trainer"} == {
        k: v for k, v in jc.items() if k != "trainer"}
    j_cfg, j_params, _ = j_load(experiment)
    t_cfg, t_sds, t_ckpt = _model_config(tc)
    assert t_ckpt is None  # the reference checkpoint came converted
    assert t_cfg == j_cfg
    want_sds = from_jax_params(j_params)
    for name, sd in t_sds.items():
        assert all(torch.equal(v, want_sds[name][k]) for k, v in sd.items())

    batches = []
    for make in (j_datamodule, t_datamodule):
        dl = dict(tc["dataloader"])
        dl.pop("dataset_to_use", None)
        dm = make(dl["dataset_type"], dl)
        dm.setup("test")
        batches.append(next(iter(dm.test_dataloader())))
    np.testing.assert_array_equal(batches[0]["frames"], batches[1]["frames"])
    frames = batches[0]["frames"]

    jsys = j_build(copy.deepcopy(j_cfg), precision="f32")
    tsys = t_build(copy.deepcopy(t_cfg), precision="f32", device="cpu")
    tsys.load_state_dicts(t_sds)
    tsys.requires_grad_(False)
    params = {k: jax.tree.map(jnp.asarray, v) for k, v in j_params.items()}
    sampling = dict(use_sampling=False, temp=1.0, top_k=256, top_p=0.0,
                    cfg_scale=3.0)
    if mode == "quantize":
        params["sampler"] = quantize_sampler_params(jax.device_get(params["sampler"]))
        jsys.sampler_config = dataclasses.replace(
            jsys.sampler_config, quantize_weights=True, quantize_cache=True)
        jsys.__post_init__()
        _replace_sampler(tsys, quantize_weights=True, quantize_cache=True)
    gen = torch.Generator().manual_seed(0)
    if mode == "stream_kv":
        total = int(1.28 * 86)
        jsys.sampler_config = dataclasses.replace(jsys.sampler_config,
                                                  block_size_audio=total + 64)
        jsys.__post_init__()
        _replace_sampler(tsys, block_size_audio=total + 64)
        kw = dict(total_tokens=total, vfps=25.0, window_chunks=4,
                  chunk_steps=56, sink_chunks=0, **sampling)
        jo = jsys.generate_long_kv(params, frames, jax.random.PRNGKey(0), **kw)
        to = tsys.generate_long_kv(torch.from_numpy(frames), generator=gen, **kw)
    else:
        kw = dict(max_new_tokens=int(0.15 * 86), tokens_per_frame=7,
                  remove_prompts=False, **sampling)
        jo = jax.jit(lambda p, f, r: jsys.generate(p, f, r, **kw))(
            params, frames, jax.random.PRNGKey(0))
        to = tsys.generate(torch.from_numpy(frames), generator=gen, **kw)
    np.testing.assert_array_equal(to["codes"].numpy(), np.asarray(jo["codes"]))
    jw = _save(j_save, jo["audio"], tmp_path / "jax")
    tw = _save(t_save, to["audio"].numpy(), tmp_path / "port")
    assert tw.shape == jw.shape
    rel = np.sqrt(((tw - jw) ** 2).mean() / max((jw ** 2).mean(), 1e-12))
    assert rel <= 1e-3, rel


def test_action_prompt_and_ground_truth(experiment, tmp_path):
    """``prompt_duration`` with ``remove_prompts`` and
    ``save_original_files`` (the DAC round trip) through the port's action."""
    from vaura_tpu_torch.scripts.generate import generate

    _, cfg = _configs(COMMON + ONE_CHUNK + [
        f"experiment_path={experiment}", f"output_dir={tmp_path}",
        "prompt_duration=0.05", "remove_prompts=true",
        "save_original_files=true", "dataloader.sample_rate_audio=44100"])
    assert generate(cfg)["num_generated"] == 1
    codes = np.load(tmp_path / "0.codes.npy")
    assert codes.shape == (3, 12 - int(0.05 * 86))
    assert read_wav(tmp_path / "0.wav")[0].shape[-1] == codes.shape[-1] * 8
    original, sr = read_wav(tmp_path / "0_original.wav")
    assert sr == 44100 and original.shape[-1] > 0


def test_jax_checkpoints_raise(tmp_path):
    """An experiment of the JAX package's own training (an orbax checkpoint,
    no ``state.pt``) raises ``ValueError``: only JAX reads it."""
    from vaura_tpu_torch.scripts.generate import generate

    (tmp_path / "checkpoints" / "epoch=0-step=1-val_loss=1.000").mkdir(
        parents=True)
    _, cfg = _configs(COMMON + ONE_CHUNK + [f"experiment_path={tmp_path}",
                                            f"output_dir={tmp_path / 'out'}"])
    with pytest.raises(ValueError, match="JAX package"):
        generate(cfg)


def test_action_loads_a_checkpoint_of_the_port(tmp_path):
    """An experiment of the port's own format (``CheckpointManager``, the
    ``hparams.yaml`` beside it): the action restores the best checkpoint's
    trainable weights and generates what the system with those weights
    generates."""
    from vaura_tpu_torch.models.factory import build_system
    from vaura_tpu_torch.scripts.generate import _model_config, generate
    from vaura_tpu_torch.train.checkpoint import CheckpointManager
    from vaura_tpu_torch.train.state import TrainState, make_optimizer
    from vaura_tpu_torch.train.steps import split_params
    from vaura_tpu_torch.utils import seeded_init_
    from vaura_tpu_torch.utils.experiment import save_hparams

    exp = tmp_path / "exp"
    (exp / "run").mkdir(parents=True)
    _, base = _configs(["config=configs/experiments/dummy.yaml"])
    save_hparams(exp / "run", {"model": base["model"]})
    system = build_system(copy.deepcopy(base["model"]), device="cpu")
    seeded_init_(system, torch.Generator().manual_seed(9))
    trainable, _ = split_params(system)
    mgr = CheckpointManager(exp / "checkpoints")
    for val in (2.0, 1.0, 3.0):  # the best is not the last
        mgr.save(TrainState.create(trainable, make_optimizer(1e-3)),
                 0, int(val), val)
        with torch.no_grad():
            trainable["sampler.lm_head.weight"].add_(1.0)
    argv = COMMON + ONE_CHUNK + [f"experiment_path={exp}",
                                 f"output_dir={tmp_path / 'out'}"]
    _, cfg = _configs(argv)
    model_cfg, ref_sds, ckpt = _model_config(cfg)
    assert ref_sds is None and ckpt.endswith("val_loss=1.000")
    assert model_cfg == base["model"]
    assert generate(cfg)["num_generated"] == 1
    _, cfg = _configs(argv + [f"output_dir={tmp_path / 'out2'}",
                              f"ckpt_path={exp / 'checkpoints' / 'last'}"])
    assert generate(cfg)["num_generated"] == 1
    # the two checkpoints differ in lm_head, so their greedy codes differ
    assert not np.array_equal(np.load(tmp_path / "out" / "0.codes.npy"),
                              np.load(tmp_path / "out2" / "0.codes.npy"))


def test_main_dispatch_and_device(monkeypatch):
    from vaura_tpu_torch.main import main
    from vaura_tpu_torch.scripts.generate import config_device

    monkeypatch.chdir(REPO)
    # every action of main.py is ported: on the card unless
    # trainer.platform says otherwise, so without CUDA they raise before
    # writing anything
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for action in ("train", "test", "finetune", "eval"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["config=configs/experiments/dummy.yaml", f"action={action}",
                  "trainer.log_dir=/nonexistent/logs"])
    monkeypatch.undo()
    monkeypatch.chdir(REPO)
    with pytest.raises(ValueError, match="Unknown action"):
        main(["config=configs/experiments/dummy.yaml", "action=nope"])
    assert config_device({"trainer": {"platform": "cpu"}}) == torch.device("cpu")
    with pytest.raises(ValueError):
        config_device({"trainer": {"platform": "tpu"}})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        config_device({})


CLI = [sys.executable, "-m", "vaura_tpu_torch",
       "config=configs/experiments/dummy.yaml", "action=generate",
       "duration=0.15", "model_max_duration=0.64", "dataloader.batch_size=1",
       "max_batches=1"]


def test_cli_writes_a_wav_on_the_cpu(tmp_path):
    r = subprocess.run(CLI + ["trainer.platform=cpu", f"output_dir={tmp_path}"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    wav, sr = read_wav(tmp_path / "0.wav")
    assert sr == 44100 and wav.shape == (1, 12 * 8)


@pytest.mark.skipif(torch.cuda.is_available(), reason="runs on the card there")
def test_cli_without_a_device_fails_without_cuda(tmp_path):
    r = subprocess.run(CLI + [f"output_dir={tmp_path}"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert not (tmp_path / "0.wav").exists()


def test_seed_everything_seeds_the_host_and_returns_a_generator():
    import random

    from vaura_tpu.utils.seeding import seed_everything as j_seed
    from vaura_tpu_torch.utils.seeding import seed_everything

    j_seed(5)
    want = (random.random(), np.random.rand())
    gen = seed_everything(5, "cpu")
    assert (random.random(), np.random.rand()) == want
    assert gen.device == torch.device("cpu") and gen.initial_seed() == 5
    assert torch.equal(torch.rand(3, generator=gen),
                       torch.rand(3, generator=torch.Generator().manual_seed(5)))
