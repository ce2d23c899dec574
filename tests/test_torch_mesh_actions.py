"""The actions as a user starts them on several
processes (``python -m torch.distributed.run --nproc_per_node=2 -m
vaura_tpu_torch ...``), on the CPU with gloo and the tiny model of
``configs/experiments/dummy.yaml``:

  * the train action on a mesh of fsdp 2 writes one run directory, one
    TensorBoard file and its checkpoints from rank 0 only; its checkpoint
    equals the one-process run's within 1e-6 (the same seeds and batches)
    and loads into a one-process ``TrainState``; a mesh run resumes the
    one-process run's checkpoint;
  * JAX's fallback: a batch not divisible by ``data * fsdp`` runs
    unsharded with JAX's warning;
  * the generate action shards its batch over a data mesh and writes each
    WAV once, byte for byte the one-process run's (greedy decoding), also
    from a LoRA experiment (its adapters whole on every rank, merged into
    the weights at each call);
  * the train action on a mesh logs the tracked training files' greedy
    audio (every rank runs their forward, rank 0 writes): the same audio
    records, tags and steps as the one-process run's, also of a file whose
    row lies on rank 1;
  * the train action with LoRA adapters (``model.lora_rank``) on a mesh
    of fsdp 2: a checkpoint of the adapters alone, within 1e-6 of the
    one-process run's, and the generate action from its experiment on a
    mesh;
  * the finetune, test and eval actions on 2 ranks, with no mesh (every
    rank the whole action, as JAX runs them): one run directory written by
    rank 0, the one-process run's checkpoints, test loss and report.

Each launch has 180 s.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 180
TRAIN = ["config=configs/experiments/dummy.yaml", "trainer.platform=cpu"]
GENERATE = ["config=configs/experiments/dummy.yaml", "action=generate",
            "trainer.platform=cpu", "duration=0.15", "model_max_duration=0.64",
            "dataloader.batch_size=4", "max_batches=2", "use_sampling=false",
            "cfg_scale=3.0"]


FINETUNE = TRAIN + ["action=finetune", "finetune.lora_rank=4",
                    "finetune.lora_alpha=8.0"]
LORA = ["model.lora_rank=4", "model.lora_alpha=8.0"]


def _run(args, nproc=None):
    launch = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={nproc}", "-m", "vaura_tpu_torch"]
              if nproc else [sys.executable, "-m", "vaura_tpu_torch"])
    r = subprocess.run(launch + args, cwd=REPO, capture_output=True,
                       text=True, timeout=TIMEOUT_S,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    return r.stdout + r.stderr


def _audio_events(run: Path) -> dict:
    """``{(tag, step): encoded audio}`` of a run's TensorBoard file."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(str(run), size_guidance={"audio": 0})
    acc.Reload()
    return {(tag, e.step): e.encoded_audio_string
            for tag in acc.Tags()["audio"] for e in acc.Audio(tag)}


def _run_dir(log_dir: Path) -> Path:
    (run,) = [p for p in log_dir.iterdir() if p.is_dir()]
    return run


def _state(run: Path) -> dict:
    return torch.load(run / "checkpoints" / "last" / "state.pt",
                      weights_only=True)


def _test_loss(text: str) -> float:
    line = [x for x in text.splitlines() if "test: {'test_loss'" in x][-1]
    return float(line.rsplit(":", 1)[1].strip(" }"))


def test_train_action_on_a_mesh(tmp_path):
    mesh_logs, one_logs = tmp_path / "mesh", tmp_path / "one"
    text = _run(TRAIN + [f"trainer.log_dir={mesh_logs}", "trainer.mesh.data=1",
                         "trainer.mesh.fsdp=2"], nproc=2)
    assert "Mesh: {'data': 1, 'fsdp': 2, 'model': 1}" in text
    one_text = _run(TRAIN + [f"trainer.log_dir={one_logs}"])
    run, one = _run_dir(mesh_logs), _run_dir(one_logs)
    assert len(list(run.glob("events.out.tfevents.*"))) == 1
    entries = lambda d: sorted(p.name for p in d.iterdir()
                               if not p.name.startswith("events."))
    assert entries(run) == entries(one)
    assert entries(run / "checkpoints") == entries(one / "checkpoints")
    got, want = _state(run), _state(one)
    assert got["step"] == want["step"] == 2
    assert set(got["params"]) == set(want["params"])
    for k, v in want["params"].items():
        torch.testing.assert_close(got["params"][k], v, rtol=0, atol=1e-6)
    assert abs(_test_loss(text) - _test_loss(one_text)) < 1e-6
    # the mesh's checkpoint tested in one process
    tested = _run(TRAIN + ["action=test", f"trainer.log_dir={tmp_path / 't'}",
                           f"trainer.ckpt_path={run / 'checkpoints' / 'last'}"])
    assert abs(_test_loss(tested) - _test_loss(text)) < 1e-6
    # the one-process checkpoint resumed on the mesh for a second epoch
    resumed = _run(TRAIN + [
        f"trainer.log_dir={tmp_path / 'r'}", "trainer.mesh.data=1",
        "trainer.mesh.fsdp=2", "trainer.fast_dev_run=false",
        "trainer.max_epochs=2", "trainer.limit_train_batches=2",
        "trainer.limit_val_batches=1", "trainer.limit_test_batches=1",
        f"trainer.ckpt_path={one / 'checkpoints' / 'last'}"], nproc=2)
    assert "Resumed from" in resumed and "(epoch 1)" in resumed
    assert _state(_run_dir(tmp_path / "r"))["step"] == 4


def test_indivisible_batch_runs_unsharded(tmp_path):
    text = _run(TRAIN + [f"trainer.log_dir={tmp_path}",
                         "dataloader.batch_size=3"], nproc=2)
    assert "batch_size 3 not divisible by data*fsdp=2; running unsharded" in text
    run = _run_dir(tmp_path)
    assert len(list(run.glob("events.out.tfevents.*"))) == 1
    assert _state(run)["step"] == 2


def test_generate_action_shards_its_batch(tmp_path):
    one, mesh = tmp_path / "one", tmp_path / "mesh"
    _run(GENERATE + [f"output_dir={one}"])
    text = _run(GENERATE + [f"output_dir={mesh}"], nproc=2)
    assert "sharding generation batch 4 over 2 processes" in text
    names = sorted(p.name for p in one.iterdir())
    assert names == sorted(p.name for p in mesh.iterdir())
    assert len([n for n in names if n.endswith(".wav")]) == 8
    for n in names:
        if n.endswith(".wav"):
            assert (one / n).read_bytes() == (mesh / n).read_bytes(), n


@pytest.fixture(scope="module")
def lora_finetune(tmp_path_factory):
    """A LoRA run of the finetune action in one process (rank 4, from the
    seeded base its ``frozen/`` save holds): its run directory and
    output."""
    logs = tmp_path_factory.mktemp("ft")
    text = _run(FINETUNE + [f"trainer.log_dir={logs}"])
    return _run_dir(logs), text


def test_generate_action_from_a_lora_experiment_on_a_mesh(tmp_path,
                                                          lora_finetune):
    """A LoRA run of the finetune action (rank 4, from the seeded base its
    ``frozen/`` save holds); the generate action from its experiment on 2
    processes writes the files of the one-process action, WAVs and codes
    byte for byte."""
    exp, _ = lora_finetune
    argv = GENERATE + [f"experiment_path={exp}", "return_sampled_indices=true"]
    one, mesh = tmp_path / "one", tmp_path / "mesh"
    _run(argv + [f"output_dir={one}"])
    text = _run(argv + [f"output_dir={mesh}"], nproc=2)
    assert "sharding generation batch 4 over 2 processes" in text
    assert "Loaded the LoRA base weights from" in text
    names = sorted(p.name for p in one.iterdir())
    assert names == sorted(p.name for p in mesh.iterdir())
    assert len([n for n in names if n.endswith(".codes.npy")]) == 8
    for n in names:
        if n.endswith((".wav", ".npy")):
            assert (one / n).read_bytes() == (mesh / n).read_bytes(), n


def _first_train_files(n_batches: int = 2) -> list:
    """The file stems of the train action's first batches of
    ``dummy.yaml`` (its loader shuffles from the config's seed)."""
    from vaura_tpu_torch.config import assemble_config
    from vaura_tpu_torch.data import get_datamodule_from_type

    cfg = assemble_config(
        [f"config={REPO / 'configs/experiments/dummy.yaml'}"],
        defaults_path=REPO / "configs" / "vaura_defaults.yaml",
        base_dir=REPO)
    dm = get_datamodule_from_type(cfg["dataloader"]["dataset_type"],
                                  dict(cfg["dataloader"]))
    dm.setup()
    loader = dm.train_dataloader()
    loader.set_epoch(0)
    it = iter(loader)
    return [[Path(f).stem for f in next(it)["meta"]["filepath"]]
            for _ in range(n_batches)]


def test_train_action_on_a_mesh_logs_tracked_files(tmp_path):
    """Two files tracked, the first batch's second row (on rank 1 of fsdp
    2) and the second batch's first: the mesh run's event file holds the
    audio records of the one-process run, the same tags, steps and
    bytes."""
    first, second = _first_train_files()
    files = [first[1], second[0]]
    track = ['model.files_to_track_during_training=[%s]'
             % ",".join(f'"{f}"' for f in files)]
    _run(TRAIN + track + [f"trainer.log_dir={tmp_path / 'mesh'}",
                          "trainer.mesh.data=1", "trainer.mesh.fsdp=2"],
         nproc=2)
    _run(TRAIN + track + [f"trainer.log_dir={tmp_path / 'one'}"])
    got = _audio_events(_run_dir(tmp_path / "mesh"))
    want = _audio_events(_run_dir(tmp_path / "one"))
    tracked = {k for k in want if k[0].startswith(
        "generated_audio_of_training_data/")}
    assert tracked == {(f"generated_audio_of_training_data/{files[0]}", 1),
                       (f"generated_audio_of_training_data/{files[1]}", 2)}
    assert set(got) == set(want)
    for k in tracked:
        assert got[k] == want[k], k


def _params(run: Path, ckpt: str) -> dict:
    """The parameters of a run's checkpoint ``ckpt`` (``last`` or the
    bare mapping of ``frozen``)."""
    sd = torch.load(run / "checkpoints" / ckpt / "state.pt", weights_only=True)
    return sd.get("params", sd)


def _entries(run: Path) -> list:
    """A run directory's entries below the top, but the event file."""
    return sorted(str(p.relative_to(run)) for p in run.rglob("*")
                  if not p.name.startswith("events."))


def test_lora_train_action_on_a_mesh(tmp_path):
    """``action=train model.lora_rank=4`` under ``torchrun`` at fsdp 2, as
    JAX's train action takes the same keys: the adapters train on the mesh
    (the base sampler FSDP2-sharded and frozen). Its checkpoint holds the
    adapters alone (``dummy.yaml`` has no bridge and a frozen encoder),
    within 1e-6 of the one-process run's, its ``frozen/`` save the whole
    base, equal to the one-process run's, its test loss the one-process
    run's; the generate action from its experiment runs on a mesh of 2
    processes (the base from ``frozen/``) and writes every clip."""
    mesh_logs, one_logs = tmp_path / "mesh", tmp_path / "one"
    text = _run(TRAIN + LORA + [f"trainer.log_dir={mesh_logs}",
                                "trainer.mesh.data=1", "trainer.mesh.fsdp=2"],
                nproc=2)
    assert "Mesh: {'data': 1, 'fsdp': 2, 'model': 1}" in text
    one_text = _run(TRAIN + LORA + [f"trainer.log_dir={one_logs}"])
    run, one = _run_dir(mesh_logs), _run_dir(one_logs)
    assert _entries(run) == _entries(one)
    got, want = _state(run), _state(one)
    assert got["step"] == want["step"] == 2
    assert set(got["params"]) == set(want["params"])
    assert all(k.startswith("lora_sampler.") for k in got["params"])
    for k, v in want["params"].items():
        torch.testing.assert_close(got["params"][k], v, rtol=0, atol=1e-6)
    base = [_params(r, "frozen") for r in (run, one)]
    assert any(k.startswith("sampler.") for k in base[1])
    assert set(base[0]) == set(base[1])
    for k, v in base[1].items():
        assert torch.equal(base[0][k], v), k
    assert abs(_test_loss(text) - _test_loss(one_text)) < 1e-6
    gen = tmp_path / "gen"
    text = _run(GENERATE + [f"experiment_path={run}", f"output_dir={gen}"],
                nproc=2)
    assert "sharding generation batch 4 over 2 processes" in text
    assert "Loaded the LoRA base weights from" in text
    assert len(list(gen.glob("*.wav"))) == 8


def test_finetune_test_and_eval_actions_on_two_ranks(tmp_path,
                                                     lora_finetune):
    """The finetune, test and eval actions under ``torchrun`` on 2 ranks,
    as JAX runs them: no mesh, every rank the whole action on its own
    device; rank 0 alone writes. The finetune (LoRA) run writes one run
    directory with the one-process run's entries and one event file; its
    checkpoints and test loss equal the one-process run's. The test action
    of its ``last`` on 2 ranks writes one run directory and reports that
    test loss. The eval action on 2 ranks prints the one-process report
    once."""
    from vaura_tpu_torch.main import main
    from vaura_tpu_torch.ops.audio import write_wav

    one, one_text = lora_finetune
    text = _run(FINETUNE + [f"trainer.log_dir={tmp_path / 'ft'}"], nproc=2)
    run = _run_dir(tmp_path / "ft")
    assert _entries(run) == _entries(one)
    assert len(list(run.glob("events.out.tfevents.*"))) == 1
    for ck in ("last", "frozen"):
        got, want = (_params(r, ck) for r in (run, one))
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), (ck, k)
    loss = _test_loss(one_text)
    assert _test_loss(text) == loss
    text = _run(TRAIN + LORA + [
        "action=test", f"trainer.log_dir={tmp_path / 'test'}",
        f"trainer.ckpt_path={run / 'checkpoints' / 'last'}"], nproc=2)
    tested = _run_dir(tmp_path / "test")
    assert len(list(tested.rglob("hparams.yaml"))) == 1
    assert abs(_test_loss(text) - loss) < 1e-6
    rng = np.random.default_rng(0)
    dirs = {k: tmp_path / k for k in ("gen", "ref")}
    for d in dirs.values():
        d.mkdir()
        for i in range(3):
            write_wav(d / f"{i}.wav", 0.1 * rng.standard_normal(
                (1, 22050)).astype(np.float32), 44100)
    argv = ["config=configs/experiments/dummy.yaml", "action=eval",
            "trainer.platform=cpu", "fad=true", f"generated_dir={dirs['gen']}",
            f"reference_dir={dirs['ref']}"]
    report = main(argv)
    assert report["n"] == 3
    text = _run(argv, nproc=2)
    (start,) = [i for i in range(len(text)) if text.startswith("{\n", i)]
    printed = json.loads(text[start:text.index("\n}", start) + 2])
    assert printed.keys() == report["mean"].keys()
    for k, v in report["mean"].items():  # this process runs more threads
        assert abs(printed[k] - v) <= 1e-6 * abs(v), k
