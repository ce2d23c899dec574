"""The train and test actions of the port, as a user runs them:
``python -m vaura_tpu_torch config=configs/experiments/dummy.yaml
trainer.platform=cpu`` (the tiny model, the dummy datamodule) trains, writes
its run directory (``hparams.yaml``, checkpoints, the frozen subtrees, a
TensorBoard event file with every tag the Trainer logs) and a test loss;
``action=test`` with ``trainer.ckpt_path`` on the best checkpoint
reproduces that test loss (the same seeded initialisation of the frozen
codec and encoder, the same restored parameters: equal in float32)."""

import subprocess
import sys
from pathlib import Path

import pytest
from tensorboard.backend.event_processing.event_accumulator import (
    EventAccumulator,
)

from vaura_tpu_torch.main import main
from vaura_tpu_torch.utils.experiment import (
    load_hparams,
    resolve_best_checkpoint,
)

REPO = Path(__file__).resolve().parents[1]
# run A of chip_smoke.py's train_action phase, on the tiny model
RUN_A = ["trainer.fast_dev_run=false", "trainer.max_epochs=2",
         "trainer.limit_train_batches=3", "trainer.limit_val_batches=2",
         "trainer.limit_test_batches=2", "model.predict_at_val_start=true",
         "model.plot_distr_of_pred_indices=true",
         "model.return_attention_weights=true", "model.flatten_vis_feats=true"]


def _tags(root):
    acc = EventAccumulator(str(root), size_guidance={
        "scalars": 0, "images": 0, "audio": 0, "histograms": 0})
    acc.Reload()
    return acc


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    logs = tmp_path_factory.mktemp("logs")
    r = subprocess.run(
        [sys.executable, "-m", "vaura_tpu_torch",
         "config=configs/experiments/dummy.yaml", "trainer.platform=cpu",
         f"trainer.log_dir={logs}", *RUN_A],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    (root,) = logs.iterdir()
    return root, r.stderr


def test_train_action_writes_its_run_directory(trained):
    root, log = trained
    hp = load_hparams(root / "dummy-smoke" / "hparams.yaml")
    assert hp["action"] == "train" and hp["trainer"]["platform"] == "cpu"
    ck = root / "checkpoints"
    names = sorted(p.name.split("-val_loss=")[0] for p in ck.iterdir())
    assert names == ["epoch=0-step=3", "epoch=1-step=6", "frozen", "last"]
    assert (ck / "last").resolve().name.startswith("epoch=1-step=6")
    acc = _tags(root)
    tags = acc.Tags()
    scalars = set(tags["scalars"])
    assert {"train_loss_step", "lr", "train_loss_epoch", "val_loss_epoch",
            "test_loss_epoch"} <= scalars
    assert {f"val_loss_per_codebook_{i}" for i in range(3)} <= scalars
    assert [e.step for e in acc.Scalars("train_loss_step")] == list(range(1, 7))
    # the predict media of each epoch: 221 tokens capped at 64 - 16 = 48
    assert tags["audio"] == ["generated_audio/0"]
    assert sorted(tags["images"]) == ["conditioned_frames/0",
                                      "s_attention_weights/0"]
    assert tags["histograms"] == ["sampled_indices/0"]
    assert [e.step for e in acc.Audio("generated_audio/0")] == [3, 6]
    assert "test: {'test_loss'" in log and "failed" not in log


def test_test_action_reproduces_the_test_loss(trained, tmp_path):
    root, _ = trained
    want = _tags(root).Scalars("test_loss_epoch")[0].value
    best = resolve_best_checkpoint(root / "checkpoints")
    got = main(["config=configs/experiments/dummy.yaml", "action=test",
                "trainer.platform=cpu", f"trainer.log_dir={tmp_path}",
                "trainer.limit_test_batches=2", "trainer.fast_dev_run=false",
                f"trainer.ckpt_path={best}"])
    assert abs(got["test_loss"] - want) <= 1e-6
    (run,) = tmp_path.iterdir()
    assert (run / "dummy-smoke" / "hparams.yaml").exists()
    assert _tags(run).Scalars("test_loss_epoch")[0].value == pytest.approx(
        got["test_loss"], abs=1e-6)
