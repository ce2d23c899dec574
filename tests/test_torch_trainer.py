"""The port's Trainer (``vaura_tpu_torch/train/loop.py``) against the JAX
package's (``vaura_tpu/train/loop.py``) on the tiny float32 training
configuration of ``torch_port_util`` (every stochastic rate 0, a frozen
encoder), the weights carried across with ``convert.from_jax_params`` and
the same dummy batches (``DummyDataModule`` of each package under one
seed): ``fit`` over 2 epochs x 3 batches with a warm-up schedule, weight
decay and value clipping, then ``test``; a resumed ``fit`` of a third
epoch from each side's own ``last`` checkpoint; and the directory, early
stopping, emergency-resume and media paths of the port alone, as
``tests/test_trainer.py`` holds the JAX Trainer to them.

Both Trainers log to TensorBoard; every number is read back from the two
event files. Tolerance: 1e-5 absolute on every loss (step, epoch,
validation, per codebook, test), the tolerance of one step in
``tests/test_torch_train_step.py``, not widened: over the nine optimizer
steps the largest difference measured here was 4.8e-7 (float32 sums in
another order). The learning rate logged each step is the same function of
the step on both sides (relative 1e-6: float32 against float64 arithmetic)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import (
    EventAccumulator,
)
from torch_port_util import init_jax_train_system, port_train_system

from vaura_tpu.data.dummy import DummyDataModule as JDummy
from vaura_tpu.train.loop import Trainer as JTrainer
from vaura_tpu.utils.experiment import init_log_directory as j_init_dirs
from vaura_tpu_torch.data.dummy import DummyDataModule as TDummy
from vaura_tpu_torch.train.checkpoint import CheckpointManager
from vaura_tpu_torch.train.loop import EarlyStopping, Trainer
from vaura_tpu_torch.utils.experiment import init_log_directory

TOL = 1e-5
# 2 clips of 4 frames of 16 x 16; 80 samples = 10 codec frames at hop 8
DATA = dict(batch_size=2, frame_shape=(16, 16), video_length=0.64,
            sample_rate_audio=125, sample_rate_video=25.0,
            frames_per_clip=4, num_clips=2, seed=4)
TRAINER = {"max_epochs": 2, "limit_train_batches": 3, "limit_val_batches": 2,
           "limit_test_batches": 2, "early_stop_patience": 10,
           "gradient_clip_val": 1.0, "gradient_clip_algorithm": "value"}
MODEL = {"learning_rate": 1e-3, "weight_decay": 0.01,
         "lr_scheduler": {"target": "vaura_tpu.ops.schedules."
                                    "WarmUpToStaticLRScheduler",
                          "params": {"warmup_steps": 4}}}


def _dm(cls):
    dm = cls(**DATA)
    dm.setup()
    return dm


def _events(root):
    acc = EventAccumulator(str(root), size_guidance={"scalars": 0})
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both Trainers through fit (2 epochs), test, and a resumed fit of a
    third epoch from their own ``last``."""
    root = tmp_path_factory.mktemp("trainer")
    jsys, tree = init_jax_train_system(3, freeze_feature_extractor=True)
    out = {}

    # JAX
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    dirs = j_init_dirs(root / "jax", "parity", run_name="a")
    jt = JTrainer(jsys, dict(TRAINER), dict(MODEL), dirs)
    res = jt.fit(params, _dm(JDummy), jax.random.PRNGKey(0))
    test = jt.test(res["state"].params, res["frozen"], _dm(JDummy),
                   jax.random.PRNGKey(1))
    jt.tb.close()  # drains tensorboardX's queue (flush does not)
    dirs_b = j_init_dirs(root / "jax", "parity", run_name="b")
    jt_b = JTrainer(jsys, dict(TRAINER, max_epochs=3), dict(MODEL), dirs_b)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    res_b = jt_b.fit(params, _dm(JDummy), jax.random.PRNGKey(0),
                     resume_path=str(dirs["checkpoints"] / "last"))
    jt_b.tb.close()
    out["jax"] = dict(dirs=dirs, dirs_b=dirs_b, test=test, steps=int(
        res["state"].step), steps_b=int(res_b["state"].step),
        early=(jt.early_stop.best, jt.early_stop.count),
        early_b=(jt_b.early_stop.best, jt_b.early_stop.count))

    # the port
    tsys = port_train_system(tree, freeze_feature_extractor=True)
    dirs = init_log_directory(root / "port", "parity", run_name="a")
    tt = Trainer(tsys, dict(TRAINER), dict(MODEL), dirs)
    res = tt.fit(_dm(TDummy))
    test = tt.test(_dm(TDummy))
    tt.tb.close()
    dirs_b = init_log_directory(root / "port", "parity", run_name="b")
    tsys_b = port_train_system(tree, freeze_feature_extractor=True)
    tt_b = Trainer(tsys_b, dict(TRAINER, max_epochs=3), dict(MODEL), dirs_b)
    res_b = tt_b.fit(_dm(TDummy),
                     resume_path=str(dirs["checkpoints"] / "last"))
    tt_b.tb.close()
    out["port"] = dict(dirs=dirs, dirs_b=dirs_b, test=test,
                       steps=res["state"].step, steps_b=res_b["state"].step,
                       early=(tt.early_stop.best, tt.early_stop.count),
                       early_b=(tt_b.early_stop.best, tt_b.early_stop.count),
                       trainer=tt, system=tsys)
    return out


def _close(got, want, tag):
    assert [s for s, _ in got] == [s for s, _ in want], tag
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=0, atol=TOL, err_msg=tag)


@pytest.mark.parametrize("run", ["dirs", "dirs_b"], ids=["fit", "resumed"])
def test_logged_losses_match_jax(runs, run):
    """Every loss scalar of the fit (steps 1-6, epochs 0-1, test) and of
    the resumed fit (steps 7-9, epoch 2)."""
    want = _events(runs["jax"][run]["root"])
    got = _events(runs["port"][run]["root"])
    assert sorted(got) == sorted(want)
    first, n_steps = (1, 6) if run == "dirs" else (7, 3)
    assert [s for s, _ in got["train_loss_step"]] == list(
        range(first, first + n_steps))
    for tag in want:
        if tag == "lr":
            np.testing.assert_allclose([v for _, v in got[tag]],
                                       [v for _, v in want[tag]], rtol=1e-6)
            continue
        _close(got[tag], want[tag], tag)
    assert {f"val_loss_per_codebook_{i}" for i in range(3)} <= set(got)
    if run == "dirs":
        assert {"test_loss_epoch", "test_loss_per_codebook_0"} <= set(got)


def test_test_loss_steps_and_early_stop_state_match_jax(runs):
    j, t = runs["jax"], runs["port"]
    assert abs(t["test"]["test_loss"] - j["test"]["test_loss"]) <= TOL
    assert (t["steps"], t["steps_b"]) == (j["steps"], j["steps_b"]) == (6, 9)
    for key in ("early", "early_b"):
        assert t[key][1] == j[key][1], key
        assert abs(t[key][0] - j[key][0]) <= TOL, key
    # the loss fell, and the resumed run started from the restored state
    losses = [v for _, v in _events(t["dirs"]["root"])["train_loss_step"]]
    assert losses[-1] < losses[0]


def test_checkpoints_match_jax_layout(runs):
    """The same checkpoint directories (epoch and step in the name; val
    losses within the tolerance), ``last`` on the newest, the frozen
    subtrees stored once, and ``meta.json`` with the early-stop state."""
    for run in ("dirs", "dirs_b"):
        names = {}
        for side in ("jax", "port"):
            ck = runs[side][run]["checkpoints"]
            names[side] = sorted(p.name.rsplit("-val_loss=", 1)[0]
                                 for p in ck.iterdir())
            assert (ck / "frozen").is_dir() and (ck / "last").is_symlink()
        assert names["port"] == names["jax"], run
        for side in ("jax", "port"):
            meta = json.loads((runs[side][run]["checkpoints"] / "last"
                               / "meta.json").read_text())
            names[side] = meta
        j, t = names["jax"], names["port"]
        assert (t["epoch"], t["step"], t["early_stop_count"]) == (
            j["epoch"], j["step"], j["early_stop_count"])
        assert abs(t["early_stop_best"] - j["early_stop_best"]) <= TOL


def test_run_directory_and_stats(runs):
    t = runs["port"]
    dirs = t["dirs"]
    assert (dirs["root"] / "parity").is_dir()
    assert any(p.name.startswith("events.out.tfevents.")
               for p in dirs["root"].iterdir())
    stats = t["trainer"].stats
    assert len(stats["step_ms"]) == 6
    assert set(stats["step_ms"][0]) == {"forward", "backward", "optimizer"}
    assert len(stats["val_ms"]) == 3 and len(stats["save_s"]) == 2
    assert stats["media_s"] == [] and stats["restore_s"] == []
    # the frozen encoder recorded no graph
    assert not any(p.requires_grad for n, p in t["system"].named_parameters()
                   if n.startswith(("encoder.", "dac.")))


def test_emergency_resume_reruns_the_interrupted_epoch(tmp_path):
    """A crash checkpoint re-runs its epoch with the early-stop state it
    carries (``tests/test_trainer.py:133``); any exception in ``fit``
    writes one."""
    _, tree = init_jax_train_system(3, freeze_feature_extractor=True)
    cfg = dict(TRAINER, max_epochs=1, limit_train_batches=1,
               limit_val_batches=1)
    dirs = init_log_directory(tmp_path, "em", run_name="a")
    t1 = Trainer(port_train_system(tree, True), cfg, dict(MODEL), dirs)
    r1 = t1.fit(_dm(TDummy))
    assert r1["state"].step == 1
    em = t1.ckpt.save_emergency(
        r1["state"], epoch=1,
        metadata={"early_stop_best": t1.early_stop.best,
                  "early_stop_count": t1.early_stop.count})
    dirs2 = init_log_directory(tmp_path, "em", run_name="b")
    t2 = Trainer(port_train_system(tree, True), dict(cfg, max_epochs=2),
                 dict(MODEL), dirs2)
    r2 = t2.fit(_dm(TDummy), resume_path=str(em))
    assert r2["state"].step == 2  # epoch 1 ran again
    assert t2.early_stop.best <= t1.early_stop.best

    class BrokenLoader:
        def __len__(self):
            return 1

        def __iter__(self):
            raise RuntimeError("broken loader")

    class Broken(TDummy):
        def val_dataloader(self):
            return BrokenLoader()

    dirs3 = init_log_directory(tmp_path, "em", run_name="c")
    t3 = Trainer(port_train_system(tree, True), cfg, dict(MODEL), dirs3)
    dm = Broken(**DATA)
    dm.setup()
    with pytest.raises(RuntimeError, match="broken loader"):
        t3.fit(dm)
    (crash,) = [p for p in dirs3["checkpoints"].iterdir()
                if p.name.startswith("e0_last_at_")]
    meta = CheckpointManager.read_meta(crash)
    # the crash came in epoch 0's validation, after its one step
    assert meta["epoch_complete"] is False and meta["step"] == 1


def test_resume_with_budget_spent_restores_the_early_stop_state(runs,
                                                                tmp_path):
    """A resume whose epochs are already run trains nothing and keeps the
    early-stop state of the checkpoint (``tests/test_trainer.py:63``)."""
    _, tree = init_jax_train_system(3, freeze_feature_extractor=True)
    last = runs["port"]["dirs"]["checkpoints"] / "last"
    meta = CheckpointManager.read_meta(last)
    t = Trainer(port_train_system(tree, True), dict(TRAINER), dict(MODEL),
                init_log_directory(tmp_path, "spent", run_name="c"))
    res = t.fit(_dm(TDummy), resume_path=str(last))
    assert res["state"].step == 6 and meta["epoch"] == 1
    assert (t.early_stop.best, t.early_stop.count) == (
        meta["early_stop_best"], meta["early_stop_count"])


def test_early_stopping_logic():
    es = EarlyStopping(patience=2)
    assert not es.update(1.0)
    assert not es.update(0.9)
    assert not es.update(0.95)  # 1st bad epoch
    assert es.update(0.99)  # 2nd bad epoch -> stop


def test_early_stopping_ends_fit(tmp_path):
    """With patience 1 and a learning rate of 0 the val loss cannot fall:
    the second epoch stops the run, whatever ``max_epochs`` says."""
    _, tree = init_jax_train_system(3, freeze_feature_extractor=True)
    cfg = dict(TRAINER, max_epochs=5, limit_train_batches=1,
               limit_val_batches=1, early_stop_patience=1)
    t = Trainer(port_train_system(tree, True), cfg,
                dict(MODEL, learning_rate=0.0, lr_scheduler=None),
                init_log_directory(tmp_path, "es", run_name="a"))
    assert t.fit(_dm(TDummy))["state"].step == 2
    assert t.early_stop.count == 1


@pytest.mark.parametrize("cfg,n,want", [
    ({}, 10, 10),
    ({"limit_train_batches": 0.5}, 10, 5),
    ({"limit_train_batches": 1.0}, 10, 10),
    ({"limit_train_batches": 0.01}, 10, 1),
    ({"limit_train_batches": 3}, 10, 3),
    ({"limit_train_batches": 30}, 10, 10),
    ({"limit_train_batches": 2.0}, 10, 2),
    ({"limit_train_batches": 0.5, "fast_dev_run": 2}, 10, 2),
    ({"limit_train_batches": 8, "fast_dev_run": True}, 10, 1),
    ({"fast_dev_run": 4}, 3, 3),
])
def test_limit_matches_jax(tmp_path, cfg, n, want):
    """A float of at most 1.0 is a fraction, an int (or a larger float) a
    count; ``fast_dev_run`` caps both."""
    t = Trainer.__new__(Trainer)
    t.cfg = cfg
    fdr = cfg.get("fast_dev_run", False)
    t.fast_dev_run = int(fdr) if fdr else 0
    j = JTrainer.__new__(JTrainer)
    j.cfg, j.fast_dev_run = t.cfg, t.fast_dev_run
    assert t._limit("limit_train_batches", n) == want
    assert j._limit("limit_train_batches", n) == want


def test_tb_media_paths(tmp_path, monkeypatch):
    """The media hooks (tracked-file audio, the predict sample's audio,
    frames video, index histogram and attention video) only warn when
    they fail: drive them and fail on any warning, then read the records
    back (``tests/test_trainer.py:192``)."""
    import vaura_tpu_torch.train.loop as loop_mod

    _, tree = init_jax_train_system(3, freeze_feature_extractor=True)
    tsys = port_train_system(tree, True)
    dirs = init_log_directory(tmp_path, "media", run_name="run")
    trainer = Trainer(tsys, {"max_epochs": 1},
                      dict(MODEL, return_attention_weights=True,
                           plot_distr_of_pred_indices=True), dirs)
    warnings_seen = []
    monkeypatch.setattr(loop_mod.logger, "warning",
                        lambda *a, **k: warnings_seen.append(a))
    dm = _dm(TDummy)
    batch = trainer._put(next(iter(dm.train_dataloader())))
    stem = batch["meta"]["filepath"][0].rsplit("/", 1)[1].split(".")[0]
    trainer.model_cfg["files_to_track_during_training"] = [stem]
    trainer._log_tracked_files(batch, step=1)
    trainer._log_predict_media(dm, torch.Generator().manual_seed(0), step=1)
    trainer.tb.close()
    assert not warnings_seen, f"media logging fell back: {warnings_seen}"
    acc = EventAccumulator(str(dirs["root"]), size_guidance={
        "images": 0, "audio": 0, "histograms": 0})
    acc.Reload()
    tags = acc.Tags()
    assert set(tags["audio"]) == {
        f"generated_audio_of_training_data/{stem}", "generated_audio/0"}
    assert set(tags["images"]) == {"conditioned_frames/0",
                                   "s_attention_weights/0"}
    assert tags["histograms"] == ["sampled_indices/0"]
    # 48 tokens (no flatten_vis_feats): 48 frames of 10 codec frames each
    (audio,) = acc.Audio("generated_audio/0")
    assert audio.length_frames == 48 * 8
    (attn,) = acc.Images("s_attention_weights/0")
    hist = acc.Histograms("sampled_indices/0")[0].histogram_value
    assert hist.num == 3 * 48 and 0 <= hist.min and hist.max <= 16


def test_attention_probs_match_jax():
    """``Sampler.forward(return_attn_probs=True)``: each layer's softmax
    averaged over heads, against the JAX sampler's sown ``attn_probs``."""
    jsys, tree = init_jax_train_system(5)
    tsys = port_train_system(tree)
    rng = np.random.default_rng(0)
    seq = rng.integers(0, 16, (2, 3, 12)).astype(np.int32)
    feats = rng.standard_normal((2, 8, 24)).astype(np.float32)
    jlogits, inter = jsys.sampler.apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, tree["sampler"])},
        jnp.asarray(seq), jnp.asarray(feats), False,
        mutable=["intermediates"])
    want = np.asarray(jax.tree_util.tree_leaves(inter)[0])
    with torch.no_grad():
        logits, probs = tsys.sampler(torch.from_numpy(seq).long(),
                                     torch.from_numpy(feats), False,
                                     return_attn_probs=True)
        plain = tsys.sampler(torch.from_numpy(seq).long(),
                             torch.from_numpy(feats), False)
    assert probs.shape == want.shape == (2, 2, 12, 12)
    np.testing.assert_allclose(probs.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=1e-4)
    assert torch.equal(logits, plain)


def test_profiler_overfit_and_unbuffered_batches(tmp_path):
    """``profiler: jax`` writes a ``torch.profiler`` trace of steps 3-6 of
    epoch 0 into ``<root>/profile``; ``overfit_batches`` caps an epoch's
    steps, as the JAX loop reads it (it caches the batches of one epoch
    only); ``prefetch_batches=0`` copies each batch when it is taken."""
    _, tree = init_jax_train_system(3, freeze_feature_extractor=True)
    cfg = dict(TRAINER, max_epochs=1, limit_train_batches=8,
               limit_val_batches=1, overfit_batches=1, profiler="jax",
               prefetch_batches=0)
    dirs = init_log_directory(tmp_path, "prof", run_name="a")
    t = Trainer(port_train_system(tree, True), cfg,
                dict(MODEL, learning_rate=0.0, lr_scheduler=None), dirs)
    assert t.fit(_dm(TDummy))["state"].step == 1
    t.tb.close()
    cfg = dict(cfg, overfit_batches=0)
    t = Trainer(port_train_system(tree, True), cfg,
                dict(MODEL, learning_rate=0.0, lr_scheduler=None),
                init_log_directory(tmp_path, "prof", run_name="b"))
    assert t.fit(_dm(TDummy))["state"].step == 8
    t.tb.close()
    trace = t.dirs["root"] / "profile" / "trace.json"
    assert trace.exists() and json.loads(trace.read_text())["traceEvents"]
    assert [s for s, _ in _events(t.dirs["root"])["train_loss_step"]] == \
        list(range(1, 9))
    cfg = dict(cfg, overfit_batches=2, limit_train_batches=6,
               profiler=None, prefetch_batches=2)
    t = Trainer(port_train_system(tree, True), cfg,
                dict(MODEL, learning_rate=0.0, lr_scheduler=None),
                init_log_directory(tmp_path, "prof", run_name="c"))
    assert t.fit(_dm(TDummy))["state"].step == 2
