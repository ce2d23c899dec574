"""The port's checkpoints (``vaura_tpu_torch/train/checkpoint.py``) against
``vaura_tpu/train/checkpoint.py``.

* Every case of ``tests/test_checkpoint.py`` on the port's manager: round
  trip, top-k and best, frozen, emergency, ``restore_best``, async
  semantics, the ledger rebuilt across instances, a resumed worse save
  keeping ``last``, the same-name overwrite, ``read_meta`` and
  ``restore_trainable_params`` from a training checkpoint.
* The same sequence of saves through both managers leaves the same
  directory names, the same ``last`` target and equal metadata.
* A ``TrainState`` restored from a checkpoint takes one train step to
  exactly the loss and parameters of the state that never left memory.
* Weights of the JAX package, converted (``from_jax_params``), saved and
  restored by the port, give the JAX package's logits.
* An orbax directory raises ``ValueError``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (
    J_ENC_TRAIN,
    J_SAMPLER_TRAIN,
    port_dac_config,
    port_encoder_config,
    port_sampler_config,
    randomize_sampler_heads,
)

from vaura_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_trainable_,
    restore_trainable_params,
)
from vaura_tpu_torch.train.state import TrainState, make_optimizer
from vaura_tpu_torch.utils.experiment import checkpoint_name, resolve_best_checkpoint


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"sampler.w": torch.randn(4, 4, generator=g),
              "sampler.uncond_embedding": torch.ones(2, 3)}
    return TrainState.create(params, make_optimizer(1e-3))


def _names(root):
    return {p.name for p in root.iterdir() if p.name.startswith("epoch=")}


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpts")
    state = _state()
    state.opt_state.mu["sampler.w"].fill_(0.25)
    state.opt_state.count, state.step = 3, 7
    mgr.save(state, epoch=0, step=10, val_loss=1.5)
    payload = mgr.restore(tmp_path / "ckpts" / checkpoint_name(0, 10, 1.5))
    torch.testing.assert_close(payload["params"]["sampler.w"],
                               state.params["sampler.w"], rtol=0, atol=0)
    assert payload["step"] == 7 and payload["opt_state"]["count"] == 3
    fresh = _state(5)
    fresh.load_state_dict(payload)
    assert torch.equal(fresh.params["sampler.w"], state.params["sampler.w"])
    assert torch.equal(fresh.opt_state.mu["sampler.w"],
                       torch.full((4, 4), 0.25))
    assert (fresh.step, fresh.opt_state.count) == (7, 3)
    ckpt = tmp_path / "ckpts" / checkpoint_name(0, 10, 1.5)
    assert sorted(p.name for p in ckpt.iterdir()) == ["meta.json", "state.pt"]


def test_topk_and_best(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpts", top_k=2)
    for i, vl in enumerate([3.0, 1.0, 2.0, 0.5]):
        mgr.save(_state(i), epoch=i, step=i * 10, val_loss=vl)
    names = _names(tmp_path / "ckpts")
    # top-2 by val_loss: 0.5 and 1.0 survive
    assert len(names) == 2
    assert any("val_loss=0.500" in n for n in names)
    assert any("val_loss=1.000" in n for n in names)
    best = resolve_best_checkpoint(tmp_path / "ckpts")
    assert "val_loss=0.500" in best.name
    # last symlink points at the most recent save
    last = tmp_path / "ckpts" / "last"
    assert last.is_symlink()
    assert "val_loss=0.500" in str(last.readlink())


def test_best_checkpoint_reads_the_whole_val_loss(tmp_path):
    """The best of two checkpoints whose val losses share their integer
    part (a known fault of the JAX package's pattern, which reads only that
    part and takes the first directory listed; the port reads the whole
    number, also before a file extension)."""
    from vaura_tpu.utils.experiment import CKPT_NAME_RE as J_RE

    for names, want in (
        (["epoch=0-step=3-val_loss=6.931", "epoch=1-step=6-val_loss=6.930"],
         "epoch=1-step=6-val_loss=6.930"),
        (["epoch=4-step=5-val_loss=1.250.ckpt", "epoch=2-step=3-val_loss=1.5.ckpt",
          "epoch=9-step=9-val_loss=10.000"], "epoch=4-step=5-val_loss=1.250.ckpt"),
    ):
        d = tmp_path / names[0]
        for n in names:
            (d / n).mkdir(parents=True)
        assert resolve_best_checkpoint(d).name == want
    assert J_RE.search("epoch=1-step=6-val_loss=6.930").group("val") == "6"


def test_frozen_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpts")
    frozen = {"dac.w": torch.arange(6.0).reshape(2, 3)}
    mgr.save_frozen(frozen)
    back = mgr.restore_frozen()
    assert torch.equal(back["dac.w"], torch.arange(6.0).reshape(2, 3))
    assert CheckpointManager.read_meta(tmp_path / "ckpts" / "frozen") is None


def test_emergency_save(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpts")
    path = mgr.save_emergency(_state(), epoch=4)
    assert path.exists()
    assert path.name.startswith("e4_last_at_")
    assert CheckpointManager.read_meta(path) == {"epoch": 4,
                                                 "epoch_complete": False}
    assert mgr._saved == []  # never in the top-k ledger


def test_restore_best_via_manager(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpts", top_k=3)
    s1, s2 = _state(1), _state(2)
    mgr.save(s1, 0, 1, 2.0)
    mgr.save(s2, 1, 2, 1.0)
    payload = mgr.restore_best()
    assert torch.equal(payload["params"]["sampler.w"], s2.params["sampler.w"])


def test_async_save_semantics(tmp_path):
    """async_save defers meta.json/top-k/`last` bookkeeping to the next
    save/restore/finalize; all observable contracts (round trip, top-k
    retention, best resolution, symlink) must match the sync manager, and
    a save copies the tensors before returning."""
    mgr = CheckpointManager(tmp_path / "ckpts", top_k=2, async_save=True)
    states = [_state(i) for i in range(4)]
    want = states[3].params["sampler.w"].clone()
    for i, vl in enumerate([3.0, 1.0, 2.0, 0.5]):
        mgr.save(states[i], epoch=i, step=i * 10, val_loss=vl)
    states[3].params["sampler.w"].add_(1.0)  # after save(): not in the file
    payload = mgr.restore(tmp_path / "ckpts" / "last")
    assert torch.equal(payload["params"]["sampler.w"], want)
    names = _names(tmp_path / "ckpts")
    assert len(names) == 2
    assert any("val_loss=0.500" in n for n in names)
    assert any("val_loss=1.000" in n for n in names)
    best = resolve_best_checkpoint(tmp_path / "ckpts")
    assert "val_loss=0.500" in best.name
    meta = json.loads((best / "meta.json").read_text())
    assert meta["epoch"] == 3 and meta["step"] == 30
    mgr.finalize()  # idempotent


def test_async_save_failure_raises_at_finalize(tmp_path, monkeypatch):
    """A write that fails in the thread raises at ``finalize()``, and the
    failed save enters neither the ledger nor ``last``."""
    from vaura_tpu_torch.train import checkpoint as C

    mgr = CheckpointManager(tmp_path / "ckpts", async_save=True)
    mgr.save(_state(0), epoch=0, step=1, val_loss=1.0)
    mgr.finalize()

    def fail(path, payload):
        raise OSError("disk full")

    monkeypatch.setattr(C, "_write", fail)
    mgr.save(_state(1), epoch=1, step=2, val_loss=0.5)
    with pytest.raises(OSError, match="disk full"):
        mgr.finalize()
    assert [p.name for _, p in mgr._saved] == [checkpoint_name(0, 1, 1.0)]
    assert "step=1" in str((tmp_path / "ckpts" / "last").readlink())
    mgr.finalize()  # nothing left in flight


def test_ledger_rebuilt_across_instances(tmp_path):
    mgr1 = CheckpointManager(tmp_path / "ckpts", top_k=2)
    mgr1.save(_state(0), epoch=0, step=1, val_loss=1.0)
    mgr1.save(_state(1), epoch=1, step=2, val_loss=2.0)
    mgr2 = CheckpointManager(tmp_path / "ckpts", top_k=2)
    mgr2.save(_state(2), epoch=2, step=3, val_loss=0.5)
    names = _names(tmp_path / "ckpts")
    assert len(names) == 2, names
    assert any("val_loss=0.500" in n for n in names)
    assert any("val_loss=1.000" in n for n in names)  # 2.0 pruned


def test_resume_save_worse_keeps_last_target(tmp_path):
    mgr1 = CheckpointManager(tmp_path / "ckpts", top_k=2)
    mgr1.save(_state(0), epoch=0, step=1, val_loss=1.0)
    mgr1.save(_state(1), epoch=1, step=2, val_loss=2.0)
    mgr2 = CheckpointManager(tmp_path / "ckpts", top_k=2)
    path = mgr2.save(_state(2), epoch=2, step=3, val_loss=3.0)
    assert path.exists(), "just-saved checkpoint was pruned"
    last = tmp_path / "ckpts" / "last"
    assert last.is_symlink()
    assert (last.parent / last.readlink()).exists(), "`last` dangles"
    assert "val_loss=3.000" in str(last.readlink())
    names = _names(tmp_path / "ckpts")
    assert any("val_loss=1.000" in n for n in names)
    assert any("val_loss=2.000" in n for n in names)
    mgr2.save(_state(3), epoch=3, step=4, val_loss=0.9)
    names = _names(tmp_path / "ckpts")
    assert len(names) == 2, names
    assert any("val_loss=0.900" in n for n in names)
    assert any("val_loss=1.000" in n for n in names)
    assert (last.parent / last.readlink()).exists()


def test_save_overwrite_same_name_no_stale_ledger(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpts", top_k=2)
    p1 = mgr.save(_state(0), epoch=0, step=1, val_loss=1.0)
    p2 = mgr.save(_state(1), epoch=0, step=1, val_loss=1.0)  # same name
    assert p1 == p2
    assert len(mgr._saved) == 1
    assert torch.equal(mgr.restore(p2)["params"]["sampler.w"],
                       _state(1).params["sampler.w"])
    mgr.save(_state(2), epoch=1, step=2, val_loss=0.5)
    mgr.save(_state(3), epoch=2, step=3, val_loss=0.7)
    names = _names(tmp_path / "ckpts")
    assert len(names) <= 3  # top-2 + possibly the `last` target
    assert p2.exists() or not any("step=1-" in n for n in names)


def test_read_meta(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpts")
    mgr.save(_state(), epoch=3, step=30, val_loss=1.25,
             metadata={"early_stop_best": 1.25, "early_stop_count": 1})
    meta = CheckpointManager.read_meta(tmp_path / "ckpts" / "last")
    assert meta["epoch"] == 3 and meta["step"] == 30
    assert meta["early_stop_best"] == 1.25 and meta["early_stop_count"] == 1
    em = mgr.save_emergency(
        _state(), epoch=7,
        metadata={"early_stop_best": 2.5, "early_stop_count": 1, "step": 70},
    )
    em_meta = CheckpointManager.read_meta(em)
    assert em_meta["epoch"] == 7 and em_meta["epoch_complete"] is False
    assert em_meta["early_stop_best"] == 2.5 and em_meta["step"] == 70
    (em / "meta.json").unlink()
    legacy = CheckpointManager.read_meta(em)
    assert legacy == {"epoch": 7, "epoch_complete": False}
    assert CheckpointManager.read_meta(tmp_path / "ckpts" / "frozen") is None


def test_restore_trainable_params_from_training_ckpt(tmp_path):
    """The params out of a training checkpoint, against the optimizer
    rebuilt from the configs; a params-only file; a state that does not fit
    the rebuilt optimizer raises."""
    mgr = CheckpointManager(tmp_path / "ckpts")
    state = _state(7)
    mgr.save(state, epoch=0, step=5, val_loss=1.0)
    path = tmp_path / "ckpts" / checkpoint_name(0, 5, 1.0)
    like = {k: torch.empty_like(v, device="meta", dtype=torch.bfloat16)
            for k, v in state.params.items()}
    got = restore_trainable_params(path, like, {"learning_rate": 1e-3}, {})
    assert got["sampler.w"].dtype == torch.bfloat16
    assert got["sampler.w"].device == torch.device("cpu")
    assert torch.equal(got["sampler.w"],
                       state.params["sampler.w"].to(torch.bfloat16))
    torch.save({"params": state.params}, tmp_path / "params.pt")
    got = restore_trainable_params(tmp_path / "params.pt", state.params, {})
    assert torch.equal(got["sampler.w"], state.params["sampler.w"])
    # accumulation adds an `acc` leaf per parameter the saved state lacks
    with pytest.raises(ValueError, match="opt_state.acc"):
        restore_trainable_params(path, state.params, {},
                                 {"accumulate_grad_batches": 2})
    with pytest.raises(ValueError, match="missing"):
        restore_trainable_params(path, {**state.params,
                                        "bridge.w": torch.zeros(2)}, {})


# --------------------------------------------------------------------------
# against the JAX package's manager

def _jax_state(seed=0):
    from vaura_tpu.train.state import TrainState as JState
    from vaura_tpu.train.state import make_optimizer as j_make_optimizer

    params = {"sampler": {"w": jax.random.normal(jax.random.PRNGKey(seed),
                                                 (4, 4)),
                          "uncond_embedding": jnp.ones((2, 3))}}
    return JState.create(params, j_make_optimizer(1e-3))


# (new manager?, epoch, step, val_loss): an overwrite of the same name, a
# resume in a new manager, a worse save after it, then a better one
SAVES = [(False, 0, 10, 3.0), (False, 1, 20, 1.0), (False, 1, 20, 1.0),
         (False, 2, 30, 2.0), (True, 3, 40, 4.0), (False, 4, 50, 0.5),
         (False, 5, 60, 1.5)]


@pytest.mark.parametrize("save_last", [True, False])
@pytest.mark.parametrize("top_k", [1, 2])
def test_same_directories_last_and_meta_as_jax(tmp_path, top_k, save_last):
    from vaura_tpu.train.checkpoint import CheckpointManager as JManager

    dirs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    make = {"jax": lambda: JManager(dirs["jax"], top_k=top_k,
                                    save_last=save_last),
            "port": lambda: CheckpointManager(dirs["port"], top_k=top_k,
                                              save_last=save_last)}
    state = {"jax": _jax_state(), "port": _state()}
    mgrs = {k: make[k]() for k in make}
    for new, epoch, step, val in SAVES:
        for k in mgrs:
            if new:
                mgrs[k] = make[k]()
            mgrs[k].save(state[k], epoch, step, val,
                         metadata={"early_stop_count": step})
        assert _names(dirs["port"]) == _names(dirs["jax"]), (epoch, step)
        links = {k: (d / "last").readlink() if (d / "last").is_symlink()
                 else None for k, d in dirs.items()}
        assert links["port"] == links["jax"]
    em = {k: mgrs[k].save_emergency(state[k], epoch=9, tag="x") for k in mgrs}
    assert em["port"].name.startswith("e9_last_at_")
    assert em["jax"].name.startswith("e9_last_at_")
    for name in _names(dirs["jax"]) | {"last"}:
        if (dirs["jax"] / name).exists():
            assert (CheckpointManager.read_meta(dirs["port"] / name)
                    == JManager.read_meta(dirs["jax"] / name)), name
    assert (CheckpointManager.read_meta(em["port"])
            == JManager.read_meta(em["jax"]))


# --------------------------------------------------------------------------
# a restored state trains on exactly as one never saved

def test_restored_train_state_steps_as_one_never_saved(tmp_path):
    """The tiny training configuration with seeded weights: one step, a
    save, a second step; a fresh state restored from the save takes the
    second step to the same loss, parameters and moments, bit for bit."""
    from vaura_tpu_torch.models.vaura import VauraSystem
    from vaura_tpu_torch.train.steps import make_train_step, split_params
    from vaura_tpu_torch.utils import seeded_init_

    rng = np.random.default_rng(0)
    batches = [{"frames": torch.from_numpy(rng.standard_normal(
                    (2, 2, 3, 4, 16, 16)).astype(np.float32)),
                "codes": torch.from_numpy(rng.integers(
                    0, J_SAMPLER_TRAIN.d_codebook,
                    (2, J_SAMPLER_TRAIN.num_codebooks, 10)))}
               for _ in range(2)]

    def fresh():
        tsys = VauraSystem(port_sampler_config(J_SAMPLER_TRAIN),
                           port_dac_config(),
                           port_encoder_config(J_ENC_TRAIN), device="cpu")
        seeded_init_(tsys, torch.Generator().manual_seed(0))
        trainable, _ = split_params(tsys)
        return tsys, TrainState.create(trainable, make_optimizer(1e-3))

    sys_a, state_a = fresh()
    step_a = make_train_step(sys_a)
    state_a, _ = step_a(state_a, batches[0])
    path = CheckpointManager(tmp_path / "ckpts").save(state_a, 0, 1, 1.0)
    state_a, metrics_a = step_a(state_a, batches[1])

    sys_b, state_b = fresh()
    state_b.load_state_dict(CheckpointManager(tmp_path / "ckpts").restore(path))
    assert state_b.step == 1 and state_b.opt_state.count == 1
    state_b, metrics_b = make_train_step(sys_b)(state_b, batches[1])
    assert float(metrics_b["loss"]) == float(metrics_a["loss"])
    for k, v in state_a.params.items():
        assert torch.equal(state_b.params[k], v), k
    for k, v in state_a.opt_state.nu.items():
        assert torch.equal(state_b.opt_state.nu[k], v), k


# --------------------------------------------------------------------------
# JAX weights through the port's checkpoint

def _dummy_model_cfg():
    from pathlib import Path

    from vaura_tpu_torch.config import assemble_config

    repo = Path(__file__).resolve().parents[1]
    return assemble_config(
        [f"config={repo / 'configs/experiments/dummy.yaml'}"],
        defaults_path=repo / "configs" / "vaura_defaults.yaml",
        base_dir=repo)["model"]


def test_jax_weights_saved_and_restored_give_jax_logits(tmp_path):
    """The tiny ``dummy.yaml`` model: JAX sampler weights converted, saved by
    the port as a training checkpoint, restored into a new system by
    ``load_trainable_``; its teacher-forced logits against JAX's (float32,
    the tolerance of ``tests/test_torch_sampler.py``) and their argmax
    equal."""
    import copy

    from vaura_tpu.models.factory import build_system as j_build
    from vaura_tpu_torch.convert import from_jax_params
    from vaura_tpu_torch.models.factory import build_system as t_build
    from vaura_tpu_torch.train.steps import split_params

    model_cfg = _dummy_model_cfg()
    jsys = j_build(copy.deepcopy(model_cfg), precision="f32")
    cfg = jsys.sampler_config
    r = jax.random.PRNGKey(3)
    tree = jax.jit(lambda r: jsys.sampler.init(
        {"params": r, "dropout": r, "cfg_dropout": r},
        jnp.zeros((1, cfg.num_codebooks, 16), jnp.int32),
        jnp.zeros((1, 8, cfg.cond_in_dim)), False))(r)["params"]
    tree = randomize_sampler_heads(
        jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree), 4)

    tsys = t_build(copy.deepcopy(model_cfg), precision="f32", device="cpu")
    tsys.load_state_dicts(from_jax_params({"sampler": tree}))
    trainable, _ = split_params(tsys)
    assert {k.split(".")[0] for k in trainable} == {"sampler"}
    path = CheckpointManager(tmp_path / "ckpts").save(
        TrainState.create(trainable, make_optimizer(1e-3)), 0, 1, 1.0)
    restored = t_build(copy.deepcopy(model_cfg), precision="f32",
                       device="cpu")
    load_trainable_(restored, tmp_path / "ckpts" / "last", model_cfg)
    restored.requires_grad_(False)

    rng = np.random.default_rng(0)
    codes = rng.integers(0, cfg.d_codebook, (2, cfg.num_codebooks, 20))
    vis = rng.standard_normal((2, 8, cfg.cond_in_dim)).astype(np.float32)
    _, jaux = jax.jit(lambda p: jsys.train_forward(
        p, None, None, jax.random.PRNGKey(0), train=False,
        vis_feats=jnp.asarray(vis), codes=jnp.asarray(codes)))(
        {"sampler": jax.tree_util.tree_map(jnp.asarray, tree)})
    with torch.no_grad():
        _, taux = restored.train_forward(
            None, None, None, train=False, vis_feats=torch.from_numpy(vis),
            codes=torch.from_numpy(codes))
    want = np.asarray(jaux["logits"], np.float32)
    got = taux["logits"].numpy()
    mask = np.asarray(jaux["mask"], bool)
    np.testing.assert_array_equal(taux["mask"].numpy(), mask)
    np.testing.assert_allclose(got[mask], want[mask], rtol=2e-5, atol=2e-5)
    assert (got[mask].argmax(-1) == want[mask].argmax(-1)).all()
    assert path.exists()


def test_orbax_directory_raises(tmp_path):
    """A checkpoint of the JAX package's own training (orbax) raises
    ``ValueError`` naming it, at every entry that reads checkpoints."""
    import orbax.checkpoint as ocp

    from vaura_tpu.train.checkpoint import CheckpointManager as JManager

    JManager(tmp_path / "jax").save(_jax_state(), 0, 1, 1.0)
    path = tmp_path / "jax" / checkpoint_name(0, 1, 1.0)
    with pytest.raises(ValueError, match="JAX package"):
        restore_trainable_params(path, _state().params, {})
    with pytest.raises(ValueError, match="JAX package"):
        CheckpointManager(tmp_path / "jax").restore(path)
    tree = tmp_path / "tree"
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(tree.resolve(), {"w": np.zeros(3, np.float32)})
        ckptr.wait_until_finished()
    with pytest.raises(ValueError, match="orbax"):
        restore_trainable_params(tree, {"w": torch.zeros(3)}, {})
