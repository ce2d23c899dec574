"""The port's multi-device path in several processes on the CPU (``gloo``),
against ``vaura_tpu`` on one CPU device.

One spawn of 8 processes runs the tiny float32 training system (every
stochastic rate 0 where JAX is the reference) on a 2 x 2 x 2 ``(data, fsdp,
model)`` mesh
(``tests/torch_mesh_worker.py``); one spawn of 1 process runs it at 1 x 1 x
1; the JAX package's ``make_train_step`` and ``generate`` run here on the
same converted weights and batches. Held:

  * two sharded train steps (AdamW, decay 0.01, value clipping): losses
    within 1e-5, every updated parameter rtol 1e-4 / atol 1e-6 of JAX's;
    the same with global-norm clipping;
  * two sharded train steps with dropout, attention dropout, stochastic
    depth and class dropout on (sampler and encoder, remat) from a seeded
    generator: losses within 1e-5, parameters rtol 1e-4 / atol 2e-5 of the
    same steps in one process without a mesh (the masks are the rows and
    heads of the one-process draws; JAX's cannot be drawn here). AdamW's
    first step is about lr * sign(g) (2e-3 here), so a parameter whose
    gradient is near 0 moves by up to a few 1e-6 when the shards sum in
    another order; a mask drawn otherwise moves it by the order of lr, as
    the same steps from another seed show (held above 1e-4);
  * the masked loss over rows whose masks differ across the ranks: loss
    within 1e-6 and its gradient within 1e-6 of JAX's on the whole batch;
  * greedy generation (CFG 3) token for token, audio within 1e-4; the
    same with LoRA adapters (rank 4) placed for generation
    (``shard_module(..., train=False)``: the adapters whole on every rank,
    each delta cut as its weight over ``model``), against JAX's ``generate``
    on the same converted ``lora_sampler`` tree;
  * sampled codes equal at 1 x 1 x 1, at 2 x 2 x 2 and in one process
    without a mesh;
  * a checkpoint gathered under the mesh loads bit-equal into one process,
    and a one-process checkpoint into the mesh and back out bit-equal;
  * LoRA training on the mesh (the same adapters, the encoder and the
    bridge training beside them): two steps with value clipping and two
    with norm clipping against JAX's one-device ``make_train_step``
    (losses within 1e-5, parameters rtol 1e-4 / atol 1e-6, the base
    sampler unchanged bit for bit), two with remat and every stochastic
    rate on against one process (as the full-training steps above), and a
    LoRA checkpoint across the mesh and one process both ways, bit-equal.

Also two processes hold ``initialize_distributed`` and
``is_main_process``, as ``tests/test_multihost.py`` does for JAX. Each
worker sets one thread; each spawn's processes have 180 s.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (
    J_DAC,
    J_ENC_TRAIN,
    J_SAMPLER_TRAIN,
    flat_state_dicts,
    init_jax_train_system,
    jax_train_state,
    np_tree,
    port_dac_config,
    port_encoder_config,
    port_sampler_config,
    port_train_system,
    train_batch,
)

from vaura_tpu.models.vaura import VauraSystem as JSystem
from vaura_tpu.ops.losses import masked_codebook_cross_entropy as j_loss
from vaura_tpu.train.lora import DEFAULT_TARGETS
from vaura_tpu.train.lora import init_lora as j_init_lora
from vaura_tpu.train.steps import make_train_step as j_make_train_step
from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.models.vaura import VauraSystem
from vaura_tpu_torch.train.state import TrainState, make_optimizer
from vaura_tpu_torch.train.steps import make_train_step, split_params

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_mesh_worker.py"
SPAWN_TIMEOUT_S = 180
RNG = jax.random.PRNGKey(0)
B = 4                      # the global batch: one row a (data, fsdp) shard
MAX_NEW = 12
OPT = dict(learning_rate=1e-3, weight_decay=0.01, gradient_clip_val=1.0,
           gradient_clip_algorithm="value")
OPT_NORM = dict(learning_rate=1e-3, weight_decay=0.0, gradient_clip_val=0.05,
                gradient_clip_algorithm="norm")
GREEDY = dict(max_new_tokens=MAX_NEW, use_sampling=False, cfg_scale=3.0)
SAMPLED = dict(max_new_tokens=MAX_NEW, top_k=4, cfg_scale=3.0, seed=5,
               decode_to_audio=False)
STOCHASTIC_SEED = 11
LORA_RANK, LORA_ALPHA = 4, 8.0


def stochastic_configs():
    """The tiny training configuration with every stochastic rate on, and
    the decoder's blocks recomputed in the backward pass."""
    return (port_sampler_config(J_SAMPLER_TRAIN, dropout=0.1,
                                attn_dropout_p=0.1, class_dropout_prob=0.5,
                                drop_path_rate=0.1, remat=True),
            port_dac_config(),
            port_encoder_config(J_ENC_TRAIN, drop_rate=0.1,
                                drop_path_rate=0.1))


def lora_tree(tree):
    """JAX's adapters over ``tree``'s sampler (rank 4, every default
    target), ``lora_b`` filled with seeded values (a zero ``b`` merges to
    the base)."""
    lora = np_tree(j_init_lora(jax.random.PRNGKey(3), tree["sampler"],
                               LORA_RANK, DEFAULT_TARGETS))
    rng = np.random.default_rng(4)
    for mod in lora["layers"].values():
        for pair in mod.values():
            pair["lora_b"] = (0.05 * rng.standard_normal(
                pair["lora_b"].shape)).astype(np.float32)
    return lora


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(mode: str, n: int, payload, out: Path):
    """``n`` worker processes with torchrun's environment; returns their
    ``(returncode, output)``. A worker that outlives the timeout is killed
    and fails the caller's test."""
    out.mkdir(parents=True, exist_ok=True)
    path = out / "payload.pt"
    torch.save(payload, path)
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), mode, str(path), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs


def wait(procs):
    results = []
    for p in procs:
        try:
            text, _ = p.communicate(timeout=SPAWN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a worker outlived {SPAWN_TIMEOUT_S} s")
        results.append((p.returncode, text))
    for rc, text in results:
        assert rc == 0, text[-4000:]
    return results


def lora_system(configs, sds, lora_sd):
    """A one-process system of ``configs`` with ``sds`` and the adapters
    ``lora_sd`` (rank 4, alpha 8)."""
    system = VauraSystem(*configs, device="cpu", lora_rank=LORA_RANK,
                         lora_alpha=LORA_ALPHA)
    system.load_state_dicts(dict(sds, lora_sampler=lora_sd))
    return system


def _state_copy(state) -> dict:
    """A detached copy of ``state.state_dict()``."""
    sd = state.state_dict()
    return {"params": {k: v.detach().clone() for k, v in sd["params"].items()},
            "opt_state": {k: ({n: t.clone() for n, t in v.items()}
                              if isinstance(v, dict) else v)
                          for k, v in sd["opt_state"].items()},
            "step": sd["step"]}


def _lora_resume(tree, lora_sd, batch) -> dict:
    """A one-process LoRA checkpoint after one step, for the mesh to
    load."""
    system = lora_system((port_sampler_config(J_SAMPLER_TRAIN),
                          port_dac_config(), port_encoder_config(J_ENC_TRAIN)),
                         from_jax_params(tree), lora_sd)
    trainable, _ = split_params(system)
    state = TrainState.create(trainable, make_optimizer(**OPT))
    state, _ = make_train_step(system)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return _state_copy(state)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jsys, tree = init_jax_train_system(0)
    sds = from_jax_params(tree)
    configs = (port_sampler_config(J_SAMPLER_TRAIN), port_dac_config(),
               port_encoder_config(J_ENC_TRAIN))
    batches = [train_batch(s, batch=B) for s in range(2)]
    rng = np.random.default_rng(3)
    masked = {  # 8 rows of logits whose masks differ from row to row
        "logits": torch.from_numpy(rng.standard_normal(
            (8, 3, 10, 16)).astype(np.float32)),
        "targets": torch.from_numpy(rng.integers(0, 16, (8, 3, 10))),
        "mask": torch.from_numpy(rng.random((8, 3, 10)) < np.linspace(
            0.1, 0.9, 8)[:, None, None]),
    }
    frames = rng.standard_normal((B, 2, 3, 4, 16, 16)).astype(np.float32)
    lora = lora_tree(tree)
    # a one-process checkpoint after one step, for the mesh to resume
    tsys = port_train_system(tree)
    trainable, _ = split_params(tsys)
    state = TrainState.create(trainable, make_optimizer(**OPT))
    state, _ = make_train_step(tsys)(
        state, {k: torch.from_numpy(v) for k, v in batches[0].items()})
    resume = _state_copy(state)
    lora_sd = from_jax_params({"lora_sampler": lora})["lora_sampler"]
    payload = {
        "configs": configs, "state_dicts": sds,
        "batches": [{k: torch.from_numpy(v) for k, v in b.items()}
                    for b in batches],
        "train": OPT, "train_norm": OPT_NORM, "masked": masked,
        "resume": resume,
        "stochastic": {"configs": stochastic_configs(),
                       "seed": STOCHASTIC_SEED},
        "generate": {"frames": torch.from_numpy(frames),
                     "runs": {"greedy": GREEDY, "sampled": SAMPLED}},
        "lora": {"rank": LORA_RANK, "alpha": LORA_ALPHA, "kw": GREEDY,
                 "state_dict": lora_sd},
        "lora_train": {"resume": _lora_resume(tree, lora_sd, batches[0])},
    }
    root = tmp_path_factory.mktemp("mesh")
    big = spawn("mesh", 8, {**payload, "mesh": (2, 2, 2)}, root / "m222")
    one = spawn("mesh", 1, {
        "configs": configs, "state_dicts": sds, "batches": [],
        "generate": {"frames": torch.from_numpy(frames),
                     "runs": {"sampled": SAMPLED}},
        "mesh": (1, 1, 1)}, root / "m111")
    wait(big)
    wait(one)
    return {"jsys": jsys, "tree": tree, "sds": sds, "configs": configs, "batches": batches,
            "lora": lora, "lora_sd": lora_sd,
            "lora_resume": payload["lora_train"]["resume"],
            "masked": masked,
            "frames": frames, "resume": resume,
            "m222": torch.load(root / "m222" / "result.pt", weights_only=False),
            "m111": torch.load(root / "m111" / "result.pt", weights_only=False)}


def _jax_steps(runs, opt, lora=False):
    """JAX's ``make_train_step`` on one device over the run's tree (with
    ``lora``, the adapters train beside the encoder and the bridge)."""
    jsys, tree = runs["jsys"], runs["tree"]
    if lora:
        tree = dict(tree, lora_sampler=runs["lora"])
        jsys = JSystem(sampler_config=J_SAMPLER_TRAIN, dac_config=J_DAC,
                       encoder_config=J_ENC_TRAIN, lora_rank=LORA_RANK,
                       lora_alpha=LORA_ALPHA)
    kw = dict(opt)
    lr = kw.pop("learning_rate")
    jstate, jfrozen = jax_train_state(jsys, tree, lr, **kw)
    step = j_make_train_step(jsys, donate=False)
    losses, per_cb = [], []
    for b in runs["batches"]:
        jstate, m = step(jstate, jfrozen,
                         {k: jnp.asarray(v) for k, v in b.items()}, RNG)
        losses.append(float(m["loss"]))
        per_cb.append(np.asarray(m["loss_per_codebook"]))
    return jstate, losses, per_cb


def _assert_params(got: dict, jstate):
    want = flat_state_dicts(from_jax_params(np_tree(jstate.params)))
    assert set(want) == set(got)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_sharded_train_steps_match_jax(runs):
    jstate, losses, per_cb = _jax_steps(runs, OPT)
    got = runs["m222"]
    np.testing.assert_allclose(got["losses"], losses, rtol=0, atol=1e-5)
    for g, w in zip(got["per_cb"], per_cb):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)
    assert got["state"]["step"] == 2 and got["state"]["opt_state"]["count"] == 2
    _assert_params(got["state"]["params"], jstate)


def test_sharded_global_norm_clipping_matches_jax(runs):
    jstate, losses, _ = _jax_steps(runs, OPT_NORM)
    got = runs["m222"]
    np.testing.assert_allclose(got["norm_losses"], losses, rtol=0, atol=1e-5)
    _assert_params(got["norm_state"]["params"], jstate)


def _one_process_stochastic_steps(runs, seed, lora=False):
    if lora:
        system = lora_system(stochastic_configs(), runs["sds"],
                             runs["lora_sd"])
    else:
        system = VauraSystem(*stochastic_configs(), device="cpu")
        system.load_state_dicts(runs["sds"])
    trainable, _ = split_params(system)
    state = TrainState.create(trainable, make_optimizer(**OPT))
    step = make_train_step(system)
    generator = torch.Generator().manual_seed(seed)
    losses = []
    for b in runs["batches"]:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                        generator)
        losses.append(float(m["loss"]))
    return losses, {k: v.detach() for k, v in
                    state.state_dict()["params"].items()}


def test_sharded_stochastic_steps_match_one_process(runs):
    losses, want = _one_process_stochastic_steps(runs, STOCHASTIC_SEED)
    got = runs["m222"]
    # the rates move the loss, so equal losses hold the masks
    assert abs(losses[0] - got["losses"][0]) > 1e-3
    np.testing.assert_allclose(got["stochastic_losses"], losses, rtol=0,
                               atol=1e-5)
    have = got["stochastic_state"]["params"]
    assert set(want) == set(have)
    for k, w in want.items():
        np.testing.assert_allclose(have[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=2e-5, err_msg=k)
    # the control: other masks move the parameters past that tolerance
    _, other = _one_process_stochastic_steps(runs, STOCHASTIC_SEED + 1)
    assert max(float((other[k] - have[k]).abs().max()) for k in want) > 1e-4


def test_masked_loss_with_masks_that_differ_across_ranks(runs):
    m = runs["masked"]
    assert len({int(m["mask"][r].sum()) for r in range(8)}) > 4
    args = [jnp.asarray(m[k].numpy()) for k in ("logits", "targets", "mask")]
    (loss, per_cb), grad = jax.value_and_grad(
        lambda x, t, k: j_loss(x, t, k), has_aux=True)(*args)
    got = runs["m222"]["masked"]
    np.testing.assert_allclose(got["loss"].item(), float(loss), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got["per_cb"].numpy(), np.asarray(per_cb),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["grad"].numpy(), np.asarray(grad), rtol=0,
                               atol=1e-6)


def test_sharded_greedy_generation_matches_jax(runs):
    jsys, tree = runs["jsys"], runs["tree"]
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    vis = jax.jit(jsys.visual_features)(jp, jnp.asarray(runs["frames"]))
    want = jsys.generate(jp, None, RNG, vis_feats=vis, decode_buckets=1,
                         decode_to_audio=False, **GREEDY)
    got = runs["m222"]["greedy"]
    assert got["codes"].shape == (B, 3, MAX_NEW)
    np.testing.assert_array_equal(got["codes"].numpy(),
                                  np.asarray(want["codes"]))
    want_audio = jax.jit(jsys.decode_audio)(jp, want["codes"])
    np.testing.assert_allclose(got["audio"].numpy(), np.asarray(want_audio),
                               rtol=0, atol=1e-4)


def test_sharded_lora_generation_matches_jax(runs):
    """Greedy generation with adapters at 2 x 2 x 2 (the adapters whole on
    every rank, each delta cut as its weight over ``model``, merged into
    the gathered weights once a call) against JAX's ``generate`` on the
    same converted tree, whose ``_resolve_params`` merges them; and other
    codes than the base's."""
    tree = dict(runs["tree"], lora_sampler=runs["lora"])
    jsys = JSystem(sampler_config=J_SAMPLER_TRAIN, dac_config=J_DAC,
                   encoder_config=J_ENC_TRAIN, lora_rank=LORA_RANK,
                   lora_alpha=LORA_ALPHA)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    vis = jax.jit(jsys.visual_features)(jp, jnp.asarray(runs["frames"]))
    want = jsys.generate(jp, None, RNG, vis_feats=vis, decode_buckets=1,
                         decode_to_audio=False, **GREEDY)
    got = runs["m222"]["lora"]["codes"]
    assert got.shape == (B, 3, MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want["codes"]))
    assert not torch.equal(got, runs["m222"]["greedy"]["codes"])


@pytest.mark.parametrize("clip", ["value", "norm"])
def test_sharded_lora_steps_match_jax(runs, clip):
    """Two LoRA steps at 2 x 2 x 2 (the base sampler split over ``model``
    and FSDP2-sharded, frozen; the adapters whole on every rank, merged per
    block into its gathered weight, their gradients summed over the mesh;
    the encoder and the bridge train beside them, as JAX's
    ``split_params``) against JAX's one-device ``make_train_step`` on the
    same tree: losses within 1e-5, the adapters, encoder and bridge rtol
    1e-4 / atol 1e-6; the checkpoint holds no base-sampler leaf, and the
    base sampler gathered after the steps is bit for bit its start. Norm
    clipping at 0.05 clips (the adapters counted once in the norm)."""
    jstate, losses, _ = _jax_steps(runs, OPT if clip == "value" else OPT_NORM,
                                   lora=True)
    got = runs["m222"]["lora_train"]
    np.testing.assert_allclose(got[clip]["losses"], losses, rtol=0,
                               atol=1e-5)
    params = got[clip]["state"]["params"]
    assert not any(k.startswith("sampler.") for k in params)
    assert any(k.startswith("lora_sampler.") for k in params)
    _assert_params(params, jstate)
    base = got["base"]
    assert set(base) == set(runs["sds"]["sampler"])
    for k, v in runs["sds"]["sampler"].items():
        assert torch.equal(base[k], v), k


def test_sharded_lora_stochastic_steps_match_one_process(runs):
    """Two LoRA steps at 2 x 2 x 2 with ``remat`` and every stochastic rate
    on (the rerun of each block merges again from its re-gathered weight)
    against the same steps in one process: losses within 1e-5, parameters
    rtol 1e-4 / atol 2e-5 (as the full-training steps above)."""
    losses, want = _one_process_stochastic_steps(runs, STOCHASTIC_SEED,
                                                 lora=True)
    got = runs["m222"]["lora_train"]["stochastic"]
    np.testing.assert_allclose(got["losses"], losses, rtol=0, atol=1e-5)
    have = got["state"]["params"]
    assert set(want) == set(have)
    assert any(k.startswith("lora_sampler.") for k in have)
    for k, w in want.items():
        np.testing.assert_allclose(have[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=2e-5, err_msg=k)


def test_lora_checkpoints_cross_between_mesh_and_one_process(runs):
    """A LoRA checkpoint gathered under the mesh (adapters, encoder,
    bridge and their moments) loads bit-equal into a one-process LoRA
    state, and a one-process LoRA checkpoint loads into the mesh and
    gathers back bit-equal."""
    got = runs["m222"]["lora_train"]
    system = lora_system(runs["configs"], runs["sds"], runs["lora_sd"])
    trainable, _ = split_params(system)
    state = TrainState.create(trainable, make_optimizer(**OPT))
    state.load_state_dict(got["value"]["state"])
    sd = state.state_dict()
    for tree_a, tree_b in ((got["value"]["state"], sd),
                           (runs["lora_resume"], got["resumed"])):
        assert tree_a["step"] == tree_b["step"]
        assert set(tree_a["params"]) == set(tree_b["params"]) == set(trainable)
        for k, v in tree_a["params"].items():
            assert torch.equal(tree_b["params"][k].detach(), v), k
        for key in ("mu", "nu"):
            for k, v in tree_a["opt_state"][key].items():
                assert torch.equal(tree_b["opt_state"][key][k], v), (key, k)


def test_sampled_codes_do_not_depend_on_the_mesh(runs):
    a, b = runs["m222"]["sampled"]["codes"], runs["m111"]["sampled"]["codes"]
    assert a.shape == (B, 3, MAX_NEW)
    assert torch.equal(a, b)
    system = VauraSystem(*runs["configs"], device="cpu")
    system.load_state_dicts(runs["sds"])
    one = system.generate(torch.from_numpy(runs["frames"]), **SAMPLED)
    assert torch.equal(one["codes"], a)


def test_checkpoints_cross_between_mesh_and_one_process(runs):
    got = runs["m222"]
    # the mesh's gathered state loads into one process, bit for bit
    tsys = port_train_system(runs["tree"])
    trainable, _ = split_params(tsys)
    state = TrainState.create(trainable, make_optimizer(**OPT))
    state.load_state_dict(got["state"])
    sd = state.state_dict()
    for k, v in got["state"]["params"].items():
        assert torch.equal(sd["params"][k].detach(), v), k
    for key in ("mu", "nu"):
        for k, v in got["state"]["opt_state"][key].items():
            assert torch.equal(sd["opt_state"][key][k], v), (key, k)
    # a one-process checkpoint into the mesh and gathered back
    want, back = runs["resume"], got["resumed"]
    assert back["step"] == want["step"]
    for k, v in want["params"].items():
        assert torch.equal(back["params"][k], v), k
    for key in ("mu", "nu"):
        for k, v in want["opt_state"][key].items():
            assert torch.equal(back["opt_state"][key][k], v), (key, k)


def test_two_processes_initialize_and_gate_on_the_main_one(tmp_path):
    results = wait(spawn("multihost", 2, {}, tmp_path))
    assert all("MULTIHOST-OK" in text for _, text in results)
    lines = (tmp_path / "main.txt").read_text().splitlines()
    assert lines == ["main from rank 0"]
