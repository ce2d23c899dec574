"""The training slice as a whole: the port's ``train_forward``,
``train_step`` and ``eval_step`` against ``vaura_tpu``'s on the tiny float32
training configuration of ``torch_port_util`` (every stochastic rate 0, the
JAX encoder through its Pallas grouped attention in interpret mode), audio
through the DAC encoder. Parameters, gradients and updated parameters of
the JAX package pass through ``convert.from_jax_params``.

Tolerances: loss 1e-5 absolute (float32 on both sides, sums in another
order); gradients rtol 1e-4, atol 1e-6 plus 1e-5 of the leaf's largest
gradient; the loss sequence of three steps 1e-4; every updated parameter
rtol 1e-4 / atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (
    flat_state_dicts,
    init_jax_train_system,
    jax_train_state,
    np_tree,
    port_train_system,
    train_batch,
)

from vaura_tpu.ops.schedules import warmup_to_static_schedule as j_warmup
from vaura_tpu.train.steps import make_eval_step as j_make_eval_step
from vaura_tpu.train.steps import make_train_step as j_make_train_step
from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.ops.schedules import warmup_to_static_schedule as t_warmup
from vaura_tpu_torch.train.state import (
    TrainState,
    build_schedule,
    decay_mask,
    make_optimizer,
    param_labels,
    trainable_mask,
)
from vaura_tpu_torch.train.steps import (
    array_batch,
    batch_to_device,
    make_eval_step,
    make_train_step,
    split_params,
)

RNG = jax.random.PRNGKey(0)


@pytest.fixture(scope="module")
def setup():
    jsys, tree = init_jax_train_system(0)
    return jsys, tree, train_batch(0)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_train_forward_loss_from_audio_and_from_codes(setup):
    jsys, tree, batch = setup
    tsys = port_train_system(tree)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jb, tb = _jb(batch), _tb(batch)
    want, waux = jax.jit(lambda p, f, a: jsys.train_forward(
        p, f, a, RNG, train=True))(jp, jb["frames"], jb["audio"])
    got, gaux = tsys.train_forward(tb["frames"], tb["audio"], None, train=True)
    codes = np.asarray(waux["targets"])
    np.testing.assert_array_equal(gaux["targets"].numpy(), codes)
    np.testing.assert_array_equal(gaux["mask"].numpy(), np.asarray(waux["mask"]))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gaux["loss_per_codebook"].detach().numpy(),
                               np.asarray(waux["loss_per_codebook"]),
                               rtol=0, atol=1e-5)
    # NaN at exactly the slots no sequence step predicts, on both sides
    nan = torch.isnan(gaux["logits"]).all(-1).numpy()
    np.testing.assert_array_equal(nan, ~np.asarray(waux["mask"]))
    # the codes= bypass: no audio, same loss
    got2, _ = tsys.train_forward(tb["frames"], None, None, train=True,
                                 codes=torch.from_numpy(codes.copy()))
    want2, _ = jax.jit(lambda p, f, c: jsys.train_forward(
        p, f, None, RNG, train=True, codes=c))(jp, jb["frames"],
                                               jnp.asarray(codes))
    np.testing.assert_allclose(float(got2.detach()), float(want2), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got2.detach()), float(got.detach()), rtol=0, atol=1e-6)


def test_clip_partitioned_audio_folds_into_the_batch(setup):
    """Audio ``[B, n_clips, 1, T]`` with frames ``[B, n_clips, ...]``."""
    jsys, tree, batch = setup
    tsys = port_train_system(tree)
    T = batch["audio"].shape[-1] // 2
    audio4 = batch["audio"].reshape(2, 1, 2, T).transpose(0, 2, 1, 3).copy()
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    want, _ = jax.jit(lambda p, f, a: jsys.train_forward(
        p, f, a, RNG, train=True))(jp, jnp.asarray(batch["frames"]),
                                   jnp.asarray(audio4))
    got, aux = tsys.train_forward(torch.from_numpy(batch["frames"]),
                                  torch.from_numpy(audio4), None, train=True)
    assert aux["targets"].shape[0] == 4
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("freeze", [False, True], ids=["unfrozen", "frozen"])
def test_gradients_of_every_trainable_leaf(freeze):
    jsys, tree = init_jax_train_system(1, freeze_feature_extractor=freeze)
    tsys = port_train_system(tree, freeze_feature_extractor=freeze)
    batch = train_batch(1)
    jstate, jfrozen = jax_train_state(jsys, tree, 1e-3)
    jb = _jb(batch)

    def loss_fn(trainable):
        return jsys.train_forward({**jfrozen, **trainable}, jb["frames"],
                                  jb["audio"], RNG, train=True)[0]

    want = flat_state_dicts(from_jax_params(np_tree(
        jax.jit(jax.grad(loss_fn))(jstate.params))))
    trainable, frozen = split_params(tsys)
    assert set(want) == set(trainable)
    assert any(k.startswith("encoder.") for k in frozen) == freeze
    assert all(k.startswith(("dac.", "encoder.")) for k in frozen)
    tb = _tb(batch)
    loss, _ = tsys.train_forward(tb["frames"], tb["audio"], None, train=True)
    names = list(trainable)
    grads = torch.autograd.grad(loss, [trainable[k] for k in names],
                                allow_unused=True)
    n_nonzero = 0
    for k, g in zip(names, grads):
        w = want[k].numpy()
        if g is None:  # not reached (token_drop is off): JAX says zero
            assert k.endswith("uncond_embedding") and not w.any(), k
            continue
        scale = float(np.abs(w).max())
        n_nonzero += scale > 1e-8
        assert np.isfinite(g.numpy()).all(), k
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-6 + 1e-5 * scale, err_msg=k)
    assert n_nonzero > 0.9 * len(names)


def _run_steps(setup, n_calls, **opt_kw):
    jsys, tree, batch = setup
    tsys = port_train_system(tree)
    before = {k: v.detach().clone() for k, v in tsys.named_parameters()}
    jstate, jfrozen = jax_train_state(jsys, tree, j_warmup(1e-3, 10), **opt_kw)
    trainable, _ = split_params(tsys)
    tstate = TrainState.create(trainable,
                               make_optimizer(t_warmup(1e-3, 10), **opt_kw))
    jstep, tstep = j_make_train_step(jsys, donate=False), make_train_step(tsys)
    batches = [train_batch(s) for s in range(2)]
    jl, tl = [], []
    for i in range(n_calls):
        b = batches[i % 2]
        jstate, jm = jstep(jstate, jfrozen, _jb(b), RNG)
        tstate, tm = tstep(tstate, _tb(b))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        np.testing.assert_allclose(tm["loss_per_codebook"].numpy(),
                                   np.asarray(jm["loss_per_codebook"]),
                                   rtol=0, atol=1e-4)
    return jsys, tsys, before, jstate, jfrozen, tstate, jl, tl


@pytest.mark.parametrize("accumulate", [1, 2], ids=["every_call", "accumulate2"])
def test_three_train_steps_match_jax(setup, accumulate):
    """Warmup schedule, weight decay 0.01, value clipping at 1.0; with
    ``accumulate_grad_batches=2`` six calls make three updates."""
    n_calls = 3 * accumulate
    jsys, tsys, before, jstate, jfrozen, tstate, jl, tl = _run_steps(
        setup, n_calls, weight_decay=0.01, gradient_clip_val=1.0,
        gradient_clip_algorithm="value", accumulate_grad_batches=accumulate)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    assert tstate.step == n_calls == int(jstate.step)
    assert tstate.opt_state.count == 3
    want = flat_state_dicts(from_jax_params(np_tree(jstate.params)))
    assert set(want) == set(tstate.params)
    after = dict(tsys.named_parameters())
    for k, w in want.items():
        np.testing.assert_allclose(after[k].detach().numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
        changed = not torch.equal(after[k].detach(), before[k])
        # the frozen null condition never moves; empty_video_emb (rank 1, no
        # decay) has no gradient here: no position lies past the last frame
        assert changed == (not k.endswith(("uncond_embedding",
                                           "empty_video_emb"))), k
    for k, v in after.items():  # the codec is never touched
        if k.startswith("dac."):
            assert torch.equal(v.detach(), before[k]), k
    # the eval step on the updated parameters
    b = train_batch(5)
    jm = j_make_eval_step(jsys)(jstate.params, jfrozen, _jb(b), RNG)
    tm = make_eval_step(tsys)(_tb(b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=0,
                               atol=1e-4)
    assert not tm["loss"].requires_grad


def test_global_norm_clipping_matches_jax(setup):
    *_, jstate, _, tstate, jl, tl = _run_steps(
        setup, 2, weight_decay=0.0, gradient_clip_val=0.05,
        gradient_clip_algorithm="norm")
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    want = flat_state_dicts(from_jax_params(np_tree(jstate.params)))
    for k, w in want.items():
        np.testing.assert_allclose(tstate.params[k].detach().numpy(),
                                   w.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def test_stacked_rank_decay_quirk(setup):
    """The JAX package labels leaves on its layer-stacked trees, so a
    block's norm weight or bias (rank 1 per layer, rank 2 stacked) IS
    decayed, while the final norm (never stacked) is not. With a weight
    decay large enough to show, the port must follow."""
    jsys, tree, batch = setup
    tsys = port_train_system(tree)
    labels = param_labels(dict(tsys.named_parameters()))
    assert labels["sampler.layers.0.attention_norm.weight"] == "decay"
    assert labels["encoder.blocks.1.norm1.bias"] == "decay"
    assert labels["encoder.blocks.0.mlp.fc1.bias"] == "decay"
    assert labels["sampler.norm.weight"] == "nodecay"
    assert labels["encoder.norm.scale"] == "nodecay"
    assert labels["sampler.empty_video_emb"] == "nodecay"
    assert labels["sampler.cls_embeddings.uncond_embedding"] == "frozen"
    assert labels["sampler.lm_head.weight"] == "decay"
    masks = decay_mask(dict(tsys.named_parameters()))
    assert masks["sampler.layers.1.ffn_norm.weight"] and not masks[
        "sampler.norm.weight"]
    assert not trainable_mask(dict(tsys.named_parameters()))[
        "sampler.cls_embeddings.uncond_embedding"]

    opt_kw = dict(weight_decay=0.5, gradient_clip_val=1.0)
    jstate, jfrozen = jax_train_state(jsys, tree, 1e-2, **opt_kw)
    trainable, _ = split_params(tsys)
    tstate = TrainState.create(trainable, make_optimizer(1e-2, **opt_kw))
    jstep, tstep = j_make_train_step(jsys, donate=False), make_train_step(tsys)
    for _ in range(3):
        jstate, _ = jstep(jstate, jfrozen, _jb(batch), RNG)
        tstate, _ = tstep(tstate, _tb(batch))
    want = flat_state_dicts(from_jax_params(np_tree(jstate.params)))
    key = "sampler.layers.0.attention_norm.weight"
    got = tstate.params[key].detach().numpy()
    np.testing.assert_allclose(got, want[key].numpy(), rtol=1e-4, atol=1e-6)
    # decay alone moves a weight of 1 by about 3 * 1e-2 * 0.5; Adam's own
    # steps of +-1e-2 each cannot bring the MEAN over the row to that
    assert got.mean() < 1.0 - 0.01


def test_optimizer_options_and_batches():
    with pytest.raises(NotImplementedError):
        make_optimizer(1e-3, mu_dtype="bfloat16")
    with pytest.raises(NotImplementedError):
        make_optimizer(1e-3, nu_dtype="bfloat16")
    with pytest.raises(ValueError):
        make_optimizer(1e-3, gradient_clip_algorithm="sign")
    sched = build_schedule(
        {"target": "vaura_tpu.ops.schedules.WarmUpToStaticLRScheduler",
         "params": {"warmup_steps": 4}}, 2e-3)
    assert sched(0) == pytest.approx(5e-4) and sched(10) == 2e-3
    assert build_schedule(None, 3e-4) == 3e-4
    with pytest.raises(ValueError):
        build_schedule({"target": "x.StepLR"}, 1e-3)
    batch = {"frames": np.zeros((1, 2), np.float32), "meta": ["a"],
             "nested": {"audio": np.ones(3, np.float32), "name": "n"},
             "codes": torch.zeros(2, dtype=torch.long)}
    moved = batch_to_device(batch, "cpu")
    assert isinstance(moved["frames"], torch.Tensor)
    assert isinstance(moved["nested"]["audio"], torch.Tensor)
    assert moved["meta"] == ["a"] and moved["nested"]["name"] == "n"
    assert set(array_batch(moved)) == {"frames", "codes"}


def test_load_dac_embeddings_into_sampler_matches_jax(setup):
    jsys, tree, _ = setup
    tsys = port_train_system(tree)
    want = jsys.load_dac_embeddings_into_sampler(
        jax.tree_util.tree_map(jnp.asarray, tree))["sampler"]["tok_embeddings"]
    assert tsys.load_dac_embeddings_into_sampler()
    tok = tsys.sampler.tok_embeddings
    for name in ("emb", "proj_v", "proj_g", "proj_b"):
        np.testing.assert_allclose(getattr(tok, name).detach().numpy(),
                                   np.asarray(want[name]), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    # the folded projection reproduces the DAC's out-projection
    q = tsys.dac.quantizer
    W = tok.proj_g * tok.proj_v / tok.proj_v.norm(dim=-1, keepdim=True)
    torch.testing.assert_close(W.transpose(1, 2), q.out_proj_w[:3].detach(),
                               rtol=1e-5, atol=1e-6)
