"""The small training ops of the port against ``vaura_tpu``'s: the masked
per-codebook cross entropy, ``revert_pattern_logits`` with its NaN fill, the
condition-dropout helpers and the learning-rate schedules. Inputs are made
with numpy from a seed; float32.

Tolerances: loss 1e-6 (one log-softmax and a mean); reverted logits exact
(a gather); schedules 1e-6 relative (the JAX package evaluates them in
float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaura_tpu.ops import dropout as j_dropout
from vaura_tpu.ops import schedules as j_sched
from vaura_tpu.ops.losses import masked_codebook_cross_entropy as j_loss
from vaura_tpu.ops.patterns import DelayedPatternProvider as JProvider
from vaura_tpu_torch.ops import dropout as t_dropout
from vaura_tpu_torch.ops import schedules as t_sched
from vaura_tpu_torch.ops.losses import masked_codebook_cross_entropy as t_loss
from vaura_tpu_torch.ops.patterns import DelayedPatternProvider as TProvider


def _loss_inputs(seed=0, B=2, K=3, T=7, card=11):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, K, T, card)).astype(np.float32) * 3
    targets = rng.integers(0, card, (B, K, T))
    mask = rng.random((B, K, T)) < 0.7
    mask[:, 2] = False  # a codebook with no valid position: count clamps to 1
    logits[~mask] = np.nan
    return logits, targets, mask


def test_masked_cross_entropy_matches_jax_with_nan_fill():
    logits, targets, mask = _loss_inputs()
    want, want_cb = j_loss(jnp.asarray(logits), jnp.asarray(targets),
                           jnp.asarray(mask))
    tl = torch.from_numpy(logits).requires_grad_(True)
    got, got_cb = t_loss(tl, torch.from_numpy(targets), torch.from_numpy(mask))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got_cb.detach().numpy(), np.asarray(want_cb),
                               rtol=0, atol=1e-6)
    assert float(got_cb[2].detach()) == 0.0
    # gradients: finite everywhere (zero at the NaN slots), equal to JAX's
    got.backward()
    g = tl.grad.numpy()
    assert np.isfinite(g).all() and not g[~mask].any()
    jg = jax.grad(lambda l: j_loss(l, jnp.asarray(targets),
                                   jnp.asarray(mask))[0])(jnp.asarray(logits))
    np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-5, atol=1e-7)


def test_masked_cross_entropy_rejects_wrong_shapes():
    logits, targets, mask = _loss_inputs()
    with pytest.raises(ValueError):
        t_loss(torch.from_numpy(logits), torch.from_numpy(targets[:, :2]),
               torch.from_numpy(mask))


@pytest.mark.parametrize("K,T,keep_valid", [(3, 6, False), (4, 9, False),
                                           (3, 6, True)])
def test_revert_pattern_logits_matches_jax(K, T, keep_valid):
    rng = np.random.default_rng(K * T)
    jpat, tpat = JProvider(K).get_pattern(T), TProvider(K).get_pattern(T)
    codes = rng.integers(0, 5, (2, K, T - 1))
    jseq, _, jm = jpat.build_pattern_sequence(jnp.asarray(codes), 99, keep_valid)
    tseq, _, tm = tpat.build_pattern_sequence(torch.from_numpy(codes), 99,
                                              keep_valid)
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
    np.testing.assert_array_equal(tm, np.asarray(jm))
    S, card = tseq.shape[-1], 5
    logits = rng.standard_normal((2, card, K, S)).astype(np.float32)
    want, widx, wmask = jpat.revert_pattern_logits(jnp.asarray(logits),
                                                   float("nan"), keep_valid)
    got, gidx, gmask = tpat.revert_pattern_logits(torch.from_numpy(logits),
                                                  float("nan"), keep_valid)
    assert got.shape == (2, card, K, T)
    np.testing.assert_array_equal(gidx, np.asarray(widx))
    np.testing.assert_array_equal(gmask, np.asarray(wmask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # NaN == NaN
    np.testing.assert_array_equal(np.isnan(got.numpy()).all(axis=(0, 1)),
                                  ~gmask)
    assert tpat.max_delay == jpat.max_delay
    assert len(tpat.valid_layout) == len(jpat.valid_layout)


def test_nullify_and_cfg_dropout_helpers():
    x = np.random.default_rng(0).standard_normal((3, 5, 4)).astype(np.float32)
    for dim in (1, 2):
        np.testing.assert_array_equal(
            t_dropout.nullify_condition(torch.from_numpy(x), dim).numpy(),
            np.asarray(j_dropout.nullify_condition(jnp.asarray(x), dim)))
    with pytest.raises(ValueError):
        t_dropout.nullify_condition(torch.from_numpy(x), 0)
    tx = torch.from_numpy(x)
    for p, train in ((0.0, True), (0.7, False)):
        out, dropped = t_dropout.classifier_free_guidance_dropout(tx, p, train)
        assert out is tx and not bool(dropped)
        jout, jdropped = j_dropout.classifier_free_guidance_dropout(
            jax.random.PRNGKey(0), jnp.asarray(x), p, train)
        assert not bool(jdropped)
        np.testing.assert_array_equal(np.asarray(jout), x)
    g = torch.Generator().manual_seed(0)
    flags = []
    for _ in range(400):
        out, dropped = t_dropout.classifier_free_guidance_dropout(
            tx, 0.3, True, g)
        flags.append(bool(dropped))
        assert torch.equal(out, torch.zeros_like(tx) if dropped else tx)
    assert 0.22 < np.mean(flags) < 0.38  # p = 0.3, 400 draws (sd 0.023)
    out1, _ = t_dropout.classifier_free_guidance_dropout(
        tx, 1.0, True, torch.Generator().manual_seed(1))
    jout1, jd1 = j_dropout.classifier_free_guidance_dropout(
        jax.random.PRNGKey(0), jnp.asarray(x), 1.0, True)
    assert bool(jd1)
    np.testing.assert_array_equal(out1.numpy(), np.asarray(jout1))


STEPS = [0, 1, 2, 9, 10, 11, 99, 100, 101, 1000, 5000, 5001, 20000]


@pytest.mark.parametrize("name,kw", [
    ("inverse_sqrt_schedule", dict(warmup_steps=100, warmup_init_lr=1e-6)),
    ("inverse_sqrt_schedule", dict(warmup_steps=10)),
    ("warmup_to_static_schedule", dict(warmup_steps=100, warmup_init_lr=0.0)),
    ("cosine_schedule", dict(total_steps=5000, warmup_steps=100,
                             lr_min_ratio=0.1)),
    ("cosine_schedule", dict(total_steps=1000, warmup_steps=0,
                             cycle_length=2.0)),
])
def test_schedules_match_jax(name, kw):
    js = getattr(j_sched, name)(3e-4, **kw)
    ts = getattr(t_sched, name)(3e-4, **kw)
    want = np.array([float(js(s)) for s in STEPS])
    got = np.array([ts(s) for s in STEPS])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("cls,params", [
    ("InverseSquareRootLRScheduler", dict(warmup_steps=50, warmup_init_lr=1e-7)),
    ("WarmUpToStaticLRScheduler", dict(warmup_steps=50)),
    ("CosineLRScheduler", dict(total_steps=400, warmup_steps=50,
                               lr_min_ratio=0.05)),
])
def test_scheduler_specs_match_jax(cls, params):
    jspec = getattr(j_sched, cls)(**params, ignored_key=1)
    tspec = getattr(t_sched, cls)(**params, ignored_key=1)
    with pytest.raises(TypeError):
        tspec(3)
    js, ts = jspec.build(1e-3), tspec.build(1e-3)
    for s in (0, 1, 49, 50, 51, 399, 400, 401):
        assert ts(s) == pytest.approx(float(js(s)), rel=1e-6, abs=1e-12)
