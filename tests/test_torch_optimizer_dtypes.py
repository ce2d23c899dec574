"""Reduced-precision Adam moments of the port (``train/state.py``:
``make_optimizer(mu_dtype=, nu_dtype=)``) against the JAX package's two
paths: optax's ``scale_by_adam`` with ``mu_dtype`` alone, and the package's
``_scale_by_adam_dtypes`` with ``nu_dtype`` set. Three AdamW steps on
seeded parameters of rank 1 and 2 (decayed and not), with the gradients of
each step made with numpy and handed to both.

Tolerances: the stored moments within one bf16 ulp of their magnitude (a
float32 sum in another order may round to the neighbouring bf16 value);
the parameters within 1e-6 absolute (the updates are about 1e-2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaura_tpu.train.state import TrainState as JState
from vaura_tpu.train.state import make_optimizer as j_make_optimizer
from vaura_tpu_torch.train.state import TrainState, make_optimizer

LR, WD = 1e-2, 0.1
SHAPES = {"w": (16, 8), "b": (8,)}
PATHS = {"mu": dict(mu_dtype="bfloat16"),
         "mu_nu": dict(mu_dtype="bfloat16", nu_dtype="bfloat16"),
         "nu": dict(nu_dtype="bfloat16")}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _adam_state(opt_state):
    """The first ScaleByAdamState of each label's branch (decay, nodecay)."""
    out = []

    def visit(node):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            out.append(node)
            return
        if isinstance(node, (tuple, list)):
            for c in node:
                visit(c)
        elif isinstance(node, dict):
            for c in node.values():
                visit(c)
        elif hasattr(node, "inner_states"):
            visit(node.inner_states)
        elif hasattr(node, "inner_state"):
            visit(node.inner_state)

    visit(opt_state)
    return out


def _moments(opt_state):
    """``{"mu": {name: array}, "nu": {...}}`` over the JAX branches (each
    branch holds the leaves of its label; the others are masked)."""
    got = {"mu": {}, "nu": {}}
    for st in _adam_state(opt_state):
        for key in ("mu", "nu"):
            for name, leaf in getattr(st, key).items():
                if hasattr(leaf, "dtype"):
                    got[key][name] = np.asarray(leaf.astype(jnp.float32)), leaf.dtype
    return got


def _bf16_ulp(x):
    """One bf16 ulp at each element's magnitude (2^-7 relative)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_moments_and_parameters_match_jax(path):
    kw = dict(weight_decay=WD, gradient_clip_val=None, **PATHS[path])
    params = _tree(0)
    jstate = JState.create({k: jnp.asarray(v) for k, v in params.items()},
                           j_make_optimizer(LR, **kw))
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    tstate = TrainState.create(tparams, make_optimizer(LR, **kw))
    want_mu = torch.bfloat16 if "mu_dtype" in kw else torch.float32
    want_nu = torch.bfloat16 if "nu_dtype" in kw else torch.float32
    assert {v.dtype for v in tstate.opt_state.mu.values()} == {want_mu}
    assert {v.dtype for v in tstate.opt_state.nu.values()} == {want_nu}
    for step in range(3):
        grads = _tree(10 + step, scale=0.05)
        jstate = jstate.apply_gradients({k: jnp.asarray(v)
                                         for k, v in grads.items()})
        tstate = tstate.apply_gradients({k: torch.tensor(v)
                                         for k, v in grads.items()})
        jm = _moments(jstate.opt_state)
        for key in ("mu", "nu"):
            for name in SHAPES:
                want, jdtype = jm[key][name]
                got = getattr(tstate.opt_state, key)[name]
                assert str(got.dtype).split(".")[-1] == str(jdtype), (key, name)
                got = got.float().numpy()
                np.testing.assert_array_less(
                    np.abs(got - want), _bf16_ulp(want) * 1.0001 + 1e-30,
                    err_msg=f"{path} step {step} {key}.{name}")
        for name in SHAPES:
            np.testing.assert_allclose(
                tstate.params[name].numpy(), np.asarray(jstate.params[name]),
                rtol=0, atol=1e-6, err_msg=f"{path} step {step} {name}")


def test_bf16_first_moment_follows_optax_rounding():
    """optax takes ``b1 * mu`` in bf16 (b1 rounded to bf16 first): the port
    does the same, and a float32 product would land elsewhere."""
    tx = make_optimizer(LR, gradient_clip_val=None, mu_dtype="bfloat16")
    params = {"w": torch.zeros(64, 64)}
    state = TrainState.create(params, tx)
    mu = torch.linspace(-1, 1, 64 * 64).reshape(64, 64).to(torch.bfloat16)
    state.opt_state.mu["w"].copy_(mu)
    g = torch.full((64, 64), 1e-3)
    out = tx._mu_reduced([g], [state.opt_state.mu["w"]])[0]
    b1 = torch.tensor(0.9, dtype=torch.bfloat16)
    want = (mu * b1).float() + g * (1 - 0.9)
    assert torch.equal(out, want)
    jwant = np.asarray(0.9 * jnp.asarray(mu.float().numpy(), jnp.bfloat16)
                       ).astype(np.float32) + np.float32(1 - 0.9) * 1e-3
    np.testing.assert_array_equal(out.numpy(), jwant)
    assert not torch.equal((mu.float() * 0.9).to(torch.bfloat16).float(),
                           (mu * b1).float())
