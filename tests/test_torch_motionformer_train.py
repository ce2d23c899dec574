"""The port's MotionFormer in its unfused, differentiable form
(``train=True``: the grouped-attention op on both axes) against
``vaura_tpu``'s with ``train=True`` through its Pallas grouped attention in
interpret mode, float32, all stochastic rates 0; then stochastic depth and
dropout on their own.

Tolerance 1e-4 on the features (as ``test_torch_motionformer.py``); the
gradient of a scalar of the features, for every encoder leaf, rtol 1e-4 and
atol 1e-5 of the leaf's largest gradient."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import CPU, np_tree, port_encoder_config

from vaura_tpu.models.motionformer import MotionFormer as JMF
from vaura_tpu.models.motionformer import MotionFormerConfig as JCfg
from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.models.motionformer import MotionFormer as TMF
from vaura_tpu_torch.models.motionformer import MotionFormerConfig as TCfg

J_CFG = JCfg(
    img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
    temporal_resolution=2, drop_path_rate=0.0, dtype=jnp.float32,
    fused_divided_attention=True, fused_encoder_block=False,
)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((2, 2, 3, 4, 32, 32)).astype(np.float32)
    jm = JMF(J_CFG)
    params = jax.jit(lambda r: jm.init(r, jnp.asarray(frames[:1, :1])))(
        jax.random.PRNGKey(1))["params"]
    tree = np_tree(params)
    tree["temp_embed"] = rng.standard_normal(tree["temp_embed"].shape).astype(
        np.float32) * 0.02

    def fill_biases(node):  # zero-initialised: give every leaf a gradient path
        for k, v in node.items():
            if hasattr(v, "items"):
                fill_biases(v)
            elif k == "bias":
                node[k] = (0.05 * rng.standard_normal(v.shape)).astype(np.float32)

    fill_biases(tree)
    tm = TMF(port_encoder_config(J_CFG), device=CPU)
    tm.load_state_dict(from_jax_params({"encoder": tree})["encoder"])
    return jm, jax.tree_util.tree_map(jnp.asarray, tree), tm, frames


def test_unfused_features_match_jax_train_mode(models):
    jm, jp, tm, frames = models
    want, _ = jax.jit(lambda p, f: jm.apply(
        {"params": p}, f, train=True, rngs={"dropout": jax.random.PRNGKey(0)})
    )(jp, jnp.asarray(frames))
    got = tm(torch.from_numpy(frames), train=True)
    assert got.requires_grad and got.shape == (2, 2, 2, 32) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    # the fused-sublayer form (inference) computes the same function
    with torch.no_grad():
        fused = tm(torch.from_numpy(frames))
    np.testing.assert_allclose(fused.numpy(), got.detach().numpy(), rtol=1e-4,
                               atol=1e-4)


def test_gradients_of_every_encoder_leaf_match_jax(models):
    jm, jp, tm, frames = models
    w = np.random.default_rng(5).standard_normal((2, 2, 2, 32)).astype(np.float32)

    def scalar(p):
        feats, _ = jm.apply({"params": p}, jnp.asarray(frames), train=True,
                            rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(feats * w)

    want = from_jax_params({"encoder": np_tree(jax.jit(jax.grad(scalar))(jp))}
                           )["encoder"]
    tm.zero_grad()
    (tm(torch.from_numpy(frames), train=True) * torch.from_numpy(w)).sum().backward()
    named = dict(tm.named_parameters())
    assert set(named) == set(want)
    for k, p in named.items():
        g = want[k].numpy()
        scale = float(np.abs(g).max())
        # the CLS token's own block outputs never reach the features (only
        # its keys and values do): every other leaf has a gradient
        assert scale > 0 or "blocks.1" in k, k
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-7 + 1e-5 * scale, err_msg=k)


def test_fused_switches():
    # the einsum path is only the op's plain version here: no such switch
    with pytest.raises(TypeError, match="fused_divided_attention"):
        TCfg(fused_divided_attention=False)
    cfg = port_encoder_config(J_CFG, fused_encoder_block=False)
    tm = TMF(cfg, device=CPU)
    from vaura_tpu_torch.utils import seeded_init_
    seeded_init_(tm, torch.Generator().manual_seed(0))
    frames = torch.randn(1, 1, 3, 4, 32, 32, generator=torch.Generator().manual_seed(1))
    both = TMF(dataclasses.replace(cfg, fused_encoder_block=None), device=CPU)
    both.load_state_dict(tm.state_dict())
    with torch.no_grad():  # unfused for inference too vs fused sublayers
        torch.testing.assert_close(tm(frames), both(frames), rtol=1e-4,
                                   atol=1e-4)


def test_stochastic_depth_and_dropout(models):
    _, _, tm0, frames = models
    cfg = dataclasses.replace(tm0.cfg, drop_path_rate=0.5, drop_rate=0.1)
    tm = TMF(cfg, device=CPU)
    tm.load_state_dict(tm0.state_dict())
    x = torch.from_numpy(np.concatenate([frames] * 4))  # 8 clips x 2 segments
    g = lambda s: torch.Generator().manual_seed(s)
    with torch.no_grad():
        a, b, c = tm(x, True, g(0)), tm(x, True, g(0)), tm(x, True, g(1))
        det = tm(x, False)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.allclose(a, det, atol=1e-3)
    assert torch.equal(det, tm(x, False, g(3)).detach())  # no mask drawn
    # stochastic depth alone: block 0 has rate 0 (linspace), block 1 rate
    # 0.5, drawn once per (clip, segment) row for each of its two branches:
    # whatever the seed, a row comes out in one of at most 4 ways
    only_dp = TMF(dataclasses.replace(cfg, drop_rate=0.0), device=CPU)
    only_dp.load_state_dict(tm0.state_dict())
    with torch.no_grad():
        outs = torch.stack([only_dp(x, True, g(s)) for s in range(6)])
    outs = outs.reshape(6 * 4, 2 * 2, -1)  # [seed x repeat, distinct row, :]
    for row in range(4):
        ways = {tuple(np.round(o.numpy(), 4)) for o in outs[:, row]}
        assert 2 <= len(ways) <= 4, (row, len(ways))
