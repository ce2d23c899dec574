"""The port's MotionFormer in every block layout and aggregation setting
against ``vaura_tpu``'s, float32, the same weights carried over by
``convert.from_jax_params``, the same numpy-seeded frames: joint blocks with
the joint positional embedding, trajectory blocks with each
``approx_attn_type`` (orthoformer and performer given JAX's ``PRNGKey(0)``
draws in place of the port's own), average-pooled space, the temporal CLS
layer with the global one, average-pooled time and segments, unfactorised
output; then the trajectory encoder's input gradient under ``train=True``
against ``jax.grad``.

Tiny widths: D=32, 4 heads, f=2 frames of n=9 locations, 1-2 blocks.
Tolerance 1e-4 absolute/relative on features of unit scale (as
``test_torch_motionformer.py``); the gradient 1e-4 relative to its largest
entry."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import CPU, np_tree, port_encoder_config

from vaura_tpu.models.motionformer import MotionFormer as JMF
from vaura_tpu.models.motionformer import MotionFormerConfig as JCfg
from vaura_tpu.ops.trajectory_attention import _orthogonal_gaussian
from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.models import motionformer as TM

BASE = JCfg(
    img_size=24, patch_size=8, embed_dim=32, depth=2, num_heads=4,
    temporal_resolution=2, drop_path_rate=0.0, dtype=jnp.float32,
    fused_encoder_block=False, approx_attn_dim=4,
)
FRAMES = np.random.default_rng(0).standard_normal(
    (2, 2, 3, 4, 24, 24)).astype(np.float32)
TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_params(cfg, seed=1):
    """The JAX model and a seeded numpy parameter tree of its structure
    (``eval_shape``: no compilation of ``init``), every leaf random: dense
    and conv kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), biases
    and embeddings small."""
    jm = JMF(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.asarray(FRAMES[:1, :1]))["params"]
    rng = np.random.default_rng(seed)

    def fill(node, path):
        if hasattr(node, "items"):
            return {k: fill(v, path + (k,)) for k, v in node.items()}
        shape, leaf = node.shape, path[-1]
        a = rng.standard_normal(shape)
        if leaf == "kernel":
            fan_in = (np.prod(shape[:-1]) if path[0] == "patch_embed_3d"
                      else shape[-2])
            a = a / np.sqrt(fan_in)
        elif leaf == "scale":
            a = 1.0 + 0.1 * a
        else:
            a = (0.05 if leaf == "bias" else 0.02) * a
        return a.astype(np.float32)

    return jm, fill(shapes, ())


def _port(cfg, tree):
    tm = TM.MotionFormer(port_encoder_config(cfg), device=CPU)
    tm.load_state_dict(from_jax_params({"encoder": tree})["encoder"])
    return tm


def _jax_draws(monkeypatch, cfg):
    """Make the port's trajectory blocks take the JAX package's draws."""
    hd = cfg.embed_dim // cfg.num_heads

    def draws(self, BH, N, device):
        key = jax.random.PRNGKey(0)
        if cfg.approx_attn_type == "orthoformer":
            return {"first": torch.from_numpy(np.array(
                jax.random.randint(key, (BH,), 0, N)))}
        if cfg.approx_attn_type == "performer":
            return {"proj": torch.from_numpy(np.array(_orthogonal_gaussian(
                key, cfg.approx_attn_dim, hd)))}
        return {}

    monkeypatch.setattr(TM.TrajectoryBlock, "approx_draws", draws)


def _compare(cfg, monkeypatch=None):
    """Features (and global vector) of both packages on ``FRAMES``; returns
    the port's, with its model."""
    jm, tree = _jax_params(cfg)
    want_f, want_g = jax.jit(lambda p, f: jm.apply({"params": p}, f))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(FRAMES))
    tm = _port(cfg, tree)
    if monkeypatch is not None:
        _jax_draws(monkeypatch, cfg)
    with torch.no_grad():
        got_f, got_g = tm(torch.from_numpy(FRAMES), return_global=True)
    assert got_f.shape == want_f.shape
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), **TOL)
    assert (got_g is None) == (want_g is None)
    if want_g is not None:
        assert got_g.shape == want_g.shape
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)
    return got_f, got_g, tm


def test_joint_blocks_and_joint_embedding():
    cfg = dataclasses.replace(BASE, attn_layer="joint", pos_embed_type="joint")
    feats = _compare(cfg)[0]
    assert feats.shape == (2, 2, 2, 32)


@pytest.mark.parametrize("approx", ["none", "nystrom", "orthoformer",
                                    "performer"])
def test_trajectory_blocks(approx, monkeypatch):
    # 18 tokens over 4 landmarks: Nystrom's uneven segments
    cfg = dataclasses.replace(BASE, attn_layer="trajectory", depth=1,
                              approx_attn_type=approx)
    _compare(cfg, monkeypatch)


def test_trajectory_with_value_projection():
    cfg = dataclasses.replace(BASE, attn_layer="trajectory", depth=1,
                              use_original_code=False)
    _compare(cfg)


@pytest.mark.parametrize("kw,shape,global_shape", [
    (dict(agg_space_module="AveragePooling"), (2, 2, 2, 32), None),
    (dict(agg_time_module="TransformerEncoderLayer", add_global_repr=True),
     (2, 2, 32), (2, 32)),
    (dict(agg_time_module="AveragePooling", add_global_repr=True,
          agg_segments_module="AveragePooling"), (2, 2, 32), (2, 32)),
    (dict(factorize_space_time=False), (2, 2, 18, 32), None),
])
def test_aggregation_settings(kw, shape, global_shape):
    cfg = dataclasses.replace(BASE, **kw)
    feats, glob, tm = _compare(cfg)
    assert feats.shape == shape
    assert (None if glob is None else tuple(glob.shape)) == global_shape
    # the default return is the features alone
    with torch.no_grad():
        assert torch.equal(tm(torch.from_numpy(FRAMES)), feats)


def test_spec_builds_every_variant():
    """``MotionFormerSpec`` from the reference wrapper's keys gives the same
    configuration in both packages."""
    from vaura_tpu.models.motionformer import MotionFormerSpec as JS

    for kw in (dict(attn_layer="trajectory", approx_attn_type="performer",
                    use_original_code=False),
               dict(attn_layer="joint", pos_embed_type="joint"),
               dict(agg_time_module="TransformerEncoderLayer",
                    add_global_repr=True, max_segments=8),
               dict(agg_space_module="AveragePooling",
                    agg_time_module="AveragePooling", add_global_repr=True,
                    agg_segments_module="AveragePooling"),
               dict(factorize_space_time=False, quantize=True)):
        j, t = JS(**kw), TM.MotionFormerSpec(**kw)
        for f in dataclasses.fields(t):
            if not f.name.endswith("dtype"):
                assert getattr(t, f.name) == getattr(j, f.name), (kw, f.name)


def test_trajectory_input_gradient():
    """Two Nystrom trajectory blocks under ``train=True`` (every rate 0):
    the features and the gradient of their weighted sum to the frames."""
    cfg = dataclasses.replace(BASE, attn_layer="trajectory",
                              approx_attn_type="nystrom")
    jm, tree = _jax_params(cfg)
    w = np.random.default_rng(5).standard_normal((2, 2, 2, 32)).astype(
        np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, tree)

    def fwd_grad(f):
        out, vjp = jax.vjp(
            lambda x: jm.apply({"params": params}, x, train=True)[0], f)
        return out, vjp(jnp.asarray(w))[0]

    want_f, want = map(np.asarray, jax.jit(fwd_grad)(jnp.asarray(FRAMES)))
    tm = _port(cfg, tree)
    frames = torch.from_numpy(FRAMES).requires_grad_(True)
    feats = tm(frames, train=True)
    np.testing.assert_allclose(feats.detach().numpy(), want_f, **TOL)
    (feats * torch.from_numpy(w)).sum().backward()
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(frames.grad.numpy(), want, rtol=1e-4,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("params", [
    {"attn_layer": "trajectory", "approx_attn_type": "nystrom",
     "approx_attn_dim": 8},
    {"attn_layer": "joint", "pos_embed_type": "joint", "quantize": True,
     "agg_time_module": "torch.nn.Identity"},
])
def test_build_system_with_a_variant_encoder(params):
    """``build_system`` from ``configs/experiments/dummy.yaml`` with the
    encoder's settings replaced: the same encoder configuration as the JAX
    package's factory, and a port encoder with that layout."""
    import copy
    from pathlib import Path

    from vaura_tpu.models.factory import build_system as j_build
    from vaura_tpu_torch.config import load_config
    from vaura_tpu_torch.models.factory import build_system as t_build

    repo = Path(__file__).resolve().parents[1]
    cfg = load_config(repo / "configs/experiments/dummy.yaml", repo)["model"]
    cfg["feature_extractor_config"]["params"].update(params)
    jc = j_build(copy.deepcopy(cfg)).encoder_config
    tc = t_build(copy.deepcopy(cfg), device=CPU).encoder.cfg
    for f in dataclasses.fields(tc):
        if not f.name.endswith("dtype"):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.attn_layer == params["attn_layer"]
