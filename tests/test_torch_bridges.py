"""The port's convolutional bridges against ``vaura_tpu.models.bridges``
(flax ``nn.Conv``: channels last inside, ``padding="SAME"``, tanh GELU),
as ``test_torch_system.py::test_mlp_bridge_matches_jax`` holds the MLP
bridge: the same weights, float32, within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import np_tree

from vaura_tpu.models import bridges as J
from vaura_tpu_torch.models import bridges as T


def _carry(p, spatial: int) -> dict:
    """flax ``kernel [*k, I, O]`` -> torch ``weight [O, I, *k]``."""
    k = p["conv"]["kernel"]
    perm = (spatial + 1, spatial) + tuple(range(spatial))
    return {"conv.weight": torch.from_numpy(np.ascontiguousarray(
                k.transpose(perm))),
            "conv.bias": torch.from_numpy(np.array(p["conv"]["bias"]))}


@pytest.mark.parametrize("kernel,stride", [
    ((1, 1, 1), (1, 1, 1)), ((3, 3, 3), (1, 2, 2)), ((2, 3, 1), (2, 1, 1)),
])
def test_conv_bridge_visual_matches_jax(kernel, stride):
    x = np.random.default_rng(1).standard_normal((2, 6, 5, 7, 8)).astype(
        np.float32)  # [B, C, T, H, W]
    jb = J.ConvBridgeVisual(6, 4, kernel, stride)
    p = np_tree(jb.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    tb = T.ConvBridgeVisual(6, 4, kernel, stride, device="cpu")
    tb.load_state_dict(_carry(p, 3))
    with torch.no_grad():
        got = tb(torch.from_numpy(x)).numpy()
    want = np.asarray(jb.apply({"params": p}, x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel,stride", [
    ((1, 1), (1, 1)), ((3, 3), (2, 2)), ((2, 4), (1, 3)),
])
def test_conv_bridge_2d_matches_jax(kernel, stride):
    x = np.random.default_rng(2).standard_normal((2, 6, 9, 10)).astype(
        np.float32)  # [B, C, H, W]
    jb = J.ConvBridge2D(6, 4, kernel, stride)
    p = np_tree(jb.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    tb = T.ConvBridge2D(6, 4, kernel, stride, device="cpu")
    tb.load_state_dict(_carry(p, 2))
    with torch.no_grad():
        got = tb(torch.from_numpy(x)).numpy()
    want = np.asarray(jb.apply({"params": p}, x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
