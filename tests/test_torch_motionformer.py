"""The port's MotionFormer (fused-sublayer form; plain versions on the CPU)
against ``vaura_tpu``'s MotionFormer on its einsum path
(``fused_encoder_block=False``: the same function as the fused path, and
fast on the CPU), float32, same weights carried over by
``convert.from_jax_params``.

Tolerance 1e-4 absolute/relative on features of unit scale: float32 on both
sides through two blocks and the aggregation layer; the fused form groups
the sums differently (per-pack CLS partials, per-group softmax) and flax's
LayerNorm computes its variance its own way."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_port_util import CPU, np_tree, port_encoder_config

from vaura_tpu.models.motionformer import MotionFormer as JMF
from vaura_tpu.models.motionformer import MotionFormerConfig as JCfg
from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.models.motionformer import MotionFormer as TMF

J_CFG = JCfg(
    img_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=4,
    temporal_resolution=2, drop_path_rate=0.0, dtype=jnp.float32,
    fused_encoder_block=False,
)


def test_features_match_jax():
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((2, 3, 3, 4, 32, 32)).astype(np.float32)
    jm = JMF(J_CFG)
    params = jax.jit(lambda r: jm.init(r, jnp.asarray(frames[:1, :1])))(
        jax.random.PRNGKey(1))["params"]
    tree = np_tree(params)
    # temp_embed starts at zero: give it values so the layout is exercised
    tree["temp_embed"] = rng.standard_normal(tree["temp_embed"].shape).astype(
        np.float32) * 0.02
    want, _ = jax.jit(lambda p, f: jm.apply({"params": p}, f))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(frames))

    tm = TMF(port_encoder_config(J_CFG), device=CPU)
    tm.load_state_dict(from_jax_params({"encoder": tree})["encoder"])
    with torch.no_grad():  # forward records a graph unless told not to
        got = tm(torch.from_numpy(frames))
    assert got.shape == (2, 3, 2, 128) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
