"""The int8 encoder (``MotionFormerConfig.quantize``) against
``vaura_tpu``'s: ``quantize_rows`` and ``quantize_encoder_params`` bit for
bit on the same float32 inputs; the exact int32 product; the int8 forward
within 1e-5 absolute of JAX's int8 forward on features of magnitude 0.05
(both quantize float32 activations of the same values, which may differ in
their last bits: an activation that lands on the other side of a rounding
boundary moves one int8 level; measured 4.3e-7), and inside
``tests/test_encoder_quant.py``'s bound of the float forward (relative
error < 0.05, cosine > 0.995, at random weights)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import CPU, np_tree, port_encoder_config

from vaura_tpu.models.motionformer import MotionFormer as JMF
from vaura_tpu.models.motionformer import MotionFormerConfig as JCfg
from vaura_tpu.ops import quantization as JQ
from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.models.motionformer import MotionFormer as TMF
from vaura_tpu_torch.ops import quantization as TQ

# tests/test_encoder_quant.py's configuration
CFG = JCfg(
    img_size=32, patch_size=8, embed_dim=48, depth=2, num_heads=2,
    temporal_resolution=2, z_block_size=2, drop_path_rate=0.0,
    drop_rate=0.0, dtype=jnp.float32, fused_divided_attention=False,
    fused_encoder_block=False,
)
FRAMES = np.random.default_rng(1).standard_normal(
    (2, 2, 3, 4, 32, 32)).astype(np.float32)


def test_quantize_rows_bit_equal():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row: the scale floor
    # a row of scale 1 with values on rounding ties (half to even)
    x[1, 1, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    x[1, 1, 6:] = 0.0
    qj, sj = map(np.asarray, JQ.quantize_rows(jnp.asarray(x)))
    qt, st = TQ.quantize_rows(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), qj)
    np.testing.assert_array_equal(st.numpy(), sj)


def test_int8_matmul_is_exact():
    rng = np.random.default_rng(2)
    xq = rng.integers(-127, 128, (2, 19, 3072), dtype=np.int8)
    wq = rng.integers(-127, 128, (40, 3072), dtype=np.int8)
    got = TQ.int8_matmul(torch.from_numpy(xq), torch.from_numpy(wq))
    assert got.dtype == torch.int32 and got.shape == (2, 19, 40)
    want = xq.astype(np.float64) @ wq.T.astype(np.float64)
    np.testing.assert_array_equal(got.numpy().astype(np.float64), want)


def _tree(cfg, seed=0):
    jm = JMF(cfg)
    params = jax.jit(lambda r: jm.init(r, jnp.asarray(FRAMES[:1, :1])))(
        jax.random.PRNGKey(seed))["params"]
    return jm, np_tree(params)


@pytest.mark.parametrize("attn_layer", ["divided", "joint"])
def test_quantize_encoder_params_bit_equal(attn_layer):
    cfg = dataclasses.replace(CFG, attn_layer=attn_layer)
    _, tree = _tree(cfg)
    want = from_jax_params({"encoder": JQ.quantize_encoder_params(tree)})[
        "encoder"]
    got = TQ.quantize_encoder_params(from_jax_params({"encoder": tree})[
        "encoder"])
    assert got.keys() == want.keys()
    n_int8 = 0
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
        n_int8 += got[k].dtype == torch.int8
    # six layers a divided block, the MLP's two in every layout
    assert n_int8 == cfg.depth * (6 if attn_layer == "divided" else 2)
    # the int8 encoder of the port loads it as it is
    TMF(port_encoder_config(dataclasses.replace(cfg, quantize=True)),
        device=CPU).load_state_dict(got)


@pytest.mark.parametrize("attn_layer", ["divided", "joint"])
def test_int8_forward(attn_layer):
    cfg = dataclasses.replace(CFG, attn_layer=attn_layer)
    jm, tree = _tree(cfg)
    qcfg = dataclasses.replace(cfg, quantize=True)
    qtree = JQ.quantize_encoder_params(tree)
    jq = JMF(qcfg)
    want = np.asarray(jax.jit(lambda p, f: jq.apply({"params": p}, f)[0])(
        jax.tree_util.tree_map(jnp.asarray, qtree), jnp.asarray(FRAMES)))

    sd = from_jax_params({"encoder": tree})["encoder"]
    tm = TMF(port_encoder_config(qcfg), device=CPU)
    tm.load_state_dict(TQ.quantize_encoder_params(sd))
    ref = TMF(port_encoder_config(cfg), device=CPU)
    ref.load_state_dict(sd)
    frames = torch.from_numpy(FRAMES)
    with torch.no_grad():
        got = tm(frames).numpy()
        flt = ref(frames).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    got, flt = got.reshape(-1), flt.reshape(-1)
    rel = np.linalg.norm(got - flt) / np.linalg.norm(flt)
    cos = float(got @ flt / (np.linalg.norm(got) * np.linalg.norm(flt)))
    assert rel < 0.05, rel
    assert cos > 0.995, cos


def test_flagship_int8_encoder():
    """``flagship_system(quantize_encoder=True)``: the int8 encoder made
    from the same seeded bf16 weights as the plain flagship's (cut depth on
    the CPU); refused for training."""
    from vaura_tpu_torch.flagship import flagship_system

    kw = dict(sampler_layers=1, encoder_depth=1)
    g = lambda: torch.Generator().manual_seed(0)
    plain = flagship_system(CPU, g(), **kw)
    q = flagship_system(CPU, g(), quantize_encoder=True, **kw)
    assert q.encoder.cfg.quantize and not plain.encoder.cfg.quantize
    want = TQ.quantize_encoder_params(plain.encoder.state_dict())
    got = q.encoder.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert not any(p.requires_grad for p in q.parameters())
    with pytest.raises(ValueError):
        flagship_system(CPU, quantize_encoder=True, training=True, **kw)
