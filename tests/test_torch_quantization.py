"""The port's int8 quantization (``vaura_tpu_torch/ops/quantization.py``) and
int8-cache attention against the JAX package's.

Tolerances: the quantizers get the same float32 input on both sides and must
give the same int8 values, with scales within 1e-7 relative (one float32
division); ``quant_dense`` and the attention layer within 2e-5 (float32 on
both sides, sums in other orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import CPU, J_SAMPLER, np_tree, port_sampler_config

from vaura_tpu.models.sampler import Attention as JAttention
from vaura_tpu.ops import quantization as jq
from vaura_tpu.ops.rope import precompute_freqs_cis
from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.models.sampler import Attention as TAttention
from vaura_tpu_torch.ops import quantization as tq
from vaura_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_cuda,
    decode_attention_plain,
)

TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 5, 4, 12), (3, 1, 2, 96), (1, 7, 1, 8)])
def test_quantize_kv_matches_jax(shape):
    x = _rand(sum(shape), *shape, scale=3.0)
    x[0, 0, 0] = 0.0  # an all-zero row: the scale floor of 1e-8
    jqv, jsc = jq.quantize_kv(jnp.asarray(x))
    tqv, tsc = tq.quantize_kv(torch.from_numpy(x))
    assert tqv.dtype == torch.int8 and tsc.dtype == torch.float32
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-7, atol=0)
    assert float(tsc[0, 0, 0]) == pytest.approx(1e-8)


def test_quantize_kv_rounds_half_to_even_like_jnp_round():
    # the largest magnitude is 127, so the scale is 1 and x / scale is x
    x = np.array([[63.5, 0.5, 1.5, 2.5, -0.5, 127.0]], np.float32)
    jqv, _ = jq.quantize_kv(jnp.asarray(x))
    tqv, _ = tq.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    assert tqv.tolist()[0][1:5] == [0, 2, 2, 0]


def test_quantize_weight_and_quant_dense_match_jax():
    w = _rand(1, 24, 40)  # JAX layout [in, out]
    jd = jq.quantize_weight(w)
    td = tq.quantize_weight(torch.from_numpy(w.T.copy()))  # port [out, in]
    np.testing.assert_array_equal(td["kernel_q"].numpy(), jd["kernel_q"].T)
    np.testing.assert_allclose(td["scale"].numpy(), jd["scale"], rtol=1e-7)
    x = _rand(2, 3, 5, 24)
    want = jq.quant_dense(jnp.asarray(x), {k: jnp.asarray(v) for k, v in jd.items()})
    got = tq.quant_dense(torch.from_numpy(x), td["kernel_q"], td["scale"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def sampler_tree():
    from vaura_tpu.models.sampler import Sampler as JSampler

    js = JSampler(J_SAMPLER)
    params = js.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0),
         "cfg_dropout": jax.random.PRNGKey(0)},
        jnp.zeros((1, 3, 16), jnp.int32), jnp.zeros((1, 8, 24)), False,
    )["params"]
    return np_tree(params)


def test_quantize_sampler_params_matches_jax(sampler_tree):
    """The port's quantizer over the converted float state dict gives what
    ``from_jax_params`` makes of JAX's quantized tree, name for name."""
    jtree = jq.quantize_sampler_params(sampler_tree)
    from_jax = from_jax_params({"sampler": jtree})["sampler"]
    ours = tq.quantize_sampler_params(
        from_jax_params({"sampler": sampler_tree})["sampler"])
    assert set(ours) == set(from_jax)
    n_q = 0
    for name, t in ours.items():
        if name.endswith("kernel_q"):
            n_q += 1
            assert t.dtype == torch.int8 and from_jax[name].dtype == torch.int8
            assert torch.equal(t, from_jax[name]), name
        else:
            np.testing.assert_allclose(t.numpy(), from_jax[name].numpy(),
                                       rtol=1e-7, atol=0, err_msg=name)
    assert n_q == 5 * J_SAMPLER.num_layers + 1
    # the conditioning projection stays float, as in the JAX package
    assert "cls_embeddings.fc1.weight" in ours


# --------------------------------------------------------------------------
# the int8 branch of decode attention
B, S, HD = 2, 70, 16


def _int8_inputs(seed, H=4, Hkv=4, pos=S):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    kq, ks = tq.quantize_kv(torch.from_numpy(f(B, S, Hkv, HD)))
    vq, vs = tq.quantize_kv(torch.from_numpy(f(B, S, Hkv, HD)))
    # rows at and past pos are stale: they must not be read
    kq[:, pos:], vq[:, pos:] = 127, -127
    ks[:, pos:], vs[:, pos:] = 1e4, 1e4
    q, kcur, vcur = (torch.from_numpy(a) for a in
                     (f(B, H, HD), f(B, Hkv, HD), f(B, Hkv, HD)))
    return q, kq, vq, kcur, vcur, ks, vs


@pytest.mark.parametrize("Hkv", [4, 1])
@pytest.mark.parametrize("pos", [0, 1, 63, 64, 69])
def test_int8_plain_equals_float_attention_on_the_dequantized_cache(pos, Hkv):
    q, kq, vq, kcur, vcur, ks, vs = _int8_inputs(pos + Hkv, Hkv=Hkv, pos=pos)
    got = decode_attention(q, kq, vq, kcur, vcur, pos, ks, vs)
    kd = kq.float() * ks[..., None]
    vd = vq.float() * vs[..., None]
    want = decode_attention_plain(q, kd, vd, kcur, vcur, pos)
    torch.testing.assert_close(got, want, **TOL)
    pos_t = torch.arange(S, dtype=torch.int32)[pos:pos + 1]
    assert torch.equal(decode_attention(q, kq, vq, kcur, vcur, pos_t, ks, vs),
                       got)


def test_int8_cuda_wrapper_refuses_cpu_tensors_and_missing_scales():
    q, kq, vq, kcur, vcur, ks, vs = _int8_inputs(0)
    with pytest.raises(ValueError):
        decode_attention_cuda(q, kq, vq, kcur, vcur, 5, ks, vs)
    with pytest.raises(ValueError):
        decode_attention_cuda(q, kq, vq, kcur, vcur, 5, ks, None)


@pytest.mark.parametrize("n_kv_head", [None, 2])
@pytest.mark.parametrize("split", [None, 30])
def test_int8_attention_layer_matches_jax(n_kv_head, split):
    """The port's ``Attention.decode`` (through the int8 plain version)
    against the JAX layer's int8 einsum branch, with the JAX cache in one
    chunk or split in two."""
    jcfg = dataclasses.replace(J_SAMPLER, quantize_cache=True,
                               n_kv_head=n_kv_head)
    Hkv, hd = jcfg.n_kv_heads, jcfg.head_dim
    x = _rand(3, B, 1, jcfg.d_model)
    layer = JAttention(jcfg)
    freqs = jnp.asarray(precompute_freqs_cis(jcfg.block_size, hd))
    rng = np.random.default_rng(4)
    kq = rng.integers(-127, 128, (B, S, Hkv, hd)).astype(np.int8)
    vq = rng.integers(-127, 128, (B, S, Hkv, hd)).astype(np.int8)
    ks = rng.uniform(0.001, 0.03, (B, S, Hkv)).astype(np.float32)
    vs = rng.uniform(0.001, 0.03, (B, S, Hkv)).astype(np.float32)
    pos = 50
    fr = jax.lax.dynamic_slice(freqs, (pos, 0, 0), (1, hd // 2, 2))
    params = layer.init(jax.random.PRNGKey(1), jnp.asarray(x), fr, None,
                        ((jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ks),
                          jnp.asarray(vs)),), jnp.int32(pos), False,
                        (jnp.arange(S) < pos,))["params"]
    cut = [0, S] if split is None else [0, split, S]
    chunks = tuple(tuple(jnp.asarray(a[:, lo:hi]) for a in (kq, vq, ks, vs))
                   for lo, hi in zip(cut, cut[1:]))
    masks = tuple(None for _ in chunks[:-1]) + (
        cut[-2] + jnp.arange(S - cut[-2]) < pos,)
    want, (jk, jv) = layer.apply({"params": params}, jnp.asarray(x), fr, None,
                                 chunks, jnp.int32(pos), False, masks)

    tl = TAttention(port_sampler_config(jcfg), device=CPU)
    tp = np_tree(params)
    tl.load_state_dict({"wqkv.weight": torch.from_numpy(tp["wqkv"]["kernel"].T.copy()),
                        "wo.weight": torch.from_numpy(tp["wo"]["kernel"].T.copy())})
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    with torch.no_grad():
        got, (tk, tv) = tl.decode(t(x), torch.from_numpy(np.array(fr)),
                                  (t(kq), t(vq), t(ks), t(vs)),
                                  torch.tensor([pos], dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk)[:, 0], **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv)[:, 0], **TOL)
