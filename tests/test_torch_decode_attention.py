"""The port's decode attention (plain version, the path CPU tensors take)
against the JAX package's Pallas kernel in interpret mode and its dense
reference.

Tolerance 2e-5 absolute/relative: both sides compute float32 scores, one
softmax and a float32 value sum over the same operands; only the order of
the float32 sums differs (the Pallas kernel accumulates 64-position blocks
online)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaura_tpu.ops.pallas_attention import (
    decode_attention as jax_decode_attention,
    decode_attention_reference,
)
from vaura_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
)

B, S, H, HD = 3, 100, 2, 64  # S not a multiple of the 64-position tile


def _inputs(seed, Hkv=H):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, HD)).astype(np.float32)
    kc = rng.standard_normal((B, S, Hkv, HD)).astype(np.float32)
    vc = rng.standard_normal((B, S, Hkv, HD)).astype(np.float32)
    kcur = rng.standard_normal((B, Hkv, HD)).astype(np.float32)
    vcur = rng.standard_normal((B, Hkv, HD)).astype(np.float32)
    return q, kc, vc, kcur, vcur


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("pos", [0, 1, 63, 64, 65, 99])
def test_plain_matches_pallas_interpret_and_reference(pos):
    q, kc, vc, kcur, vcur = _inputs(pos)
    # stale data at positions >= pos must not be read: make it huge
    kc[:, pos:] = 1e4
    vc[:, pos:] = -1e4
    got = decode_attention(*_t(q, kc, vc, kcur, vcur), pos).numpy()
    want_ref = np.asarray(decode_attention_reference(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kcur),
        jnp.asarray(vcur), jnp.int32(pos)))
    np.testing.assert_allclose(got, want_ref, rtol=2e-5, atol=2e-5)
    if pos > 0:  # the Pallas wrapper needs at least one cached position
        want_kernel = np.asarray(jax_decode_attention(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kcur),
            jnp.asarray(vcur), jnp.int32(pos), interpret=True))
        np.testing.assert_allclose(got, want_kernel, rtol=2e-5, atol=2e-5)


def test_plain_gqa_matches_repeated_heads():
    """GQA: head h reads KV head h // rep; the same as repeating the KV
    heads (how the JAX einsum path handles ``rep``)."""
    q, kc, vc, kcur, vcur = _inputs(7, Hkv=1)
    got = decode_attention_plain(*_t(q, kc, vc, kcur, vcur), 50).numpy()
    rep = lambda a, ax: np.repeat(a, H, axis=ax)
    want = np.asarray(decode_attention_reference(
        jnp.asarray(q), jnp.asarray(rep(kc, 2)), jnp.asarray(rep(vc, 2)),
        jnp.asarray(rep(kcur, 1)), jnp.asarray(rep(vcur, 1)), jnp.int32(50)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel entry point raises on tensors off the card instead of
    falling back to the plain version."""
    from vaura_tpu_torch.ops.decode_attention import decode_attention_cuda

    q, kc, vc, kcur, vcur = _t(*_inputs(1))
    with pytest.raises(ValueError):
        decode_attention_cuda(q, kc, vc, kcur, vcur, 5)
