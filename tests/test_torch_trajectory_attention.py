"""The port's trajectory-attention functions (``vaura_tpu_torch/ops/
trajectory_attention.py``) against ``vaura_tpu/ops/trajectory_attention.py``
on the same numpy-seeded float32 inputs, within 1e-5. Orthoformer and
Performer get JAX's own draws of ``PRNGKey(0)`` (the first landmarks, the
random features): ``jax.random`` cannot be reproduced in PyTorch, so the
port takes the draws as inputs and the function is held, not the draw."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaura_tpu.ops import trajectory_attention as J
from vaura_tpu_torch.ops import trajectory_attention as T

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(seed, BH=3, F=4, P=9, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((BH, F * P, d)).astype(np.float32)
            for _ in range(3)]


def _both(fn_j, fn_t, arrays, **kw):
    want = np.asarray(fn_j(*map(jnp.asarray, arrays), **kw))
    got = fn_t(*map(torch.from_numpy, arrays), **kw).numpy()
    return got, want


def test_spatial_full():
    got, want = _both(J.trajectory_spatial_full, T.trajectory_spatial_full,
                      _qkv(0), num_frames=4)
    assert got.shape == (3, 36, 4, 16)
    np.testing.assert_allclose(got, want, **TOL)


def test_newton_schulz_pinv():
    rng = np.random.default_rng(1)
    K = rng.standard_normal((2, 8, 8)).astype(np.float32)
    K = np.exp(K) / np.exp(K).sum(-1, keepdims=True)  # row-stochastic
    want = np.asarray(J._newton_schulz_pinv(jnp.asarray(K)))
    got = T._newton_schulz_pinv(torch.from_numpy(K)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("N,L", [(36, 6), (36, 5), (1568, 128)])
def test_segment_means(N, L):
    # 1568 tokens over 128 landmarks: the full-width uneven split
    x = np.random.default_rng(2).standard_normal((2, N, 4)).astype(np.float32)
    want = np.asarray(J._segment_means(jnp.asarray(x), L))
    got = T._segment_means(torch.from_numpy(x), L).numpy()
    assert got.shape == (2, L, 4)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("landmarks,spatial", [(6, True), (5, True),
                                                (5, False)])
def test_nystrom(landmarks, spatial):
    got, want = _both(J.nystrom_spatial_attn, T.nystrom_spatial_attn,
                      _qkv(3), landmarks=landmarks, num_frames=4,
                      use_spatial_landmarks=spatial)
    np.testing.assert_allclose(got, want, **TOL)


def test_orthoformer_with_jax_draws():
    q, k, v = _qkv(4)
    BH, N, _ = q.shape
    want = np.asarray(J.orthoformer(*map(jnp.asarray, (q, k, v)),
                                    num_landmarks=7, num_frames=4))
    first = np.array(jax.random.randint(jax.random.PRNGKey(0), (BH,), 0, N))
    got = T.orthoformer(*map(torch.from_numpy, (q, k, v)), num_landmarks=7,
                        num_frames=4, first=torch.from_numpy(first)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the greedy selection itself: the same landmarks
    qs = q * 16 ** -0.25
    lj = np.asarray(J._orthogonal_landmarks(jnp.asarray(qs), 7,
                                            jax.random.PRNGKey(0)))
    lt = T._orthogonal_landmarks(torch.from_numpy(qs), 7,
                                 torch.from_numpy(first)).numpy()
    np.testing.assert_array_equal(lt, lj)


def test_orthoformer_draws_from_a_generator():
    q, k, v = map(torch.from_numpy, _qkv(5))
    g = lambda: torch.Generator().manual_seed(3)
    a = T.orthoformer(q, k, v, 7, 4, generator=g())
    b = T.orthoformer(q, k, v, 7, 4,
                      first=T.first_landmarks(3, 36, g()))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        T.orthoformer(q, k, v, 7, 4)


def test_performer_with_jax_draws():
    q, k, v = _qkv(6)
    want = np.asarray(J.performer_spatial_attn(
        *map(jnp.asarray, (q, k, v)), num_frames=4, num_features=40))
    proj = np.array(J._orthogonal_gaussian(jax.random.PRNGKey(0), 40, 16))
    got = T.performer_spatial_attn(*map(torch.from_numpy, (q, k, v)),
                                   num_frames=4, num_features=40,
                                   proj=torch.from_numpy(proj)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    for is_query in (True, False):
        kj = np.asarray(J._softmax_kernel(jnp.asarray(q), jnp.asarray(proj),
                                          is_query))
        kt = T._softmax_kernel(torch.from_numpy(q), torch.from_numpy(proj),
                               is_query).numpy()
        np.testing.assert_allclose(kt, kj, **TOL)


def test_orthogonal_gaussian_structure():
    """The port's own draw: orthogonal rows within each ``d x d`` block,
    row norms those of Gaussian d-vectors, the same draw from the same
    seed."""
    g = lambda: torch.Generator().manual_seed(0)
    m, d = 40, 16
    p = T.orthogonal_gaussian(m, d, g())
    assert p.shape == (m, d)
    assert torch.equal(p, T.orthogonal_gaussian(m, d, g()))
    for lo in range(0, m, d):
        blk = p[lo:lo + d]
        u = blk / blk.norm(dim=-1, keepdim=True)
        torch.testing.assert_close(u @ u.T, torch.eye(len(blk)), atol=1e-5,
                                   rtol=0)
    assert 0.7 < float(p.norm(dim=-1).mean()) / d ** 0.5 < 1.3
