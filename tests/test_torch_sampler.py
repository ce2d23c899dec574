"""The port's sampler against ``vaura_tpu.models.sampler.Sampler`` on the
tiny float32 config of ``tests/test_system.py``, with the same weights
carried over by ``convert.from_jax_params``.

Tolerance 2e-5 absolute/relative: float32 on both sides, the same
operations; only the order of the float32 sums differs (the JAX decode step
splits the cache into chunks and sums per-chunk partials)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (
    CPU,
    J_SAMPLER,
    np_tree,
    port_sampler_config,
    randomize_sampler_heads,
)

from vaura_tpu.models.sampler import Sampler as JSampler
from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.models.sampler import Sampler as TSampler
from vaura_tpu_torch.ops.sampling import top_k_mask

TOL = dict(rtol=2e-5, atol=2e-5)
B, S, SPLIT = 2, 12, 5  # cache length, and the JAX cache's chunk boundary


@pytest.fixture(scope="module")
def samplers():
    js = JSampler(J_SAMPLER)
    params = js.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0),
         "cfg_dropout": jax.random.PRNGKey(0)},
        jnp.zeros((1, 3, 16), jnp.int32), jnp.zeros((1, 8, 24)), False,
    )["params"]
    tree = randomize_sampler_heads(np_tree(params), 1)
    ts = TSampler(port_sampler_config(), device=CPU)
    ts.load_state_dict(from_jax_params({"sampler": tree})["sampler"])
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return js, jparams, ts


def test_decode_steps_match_jax_chunked_cache(samplers):
    js, jp, ts = samplers
    cfg = J_SAMPLER
    rng = np.random.default_rng(0)
    shape = (cfg.num_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    # positions < SPLIT hold committed K/V; later positions hold stale data
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    jchunks = (
        {"k": jnp.asarray(k0[:, :, :SPLIT]), "v": jnp.asarray(v0[:, :, :SPLIT])},
        {"k": jnp.asarray(k0[:, :, SPLIT:]), "v": jnp.asarray(v0[:, :, SPLIT:])},
    )
    tcache = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy())}
    for pos in range(SPLIT, SPLIT + 4):
        tok = rng.integers(0, cfg.vocab_with_special,
                           (B, cfg.num_codebooks, 1)).astype(np.int32)
        cond = rng.standard_normal((B, 1, cfg.cond_dim)).astype(np.float32)
        jl, jchunks = js.apply(
            {"params": jp}, jnp.asarray(tok), jnp.asarray(cond), jchunks,
            jnp.int32(pos), None, (0, SPLIT), method=js.decode_step)
        tl = ts.decode_step(torch.from_numpy(tok), torch.from_numpy(cond),
                            tcache, pos)
        assert tl.shape == (B, cfg.num_codebooks, cfg.d_codebook)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jk = np.concatenate([np.asarray(c["k"]) for c in jchunks], axis=2)
    np.testing.assert_allclose(tcache["k"].numpy()[:, :, :SPLIT + 4],
                               jk[:, :, :SPLIT + 4], **TOL)


def test_conditioning_matches_jax(samplers):
    """Feature projection, the null condition (tiled past its 8 rows) and
    the per-position conditioning stream."""
    js, jp, ts = samplers
    rng = np.random.default_rng(1)
    Tv, seq, tpf = 10, 40, 3
    feats = rng.standard_normal((B, Tv, J_SAMPLER.cond_in_dim)).astype(np.float32)
    j_emb = js.apply({"params": jp}, jnp.asarray(feats), False,
                     method=js.embed_cond)
    j_unc = js.apply({"params": jp}, B, Tv, method=js.uncond_cond_emb)
    j_seq = js.apply({"params": jp}, jnp.concatenate([j_emb, j_unc]), seq, tpf,
                     method=js.build_cond_seq)
    with torch.no_grad():
        t_emb = ts.embed_cond(torch.from_numpy(feats))
        t_unc = ts.uncond_cond_emb(B, Tv)
        t_seq = ts.build_cond_seq(torch.cat([t_emb, t_unc]), seq, tpf)
    np.testing.assert_allclose(t_emb.numpy(), np.asarray(j_emb), **TOL)
    np.testing.assert_allclose(t_unc.numpy(), np.asarray(j_unc), **TOL)
    np.testing.assert_allclose(t_seq.numpy(), np.asarray(j_seq), **TOL)


def test_token_embedding_matches_jax(samplers):
    js, jp, ts = samplers
    tok = np.random.default_rng(2).integers(0, 17, (B, 3, 6)).astype(np.int32)
    j = js.apply({"params": jp}, jnp.asarray(tok),
                 method=lambda m, t: m.tok_embeddings(t))
    with torch.no_grad():
        t = ts.tok_embeddings(torch.from_numpy(tok))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_top_k_mask_keeps_ties_at_the_threshold():
    logits = torch.tensor([[3.0, 1.0, 2.0, 2.0, 0.5]])
    masked = top_k_mask(logits, 2)  # 2nd largest is 2.0, tied: both kept
    kept = (masked > -1e29).numpy()[0]
    np.testing.assert_array_equal(kept, [True, False, True, True, False])
    assert (top_k_mask(logits, 99) == logits).all()  # k >= vocab keeps all


def test_sampled_frequencies_follow_the_top_k_distribution():
    """Sampling cannot match JAX's PRNG token for token; its frequencies
    over 20000 draws from a fixed Generator match the renormalised top-k
    softmax within 5 standard errors."""
    from vaura_tpu_torch.ops.sampling import sample_tokens

    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -1.0, -3.0])
    n = 20000
    g = torch.Generator().manual_seed(0)
    draws = sample_tokens(logits.expand(n, -1), generator=g, top_k=3)
    freq = torch.bincount(draws, minlength=6).double() / n
    p = torch.softmax(logits[:3].double(), 0)
    assert (freq[3:] == 0).all()
    se = torch.sqrt(p * (1 - p) / n)
    assert ((freq[:3] - p).abs() < 5 * se).all(), (freq, p)
    greedy = sample_tokens(logits[None], generator=None, use_sampling=False)
    assert greedy.item() == 0


def test_decode_step_reads_pos_from_the_cache_positions(samplers):
    """``decode_step`` takes its position (and cache row) as a host ``int``
    or as a 0-d int64 tensor and gives the same logits and the same cache,
    bit for bit; a cache holds no table of positions."""
    _, _, ts = samplers
    cfg = J_SAMPLER
    rng = np.random.default_rng(5)
    made = ts.init_cache(B, S, dtype=torch.float32)
    assert set(made) == {"k", "v"}
    other = {k: v.clone() for k, v in made.items()}
    for pos, row in ((0, None), (1, None), (2, None), (7, 3)):
        tok = torch.from_numpy(rng.integers(
            0, cfg.vocab_with_special, (B, cfg.num_codebooks, 1)).astype(np.int32))
        cond = torch.from_numpy(
            rng.standard_normal((B, 1, cfg.cond_dim)).astype(np.float32))
        a = ts.decode_step(tok, cond, made, pos, row)
        b = ts.decode_step(tok, cond, other, torch.tensor(pos),
                           None if row is None else torch.tensor(row))
        assert torch.equal(a, b)
    assert set(other) == {"k", "v"}
    for name in made:
        assert torch.equal(made[name], other[name]), name
