"""The plain token tables (``dac_factored_embeddings=False``: per codebook
a ``[V+1, token_dim]`` table) of the port against ``vaura_tpu``'s on the
tiny float32 system of ``tests/test_system.py``: the embedding and the
sampler's forward, ``train_forward``'s loss and gradients, the weights
through ``convert.from_jax_params``, and what loading the DAC codebooks
does to such a table.

Tolerances: embeddings exact (a gather and a float32 sum of the same
rows: the sum of three values in one order on both sides); logits and loss
1e-5 absolute, the table's gradient 1e-6 absolute (float32, sums in other
orders)."""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (
    CPU,
    J_SAMPLER,
    init_jax_system,
    port_dac_config,
    port_encoder_config,
    port_sampler_config,
)

from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.models.sampler import MultiCodebookEmbedding
from vaura_tpu_torch.models.vaura import VauraSystem as TSystem

J_PLAIN = dataclasses.replace(J_SAMPLER, dac_factored_embeddings=False,
                              class_dropout_prob=0.0)
RNG = jax.random.PRNGKey(0)


@pytest.fixture(scope="module")
def systems():
    jsys, tree = init_jax_system(seed=0, sampler_config=J_PLAIN)
    tsys = TSystem(port_sampler_config(J_PLAIN), port_dac_config(),
                   port_encoder_config(), device=CPU)
    tsys.load_state_dicts(from_jax_params(tree))
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 16, (2, 3, 20)).astype(np.int32)
    vis = rng.standard_normal((2, 8, 24)).astype(np.float32)
    return jsys, tree, tsys, codes, vis


def test_plain_table_loads_from_jax_params(systems):
    _, tree, tsys, _, _ = systems
    tok = tree["sampler"]["tok_embeddings"]
    assert set(tok) == {"emb"}
    cfg = tsys.sampler_config
    assert tok["emb"].shape == (cfg.num_codebooks * cfg.vocab_with_special,
                                cfg.token_dim)
    names = {n for n, _ in tsys.sampler.tok_embeddings.named_parameters()}
    assert names == {"emb"}
    np.testing.assert_array_equal(
        tsys.sampler.tok_embeddings.emb.detach().numpy(), tok["emb"])


def test_plain_embedding_and_forward_match_jax(systems):
    jsys, tree, tsys, codes, vis = systems
    jp = jax.tree_util.tree_map(jnp.asarray, tree["sampler"])
    want = jsys.sampler.apply(
        {"params": jp}, jnp.asarray(codes),
        method=lambda m, t: m.tok_embeddings(t))
    got = tsys.sampler.tok_embeddings(torch.from_numpy(codes))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    wl = jsys.sampler.apply({"params": jp}, jnp.asarray(codes),
                            jnp.asarray(vis), False)
    gl = tsys.sampler(torch.from_numpy(codes), torch.from_numpy(vis))
    np.testing.assert_allclose(gl.detach().numpy(), np.asarray(wl), rtol=0,
                               atol=1e-5)
    # the DAC-factored module keeps its own parameters
    factored = MultiCodebookEmbedding(port_sampler_config(), device=CPU)
    assert {n for n, _ in factored.named_parameters()} == {
        "emb", "proj_v", "proj_g", "proj_b"}


def test_plain_table_train_forward_matches_jax(systems):
    """The loss from codes and features, and the table's gradient."""
    jsys, tree, tsys, codes, vis = systems
    jp = jax.tree_util.tree_map(jnp.asarray, tree)

    def loss_fn(p):
        return jsys.train_forward(p, None, None, RNG, train=False,
                                  vis_feats=jnp.asarray(vis),
                                  codes=jnp.asarray(codes))[0]

    want, grads = jax.value_and_grad(loss_fn)(jp)
    tsys.zero_grad()
    got, _ = tsys.train_forward(None, None, None, train=False,
                                vis_feats=torch.from_numpy(vis),
                                codes=torch.from_numpy(codes))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=0,
                               atol=1e-5)
    g = tsys.sampler.tok_embeddings.emb.grad.numpy()
    np.testing.assert_allclose(
        g, np.asarray(grads["sampler"]["tok_embeddings"]["emb"]), rtol=0,
        atol=1e-6)
    assert np.abs(g).max() > 0


def test_loading_dac_codebooks_into_a_plain_table_fails_as_in_jax(systems):
    """The JAX package writes the ``[K*(V+1), codebook_dim]`` codebooks over
    a plain table whose geometry matches the DAC's, and its next forward
    fails on the shape; the port refuses with a ``ValueError`` instead."""
    jsys, tree, tsys, codes, vis = systems
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    loaded = jsys.load_dac_embeddings_into_sampler(jp)
    emb = loaded["sampler"]["tok_embeddings"]["emb"]
    assert emb.shape[-1] == J_PLAIN.codebook_dim != J_PLAIN.token_dim
    with pytest.raises(flax.errors.ScopeParamShapeError):
        jsys.sampler.apply({"params": loaded["sampler"]}, jnp.asarray(codes),
                           jnp.asarray(vis), False)
    before = tsys.sampler.tok_embeddings.emb.detach().clone()
    with pytest.raises(ValueError, match="dac_factored_embeddings"):
        tsys.load_dac_embeddings_into_sampler()
    assert torch.equal(tsys.sampler.tok_embeddings.emb.detach(), before)
