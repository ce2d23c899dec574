"""The port's teacher-forced sampler forward against ``vaura_tpu``'s
``Sampler.__call__`` on the tiny float32 configuration, same weights, all
stochastic rates 0; then the stochastic parts on their own.

Tolerance 2e-5 absolute on logits of unit scale (float32 on both sides, two
layers, sums in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (
    CPU,
    J_SAMPLER_TRAIN,
    np_tree,
    port_sampler_config,
    randomize_sampler_heads,
)

from vaura_tpu.models.sampler import Sampler as JSampler
from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.models.sampler import AVCLIPEmbedder, Sampler as TSampler
from vaura_tpu_torch.ops.dropout import drop_path, dropout

B, S, TV = 2, 14, 4


def _pair(jcfg, **port_extra):
    jm = JSampler(jcfg)
    tokens = jnp.zeros((1, jcfg.num_codebooks, 8), jnp.int32)
    cond = jnp.zeros((1, TV, jcfg.cond_in_dim))
    params = jax.jit(lambda r: jm.init(
        {"params": r, "dropout": r, "cfg_dropout": r}, tokens, cond, False))(
        jax.random.PRNGKey(0))["params"]
    tree = randomize_sampler_heads(np_tree(params), 7)
    tm = TSampler(port_sampler_config(jcfg, **port_extra), device=CPU)
    tm.load_state_dict(from_jax_params({"sampler": tree})["sampler"])
    return jm, jax.tree_util.tree_map(jnp.asarray, tree), tm


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.d_codebook + 1, (B, cfg.num_codebooks, S))
    cond = rng.standard_normal((B, TV, cfg.cond_in_dim)).astype(np.float32)
    return tokens, cond


@pytest.mark.parametrize("variant", ["causal", "attn_mask", "gqa", "remat",
                                     "tokens_per_frame"])
def test_teacher_forced_logits_match_jax(variant):
    jcfg, extra, kw = J_SAMPLER_TRAIN, {}, {}
    if variant == "gqa":
        jcfg = dataclasses.replace(jcfg, n_kv_head=2)
    if variant == "remat":
        extra = {"remat": True}
    jm, jp, tm = _pair(jcfg, **extra)
    tokens, cond = _inputs(jcfg)
    mask = None
    if variant == "attn_mask":  # a window of 5 inside the causal mask
        i = np.arange(S)
        mask = (i[None] <= i[:, None]) & (i[:, None] - i[None] < 5)
    if variant == "tokens_per_frame":
        kw = {"tokens_per_frame": 2}  # positions past frame 4 take empty_emb
    want = jm.apply({"params": jp}, jnp.asarray(tokens), jnp.asarray(cond),
                    True, kw.get("tokens_per_frame"),
                    None if mask is None else jnp.asarray(mask))
    got = tm(torch.from_numpy(tokens), torch.from_numpy(cond), True,
             attn_mask=None if mask is None else torch.from_numpy(mask), **kw)
    assert got.shape == (B, jcfg.num_codebooks, S, jcfg.d_codebook)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)
    if variant == "remat":  # the recomputed blocks give the same gradients
        plain = TSampler(port_sampler_config(jcfg), device=CPU)
        plain.load_state_dict(tm.state_dict())
        got.square().mean().backward()
        plain(torch.from_numpy(tokens), torch.from_numpy(cond),
              True).square().mean().backward()
        for (k, a), (_, b) in zip(tm.named_parameters(),
                                  plain.named_parameters()):
            if a.grad is not None:
                torch.testing.assert_close(a.grad, b.grad, rtol=1e-5,
                                           atol=1e-7, msg=k)


def test_token_drop_rows_equal_the_tiled_uncond_embedding():
    cfg = port_sampler_config(dataclasses.replace(
        J_SAMPLER_TRAIN, class_dropout_prob=0.5, cond_token_num=3))
    emb = AVCLIPEmbedder(cfg, device=CPU)
    torch.nn.init.normal_(emb.uncond_embedding)
    feats = torch.randn(64, 7, cfg.cond_in_dim,
                        generator=torch.Generator().manual_seed(0))
    out = emb.token_drop(feats, torch.Generator().manual_seed(1))
    tiled = emb.uncond_embedding.repeat(3, 1)[:7]  # 3 rows tiled to 7
    dropped = [bool(torch.equal(o, tiled)) for o in out]
    kept = [bool(torch.equal(o, f)) for o, f in zip(out, feats)]
    assert all(d != k for d, k in zip(dropped, kept))  # whole samples only
    assert 16 <= sum(dropped) <= 48  # p = 0.5, 64 draws (sd 4)
    again = emb.token_drop(feats, torch.Generator().manual_seed(1))
    assert torch.equal(out, again)
    # forward applies it only when training
    torch.nn.init.normal_(emb.fc1.weight, std=0.1)
    torch.nn.init.normal_(emb.fc2.weight, std=0.1)
    assert torch.equal(emb(feats, False), emb.project(feats))


def test_dropout_and_drop_path_properties():
    g = lambda s: torch.Generator().manual_seed(s)
    x = torch.ones(64, 50, 40)
    y = dropout(x, 0.25, True, g(0))
    kept = y != 0
    assert torch.allclose(y[kept], torch.tensor(1 / 0.75))  # scaled 1/keep
    assert abs(float(kept.float().mean()) - 0.75) < 0.01    # 128k draws
    assert torch.equal(y, dropout(x, 0.25, True, g(0)))
    assert not torch.equal(y, dropout(x, 0.25, True, g(1)))
    assert dropout(x, 0.25, False, g(0)) is x and dropout(x, 0.0, True) is x
    z = drop_path(x, 0.4, True, g(2))
    per_sample = z.reshape(64, -1)
    # one draw per sample: each row is all 0 or all 1/keep
    assert all(bool((r == r[0]).all()) for r in per_sample)
    assert sorted(set(per_sample[:, 0].tolist())) == pytest.approx(
        [0.0, 1 / 0.6])
    assert 0.4 < float((per_sample[:, 0] != 0).float().mean()) < 0.8
    assert torch.equal(z, drop_path(x, 0.4, True, g(2)))
    assert drop_path(x, 0.4, False) is x and drop_path(x, 0.0, True) is x


@pytest.mark.parametrize("remat", [False, True])
def test_stochastic_forward_is_repeatable_from_its_seed(remat):
    jcfg = dataclasses.replace(J_SAMPLER_TRAIN, dropout=0.2,
                               attn_dropout_p=0.1, drop_path_rate=0.1,
                               class_dropout_prob=0.3)
    _, _, tm = _pair(jcfg, remat=remat)
    tokens, cond = map(torch.from_numpy, _inputs(jcfg))
    run = lambda seed: tm(tokens, cond, True,
                          generator=torch.Generator().manual_seed(seed))
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with torch.no_grad():
        det = tm(tokens, cond, False)
    assert not torch.equal(a.detach(), det)
    if remat:  # the backward's recomputation draws the same masks
        ga = torch.autograd.grad(a.square().mean(), tm.lm_head.weight)[0]
        gb = torch.autograd.grad(b.square().mean(), tm.lm_head.weight)[0]
        assert torch.equal(ga, gb) and bool(ga.abs().sum() > 0)
