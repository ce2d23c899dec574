"""LoRA of the port (``vaura_tpu_torch/train/lora.py``, ``VauraSystem``'s
``lora_sampler`` and ``lora_merged``) against the JAX package's
(``vaura_tpu/train/lora.py``, ``VauraSystem._resolve_params``) on the tiny
float32 system, the adapters carried across with ``from_jax_params``
(stacked ``[L, in, r]`` -> one transposed pair per layer).

Tolerances: merged weights 1e-6 relative (one product of rank 4 and one
add); the loss and the adapters' gradients 1e-5 (``test_torch_train_step``'s
tolerance of a training step); greedy codes token for token. Also here: the
JAX package's merge into int8 weights (``quantize``), which raises a
``KeyError``, beside the port's ``ValueError``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (
    CPU,
    J_DAC,
    J_SAMPLER_TRAIN,
    init_jax_system,
    np_tree,
    port_dac_config,
    port_sampler_config,
)

from vaura_tpu.models.vaura import VauraSystem as JSystem
from vaura_tpu.ops.quantization import quantize_sampler_params as j_quantize
from vaura_tpu.train.lora import DEFAULT_TARGETS
from vaura_tpu.train.lora import init_lora as j_init_lora
from vaura_tpu.train.lora import merge_lora as j_merge_lora
from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.models.sampler import Sampler
from vaura_tpu_torch.models.vaura import VauraSystem as TSystem
from vaura_tpu_torch.ops.quantization import quantize_sampler_params
from vaura_tpu_torch.train.lora import count_lora_params, merge_lora
from vaura_tpu_torch.train.state import TrainState, make_optimizer
from vaura_tpu_torch.train.steps import split_params
from vaura_tpu_torch.utils import seeded_init_

RANK, ALPHA = 4, 8.0
B, TA, TV = 2, 12, 8


@pytest.fixture(scope="module")
def setup():
    """JAX and port systems over one tree: the tiny sampler with random
    heads, and adapters whose ``b`` is filled with seeded values (a zero
    ``b`` merges to the base and passes no gradient to ``a``)."""
    _, tree = init_jax_system(seed=0)
    tree = {"sampler": tree["sampler"], "dac": tree["dac"]}
    lora = np_tree(j_init_lora(jax.random.PRNGKey(3), tree["sampler"], RANK,
                               DEFAULT_TARGETS))
    rng = np.random.default_rng(4)
    for mod in lora["layers"].values():
        for pair in mod.values():
            pair["lora_b"] = (0.05 * rng.standard_normal(
                pair["lora_b"].shape)).astype(np.float32)
    tree["lora_sampler"] = lora
    jsys = JSystem(sampler_config=J_SAMPLER_TRAIN, dac_config=J_DAC,
                   encoder_config=None, lora_rank=RANK, lora_alpha=ALPHA)
    tsys = TSystem(port_sampler_config(J_SAMPLER_TRAIN), port_dac_config(),
                   None, device=CPU, lora_rank=RANK, lora_alpha=ALPHA)
    tsys.load_state_dicts(from_jax_params(tree))
    data = np.random.default_rng(5)
    batch = {"codes": data.integers(0, 16, (B, 3, TA)).astype(np.int32),
             "vis": data.standard_normal((B, TV, 24)).astype(np.float32)}
    return jsys, tree, tsys, batch


def test_init_merges_to_the_base():
    """``lora_b`` starts at zero: the merged weights equal the base ones,
    and the adapters are one pair per adapted layer (5 a layer)."""
    tsys = TSystem(port_sampler_config(J_SAMPLER_TRAIN), port_dac_config(),
                   None, device=CPU, lora_rank=RANK)
    a = tsys.lora_sampler.get_submodule("layers.0.attention.wqkv").lora_a
    assert 0.01 < float(a.detach().std()) < 0.03  # N(0, 0.02) at construction
    seeded_init_(tsys, torch.Generator().manual_seed(0))
    merged = merge_lora(tsys.sampler, tsys.lora_sampler)
    assert len(merged) == 5 * J_SAMPLER_TRAIN.num_layers
    for name, w in merged.items():
        assert torch.equal(w, tsys.sampler.get_submodule(name).weight), name
    d, r = J_SAMPLER_TRAIN.d_model, RANK
    n_kv = 2 * d  # wqkv's out: q, k, v at nhead = n_kv_heads
    hidden = tsys.sampler.layers[0].feed_forward.w1.weight.shape[0]
    per_layer = r * (d + d + n_kv) + r * (d + d) + 2 * r * (d + hidden) \
        + r * (hidden + d)
    assert count_lora_params(tsys.lora_sampler) == \
        J_SAMPLER_TRAIN.num_layers * per_layer
    assert 0.01 < float(a.detach().std()) < 0.03  # and from seeded_init_
    assert not torch.any(tsys.lora_sampler.get_submodule(
        "layers.1.feed_forward.w2").lora_b)


def test_merge_matches_jax(setup):
    _, tree, tsys, _ = setup
    want = from_jax_params({"sampler": np_tree(j_merge_lora(
        tree["sampler"], tree["lora_sampler"], ALPHA))})["sampler"]
    got = merge_lora(tsys.sampler, tsys.lora_sampler, ALPHA)
    assert got
    for name, w in got.items():
        ref = want[f"{name}.weight"].numpy()
        assert not np.array_equal(
            ref, tsys.sampler.get_submodule(name).weight.detach().numpy())
        np.testing.assert_allclose(w.detach().numpy(), ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max(), err_msg=name)


@pytest.fixture(scope="module")
def jax_loss_and_grads(setup):
    jsys, tree, _, batch = setup
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    frozen = {k: v for k, v in jp.items() if k != "lora_sampler"}

    def loss_fn(lora):
        loss, _ = jsys.train_forward(
            {**frozen, "lora_sampler": lora}, None, None,
            jax.random.PRNGKey(0), train=True,
            vis_feats=jnp.asarray(batch["vis"]),
            codes=jnp.asarray(batch["codes"]))
        return loss

    loss, grads = jax.value_and_grad(loss_fn)(jp["lora_sampler"])
    want = from_jax_params({"lora_sampler": np_tree(grads)})["lora_sampler"]
    return float(loss), {f"lora_sampler.{k}": v.numpy()
                         for k, v in want.items()}


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_train_forward_loss_and_adapter_gradients_match_jax(
        setup, jax_loss_and_grads, remat):
    """Gradients reach the adapters through the merged weights, also when
    the blocks are recomputed in the backward pass (``remat``): the rerun
    reads the merge of its own call."""
    _, tree, tsys, batch = setup
    if remat:
        tsys = TSystem(port_sampler_config(J_SAMPLER_TRAIN, remat=True),
                       port_dac_config(), None, device=CPU, lora_rank=RANK,
                       lora_alpha=ALPHA)
        tsys.load_state_dicts(from_jax_params(tree))
    want_loss, want = jax_loss_and_grads
    trainable, _ = split_params(tsys)
    loss, _ = tsys.train_forward(None, None, train=True,
                                 vis_feats=torch.from_numpy(batch["vis"]),
                                 codes=torch.from_numpy(batch["codes"]))
    grads = torch.autograd.grad(loss, list(trainable.values()))
    np.testing.assert_allclose(loss.item(), want_loss, rtol=0, atol=1e-5)
    assert set(want) == set(trainable)
    for name, g in zip(trainable, grads):
        assert np.abs(want[name]).max() > 0, name
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0, atol=1e-5,
                                   err_msg=name)


def test_only_the_adapters_train(setup):
    """With adapters, ``split_params`` trains the adapters alone: a step
    leaves every base-sampler weight bit for bit as it was and moves the
    adapters; the names of the base weights are the non-LoRA system's."""
    _, tree, _, _ = setup
    tsys = TSystem(port_sampler_config(J_SAMPLER_TRAIN), port_dac_config(),
                   None, device=CPU, lora_rank=RANK)
    plain = TSystem(port_sampler_config(J_SAMPLER_TRAIN), port_dac_config(),
                    None, device=CPU)
    seeded_init_(tsys, torch.Generator().manual_seed(1))  # no NaN garbage
    base = from_jax_params({"sampler": tree["sampler"]})
    tsys.load_state_dicts(base)
    torch.nn.init.normal_(
        tsys.lora_sampler.get_submodule("layers.0.attention.wo").lora_b,
        0.0, 0.05)
    assert {n for n, _ in tsys.named_parameters()
            if not n.startswith("lora_sampler.")} == \
        {n for n, _ in plain.named_parameters()}
    trainable, frozen = split_params(tsys)
    assert trainable and all(k.startswith("lora_sampler.") for k in trainable)
    assert all(not p.requires_grad for k, p in frozen.items())
    before = {k: v.detach().clone() for k, v in tsys.state_dict().items()}
    state = TrainState.create(trainable, make_optimizer(1e-2))
    data = np.random.default_rng(0)
    loss, _ = tsys.train_forward(
        None, None, train=True,
        vis_feats=torch.from_numpy(
            data.standard_normal((B, TV, 24)).astype(np.float32)),
        codes=torch.from_numpy(data.integers(0, 16, (B, 3, TA))))
    names = list(trainable)
    grads = dict(zip(names, torch.autograd.grad(
        loss, [trainable[k] for k in names])))
    state.apply_gradients(grads)
    after = tsys.state_dict()
    for k, v in before.items():
        if k.startswith("lora_sampler."):
            continue
        assert torch.equal(after[k], v), k
    assert any(not torch.equal(after[k], before[k]) for k in names
               if k.endswith("lora_a") or k.endswith("lora_b"))


@pytest.mark.parametrize("cfg_scale", [1.0, 3.0])
def test_greedy_generation_with_adapters_matches_jax(setup, cfg_scale):
    """``generate`` merges once and decodes with the merged weights: the
    same greedy codes as JAX's, and other codes than the base's."""
    jsys, tree, tsys, batch = setup
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    kw = dict(max_new_tokens=10, use_sampling=False, cfg_scale=cfg_scale,
              decode_to_audio=False, tokens_per_frame=2)
    want = jsys.generate(jp, None, jax.random.PRNGKey(0),
                         vis_feats=jnp.asarray(batch["vis"]),
                         decode_buckets=1, **kw)["codes"]
    got = tsys.generate(vis_feats=torch.from_numpy(batch["vis"]), **kw)
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want))
    assert all(m.merged is None for m in tsys.sampler.modules()
               if hasattr(m, "merged"))
    lora = tsys.lora_sampler
    tsys.lora_sampler = None
    try:
        base = tsys.generate(vis_feats=torch.from_numpy(batch["vis"]), **kw)
    finally:
        tsys.lora_sampler = lora
    assert not torch.equal(base["codes"], got["codes"])


def test_merging_into_int8_weights(setup):
    """JAX fault: with ``quantize`` the generate action turns the sampler's
    kernels into ``kernel_q`` / ``scale`` and ``merge_lora`` then looks up
    ``kernel`` (``KeyError``). The port raises a ``ValueError`` that says
    why, from ``merge_lora`` and from ``generate``."""
    _, tree, tsys, batch = setup
    with pytest.raises(KeyError, match="kernel"):
        j_merge_lora(j_quantize(tree["sampler"]), tree["lora_sampler"], ALPHA)
    q = TSystem(port_sampler_config(J_SAMPLER_TRAIN), port_dac_config(),
                None, device=CPU, lora_rank=RANK, lora_alpha=ALPHA)
    q.load_state_dicts({"lora_sampler": tsys.lora_sampler.state_dict()})
    cfg = port_sampler_config(J_SAMPLER_TRAIN, quantize_weights=True)
    q.sampler = Sampler(cfg, CPU)
    q.sampler.load_state_dict(quantize_sampler_params(
        tsys.sampler.state_dict()))
    with pytest.raises(ValueError, match="cannot be merged into int8"):
        merge_lora(q.sampler, q.lora_sampler)
    with pytest.raises(ValueError, match="cannot be merged into int8"):
        q.generate(vis_feats=torch.from_numpy(batch["vis"]),
                   max_new_tokens=4, decode_to_audio=False)


def test_one_merge_per_entry_call(setup, monkeypatch):
    """The adapters merge once per entry call, not per weight use or per
    chunk: ``generate_long`` runs ``generate`` for each of its chunks inside
    one merge, and the stream keeps its merge until it ends."""
    import vaura_tpu_torch.models.vaura as tvaura

    _, _, tsys, batch = setup
    calls = []
    merge = tvaura.merge_lora
    monkeypatch.setattr(tvaura, "merge_lora",
                        lambda *a, **k: calls.append(1) or merge(*a, **k))
    feats = torch.from_numpy(batch["vis"]).reshape(B, 2, TV // 2, 24)
    kw = dict(vis_feats_segments=feats, total_tokens=24, stride_tokens=6,
              model_max_tokens=12, frames_per_segment=4, tokens_per_frame=2,
              use_sampling=False)
    out = tsys.generate_long(decode_to_audio=False, **kw)
    assert out["codes"].shape == (B, 3, 24)
    assert len(calls) == 1  # 3 chunks, one merge
    chunks = list(tsys.generate_long_stream(emit_margin_tokens=0, **kw))
    assert len(chunks) > 1 and len(calls) == 2
    assert torch.equal(torch.cat([c["codes"] for c in chunks], -1),
                       out["codes"])
    assert all(m.merged is None for m in tsys.sampler.modules()
               if hasattr(m, "merged"))
