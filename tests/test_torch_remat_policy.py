"""``SamplerConfig.remat_policy`` (the JAX package's
``vaura_tpu/models/sampler.py:635-645``): with ``remat=True`` each block is
recomputed in the backward pass, keeping nothing (None), every matmul's
output ("dots") or those of the products without a batch dimension
("dots_no_batch"). Numbers do not change: without dropout the gradients
of every policy equal ``remat=False``'s bit for bit; with dropout they
equal those of ``remat_policy=None`` (a recomputed block draws its masks
from a generator of its own, seeded from the caller's, so its masks are not
``remat=False``'s); and the backward pass reruns exactly the products the
policy does not keep."""

import collections

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch_port_util import CPU, J_SAMPLER, port_sampler_config

from vaura_tpu_torch.models.sampler import Sampler, SamplerSpec
from vaura_tpu_torch.utils import seeded_init_

_aten = torch.ops.aten


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def _grads(policy, remat=True, dropout=0.0):
    cfg = port_sampler_config(J_SAMPLER, remat=remat, remat_policy=policy,
                              dropout=dropout)
    s = Sampler(cfg, CPU)
    seeded_init_(s, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.d_codebook, (2, cfg.num_codebooks, 12),
                           generator=g)
    cond = torch.randn(2, 4, cfg.cond_in_dim, generator=g)
    logits = s(tokens, cond, train=True,
               generator=torch.Generator().manual_seed(2))
    loss = logits.float().logsumexp(-1).mean()
    with _CountOps() as ops:
        loss.backward()
    return {k: p.grad for k, p in s.named_parameters()}, ops.counts


def _assert_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("policy", [None, "dots", "dots_no_batch"])
def test_gradients_equal_without_remat(policy):
    want, plain_ops = _grads(None, remat=False)
    got, ops = _grads(policy)
    _assert_equal(got, want)
    # what the backward pass ran beyond the plain one: the recomputed
    # forward products of each layer (5 dense layers, 2 attention products;
    # the rerun stops once the last saved tensor the backward needs is
    # recomputed, so the feed-forward's w2 product is never rerun)
    layers = J_SAMPLER.num_layers
    extra = {op: ops[op] - plain_ops[op] for op in
             (_aten.mm.default, _aten.bmm.default)}
    assert extra == {
        None: {_aten.mm.default: 4 * layers, _aten.bmm.default: 2 * layers},
        "dots": {_aten.mm.default: 0, _aten.bmm.default: 0},
        "dots_no_batch": {_aten.mm.default: 0,
                          _aten.bmm.default: 2 * layers},
    }[policy]


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch"])
def test_policies_keep_the_dropout_masks(policy):
    want, _ = _grads(None, dropout=0.1)
    got, _ = _grads(policy, dropout=0.1)
    _assert_equal(got, want)
    assert not torch.equal(want["lm_head.weight"],
                           _grads(None, dropout=0.0)[0]["lm_head.weight"])


def test_spec_accepts_the_policies():
    for policy in (None, "dots", "dots_no_batch"):
        assert SamplerSpec(remat=True, remat_policy=policy).remat_policy == policy
    with pytest.raises(ValueError):
        SamplerSpec(remat_policy="everything")
