"""The port's random draws under a mesh are rows of the one-process draws,
in one process (``ops/dropout.py::batch_shard``, ``ops/sampling.py``).

A rank that holds block ``i`` of ``n`` of the batch (and, in the decoder's
attention, block ``r`` of ``m`` of the heads) must draw the masks and the
sampling noise a single process draws for those rows and heads: each block's
draw, from a generator seeded alike, equals its slice of the whole draw,
exactly. ``tests/test_torch_multiprocess.py`` holds a whole training step at
non-zero rates on a 2 x 2 x 2 mesh against one process.
"""

import pytest
import torch
from torch_port_util import port_sampler_config

from vaura_tpu_torch.models.sampler import AVCLIPEmbedder
from vaura_tpu_torch.ops.dropout import batch_shard, drop_path, dropout
from vaura_tpu_torch.ops.sampling import sample_tokens

SEED = 7


def _gen():
    return torch.Generator().manual_seed(SEED)


@pytest.mark.parametrize("count", [1, 2, 4])
@pytest.mark.parametrize("heads", [None, 2])
def test_dropout_blocks_are_slices_of_the_whole_draw(count, heads):
    x = torch.rand(8, 4, 5, 3, generator=torch.Generator().manual_seed(1)) + 1
    whole = dropout(x, 0.5, True, _gen())
    assert 0 < int((whole == 0).sum()) < whole.numel()
    b, h = 8 // count, 4 // (heads or 1)
    for i in range(count):
        for r in range(heads or 1):
            part = x[i * b:(i + 1) * b, r * h:(r + 1) * h]
            with batch_shard((i, count)):
                got = dropout(part, 0.5, True, _gen(),
                              None if heads is None else (r, heads))
            assert torch.equal(got, whole[i * b:(i + 1) * b,
                                          r * h:(r + 1) * h]), (i, r)


def test_drop_path_blocks_are_rows_of_the_whole_draw():
    x = torch.ones(8, 3, 2)
    whole = drop_path(x, 0.5, True, _gen())
    for i in range(4):
        with batch_shard((i, 4)):
            got = drop_path(x[2 * i:2 * i + 2], 0.5, True, _gen())
        assert torch.equal(got, whole[2 * i:2 * i + 2]), i


def test_class_dropout_rows_are_the_whole_batchs():
    """One row a shard: each rank's CFG drop is its row of the whole draw,
    not one draw shared by every shard (all or nothing over the batch)."""
    cfg = port_sampler_config(class_dropout_prob=0.5)
    emb = AVCLIPEmbedder(cfg)
    torch.nn.init.normal_(emb.uncond_embedding,
                          generator=torch.Generator().manual_seed(2))
    feats = torch.rand(8, 3, cfg.cond_in_dim,
                       generator=torch.Generator().manual_seed(3)) + 5
    whole = emb.token_drop(feats, _gen())
    dropped = (whole != feats).any(-1).any(-1)
    assert 0 < int(dropped.sum()) < 8
    for i in range(8):
        with batch_shard((i, 8)):
            got = emb.token_drop(feats[i:i + 1], _gen())
        assert torch.equal(got, whole[i:i + 1]), i


@pytest.mark.parametrize("kw", [dict(top_k=3), dict(top_p=0.8), dict()])
def test_sampling_rows_are_the_whole_batchs(kw):
    logits = torch.randn(6, 2, 16, generator=torch.Generator().manual_seed(4))
    whole = sample_tokens(logits, generator=_gen(), **kw)
    assert torch.equal(sample_tokens(logits, generator=_gen(), rows=(0, 6),
                                     **kw), whole)
    for i in range(3):
        got = sample_tokens(logits[2 * i:2 * i + 2], generator=_gen(),
                            rows=(2 * i, 6), **kw)
        assert torch.equal(got, whole[2 * i:2 * i + 2]), i
