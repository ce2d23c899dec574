"""The operation and byte counts against hand-worked values at small
shapes."""

import numpy as np
import pytest

from port_bench import counts as C
from port_bench.trace import union_ns

S = dict(d_model=4, num_layers=1, nhead=2, multiple_of=2, num_codebooks=2,
         d_codebook=3, codebook_dim=2, cond_feature_channel_scaler=2)


def test_sampler_counts():
    # block 4*(4+8) + 16 + 3*4*10, head 4*6, token projections 2*2*2
    assert C.sampler_matmul_params(S) == 216
    assert C.sampler_decode_flops(S, rows=1, steps=2) == 2 * 216 * 2 + 4 * 4 * 3
    assert C.sampler_train_flops(S, batch=1, seq=2) == 6 * 216 * 2 + 12 * 4 * 4
    # cached rows 0 + 1; at each step q, new k and v in, out
    assert C.decode_attention_bytes(S, rows=1, steps=2) == 24 + 2 * (16 + 16)
    assert C.decode_attention_flops(S, rows=1, steps=2) == 4 * 2 * 2 * 3


def test_encoder_counts():
    e = dict(embed_dim=2, mlp_ratio=2, depth=1, img_size=1, patch_size=1,
             z_block_size=2)
    frames = (1, 1, 2, 1, 1)  # one segment, one channel, two frames of 1x1
    assert C.encoder_sublayer_flops(e, frames) == 96 + 96 + 32
    assert C.encoder_flops(e, frames) == 224 + 8 + 160
    assert C.encoder_sublayer_bytes(e, frames) == 3 * 2 * 2 * 2 * 2 + 2 * 16 * 2 + 2 * 8 * 2


def test_codec_counts():
    c = dict(encoder_dim=1, encoder_rates=[2], decoder_dim=4, decoder_rates=[2],
             n_codebooks=1, codebook_dim=1, codebook_size=2)
    assert C.dac_hop(c) == 2
    assert C.dac_decode_flops(c, frames=1) == 4 + 112 + 64 + 384 + 56
    # conv_in, res units at 1 channel, down 1->2, conv_out 2->2, RVQ
    assert C.dac_encode_flops(c, samples=2) == (28 + 3 * (2 * 7 * 2 + 2 * 2)
                                                + 2 * 2 * 4 + 2 * 2 * 2 * 3
                                                + 1 * (4 * 2 + 2 * 2))


def test_roofline_and_union():
    assert C.roofline_pct(989e12, 0, 2.0) == pytest.approx(50.0)
    assert C.roofline_pct(0, 3.35e12, 4.0) == pytest.approx(25.0)
    covered, merged = union_ns(np.array([[0, 10], [5, 20], [30, 40]]))
    assert covered == 30 and merged.tolist() == [[0, 20], [30, 40]]
