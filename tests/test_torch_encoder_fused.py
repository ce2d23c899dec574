"""The port's fused encoder sublayers (plain versions, the path CPU tensors
take) against the JAX package's Pallas kernels in interpret mode and its
plain reference ``reference_sublayer``.

Float32 throughout, so the comparison is of the algorithm: tolerance 3e-5
absolute/relative, the one ``tests/test_encoder_fused_block.py`` holds the
Pallas kernels to (float32 sums in another order; the Pallas MLP's erf is
the Abramowitz-Stegun form, error 1.5e-7)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaura_tpu.ops.encoder_fused import (
    fused_attention_sublayer as jax_attention,
    fused_mlp_sublayer as jax_mlp,
    reference_sublayer,
)
from vaura_tpu_torch.ops import encoder_fused as port

TOL = dict(rtol=3e-5, atol=3e-5)


def _attn_args(seed, Bp, G, L, D, with_bias=True):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(
        x_tok=f(Bp, G * L, D),
        x_cls=f(Bp, 1, D),
        ln_scale=f(D) * 0.1 + 1.0,
        ln_bias=f(D) * 0.1,
        wqkv=f(D, 3 * D) * D ** -0.5,  # flax [in, out]
        bqkv=f(3 * D) * 0.02 if with_bias else None,
        wproj=f(D, D) * D ** -0.5,
        bproj=f(D) * 0.02 if with_bias else None,
    )


def _port_call(a, fn, **kw):
    t = lambda x: None if x is None else torch.from_numpy(np.ascontiguousarray(x))
    return fn(
        t(a["x_tok"]), t(a["x_cls"]), t(a["ln_scale"]), t(a["ln_bias"]),
        t(a["wqkv"].T), t(a["bqkv"]), t(a["wproj"].T), t(a["bproj"]), **kw)


@pytest.mark.parametrize(
    "G,L,H,with_bias",
    [
        (4, 2, 2, True),    # time-like: many short groups, hd=64
        (2, 6, 2, True),    # space-like: few long groups
        (3, 5, 4, False),   # odd group length, no biases, hd=32
    ],
)
def test_attention_sublayer_matches_pallas_and_reference(G, L, H, with_bias):
    a = _attn_args(G * 10 + L, 2, G, L, 128, with_bias)
    y_tok, y_cls = _port_call(a, port.fused_attention_sublayer, num_heads=H,
                              L=L, eps=1e-6)
    ja = {k: None if v is None else jnp.asarray(v) for k, v in a.items()}
    for want_tok, want_cls in (
        jax_attention(**ja, num_heads=H, L=L, eps=1e-6, interpret=True),
        reference_sublayer(**ja, num_heads=H, L=L, eps=1e-6),
    ):
        np.testing.assert_allclose(y_tok.numpy(), np.asarray(want_tok), **TOL)
        np.testing.assert_allclose(y_cls.numpy(), np.asarray(want_cls), **TOL)


def test_attention_cls_partials_merge_across_packs():
    """Many packs (time axis, L=2: 128 groups per 256-row pack, a ragged
    last pack): the flash merge of the per-pack CLS partials is exact."""
    a = _attn_args(5, 2, 300, 2, 64)
    assert port.pack_rows(2) == 256
    y_tok, y_cls = _port_call(a, port.fused_attention_sublayer, num_heads=2,
                              L=2, eps=1e-6)
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    want_tok, want_cls = reference_sublayer(**ja, num_heads=2, L=2, eps=1e-6)
    np.testing.assert_allclose(y_tok.numpy(), np.asarray(want_tok), **TOL)
    np.testing.assert_allclose(y_cls.numpy(), np.asarray(want_cls), **TOL)


@pytest.mark.parametrize("N,D,mult", [(12, 128, 4), (40, 64, 2), (24, 192, 4)])
def test_mlp_sublayer_matches_pallas(N, D, mult):
    rng = np.random.default_rng(N)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, lns, lnb = f(2, N, D), f(D) * 0.1 + 1.0, f(D) * 0.1
    w1, b1 = f(D, mult * D) * D ** -0.5, f(mult * D) * 0.02
    w2, b2 = f(mult * D, D) * (mult * D) ** -0.5, f(D) * 0.02
    want = jax_mlp(*(jnp.asarray(v) for v in (x, lns, lnb, w1, b1, w2, b2)),
                   eps=1e-6, interpret=True)
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))
    got = port.fused_mlp_sublayer(t(x), t(lns), t(lnb), t(w1.T), t(b1),
                                  t(w2.T), t(b2), eps=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_entry_points_equal_dispatch_on_cpu():
    """The ``*_plain`` functions (the kernels' yardstick on the card) are
    the very path a CPU tensor takes."""
    a = _attn_args(3, 2, 4, 2, 128)
    got = _port_call(a, port.fused_attention_sublayer, num_heads=2, L=2,
                     eps=1e-6)
    plain = _port_call(a, port.fused_attention_sublayer_plain, num_heads=2,
                       L=2, eps=1e-6)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)


def test_cuda_entry_points_refuse_configs_outside_the_kernel_contract():
    a = _attn_args(1, 1, 2, 2, 128)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    with pytest.raises(ValueError):  # head dim 32: the kernel takes 64
        port._attention_cuda(
            t(a["x_tok"]), t(a["ln_scale"]), t(a["ln_bias"]), t(a["wqkv"].T),
            t(a["bqkv"]), t(a["x_cls"][:, 0]), t(a["x_cls"][:, 0]),
            t(a["x_cls"][:, 0]), t(a["wproj"].T), t(a["bproj"]), num_heads=4,
            L=2, eps=1e-6, rows_per_pack=256)
    with pytest.raises(ValueError):  # D=96: the GEMM takes multiples of 64
        x = torch.zeros(1, 4, 96, dtype=torch.bfloat16)
        w = torch.zeros(384, 96, dtype=torch.bfloat16)
        port._mlp_cuda(x, None, None, w, None, w.t(), None, eps=1e-6)
    before = port.mlp_launches
    with pytest.raises(ValueError):  # a CPU tensor: no fallback, no count
        x = torch.zeros(1, 4, 128, dtype=torch.bfloat16)
        w = torch.zeros(512, 128, dtype=torch.bfloat16)
        port._mlp_cuda(x, None, None, w, None, w.t(), None, eps=1e-6)
    with pytest.raises(ValueError):  # float32: the kernels take bfloat16
        port._mlp_cuda(x.float(), None, None, w, None, w.t(), None, eps=1e-6)
    assert port.mlp_launches == before


@pytest.mark.parametrize(
    "M,want",
    [
        # flagship: fc1 16 x 98 tiles in 12 waves of 132 SMs, fc2 4 x 98 in 3
        (12544, dict(fc1_blocks=1568, fc2_blocks=392, fc1_waves=12,
                     fc2_waves=3)),
        # B' = 2
        (3136, dict(fc1_blocks=16 * 25, fc2_blocks=4 * 25, fc1_waves=4,
                    fc2_waves=1)),
        # ragged rows (B' = 2, N = 1571): the last row tile is masked
        (3142, dict(fc1_blocks=16 * 25, fc2_blocks=4 * 25)),
        (4713, dict(fc1_blocks=16 * 37, fc2_blocks=4 * 37, fc1_waves=5,
                    fc2_waves=2)),
        # fewer rows than a tile
        (5, dict(fc1_blocks=16, fc2_blocks=4, fc1_waves=1, fc2_waves=1)),
    ],
)
def test_mlp_plan_at_flagship_and_ragged_shapes(M, want):
    plan = port.mlp_plan(M, 768, 3072)
    assert {k: plan[k] for k in want} == want
    assert (plan["row_tile"], plan["col_tile"]) == (128, 192)
    assert plan["launches"] == port.MLP_LAUNCHES_PER_CALL == 3
    # four stages of (128 + 192) rows of 128 bytes; fc2 adds the residual tile
    assert plan["fc1_smem_bytes"] == 4 * 320 * 128 + 1024
    assert plan["fc2_smem_bytes"] == plan["fc1_smem_bytes"] + 128 * 192 * 2
    assert plan["fc2_smem_bytes"] <= port.SMEM_LIMIT
    # the normalised rows and the hidden rows, bf16
    assert plan["scratch_bytes"] == 2 * M * (768 + 3072)


def test_mlp_plan_other_widths_and_refusals():
    plan = port.mlp_plan(1000, 128, 512)   # widths below one column tile
    assert (plan["fc1_blocks"], plan["fc2_blocks"]) == (3 * 8, 1 * 8)
    for bad in ((0, 768, 3072), (100, 96, 384), (100, 768, 3000),
                (100, 0, 64), (100, 64, 0)):
        with pytest.raises(ValueError):
            port.mlp_plan(*bad)


@pytest.mark.parametrize(
    "N,L,want",
    [
        # flagship time axis: 32 groups of 8 frames a pack, a ragged last pack
        (1568, 8, dict(rows_per_pack=256, n_packs=7, last_pack_rows=32,
                       query_tiles=16)),
        # flagship space axis: one group of 196 locations a pack, padded to 256
        (1568, 196, dict(rows_per_pack=196, n_packs=8, last_pack_rows=196,
                         query_tiles=13)),
        # several groups a pack, query tiles that straddle two groups, ragged
        (280, 40, dict(rows_per_pack=240, n_packs=2, last_pack_rows=40,
                       query_tiles=15)),
        # fewer rows than one pack
        (96, 32, dict(rows_per_pack=256, n_packs=1, last_pack_rows=96,
                      query_tiles=6)),
    ],
)
def test_attention_plan_at_flagship_and_ragged_shapes(N, L, want):
    plan = port.attention_plan(N, L)
    assert {k: plan[k] for k in want} == want
    assert plan["padded_rows"] == 256 >= plan["rows_per_pack"]
    # three stages of (256 + 192) rows of 128 bytes; q, k, v laid over them
    assert plan["ring_bytes"] == 3 * (256 + 192) * 128
    assert plan["qkv_bytes"] == 3 * (256 + 16) * 144 <= plan["ring_bytes"]
    assert plan["smem_bytes"] <= port.SMEM_LIMIT


def test_attention_plan_refuses_what_the_kernel_refuses():
    with pytest.raises(ValueError):
        port.attention_plan(100, 8)        # N not whole groups
    with pytest.raises(ValueError):
        port.attention_plan(600, 300)      # a group longer than a pack
    with pytest.raises(ValueError):
        port.attention_plan(64, 8, rows_per_pack=20)  # not whole groups
    assert port.pack_rows(8) == 256 and port.pack_rows(196) == 196
    assert port.pack_rows(100) == 200 and port.pack_rows(256) == 256
