"""The port's grouped attention with the CLS column
(``vaura_tpu_torch/ops/divided_attention.py``; on the CPU its plain version)
against ``vaura_tpu``'s Pallas kernel in interpret mode and its einsum
reference, float32, inputs made with numpy from a seed.

Tolerances: 2e-5 on the forward (the JAX package's own tolerance of kernel
against reference: float32 sums in another order); rtol 1e-4 / atol 1e-5 on
the gradients (its own tolerance for the custom VJP)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaura_tpu.ops.divided_attention import _reference
from vaura_tpu.ops.divided_attention import grouped_cls_attention as j_op
from vaura_tpu_torch.ops import divided_attention as t_op


def _args(seed, BH, G, L, hd):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (r(BH, G, L, hd) * hd ** -0.5, r(BH, G, L, hd), r(BH, G, L, hd),
            r(BH, 1, hd), r(BH, 1, hd))


@pytest.mark.parametrize(
    "G,L",
    [(9, 4), (4, 17), (14, 8), (2, 96),
     # around the edges of the CUDA kernel's tiles: 16 query rows, chunks of
     # 16 and 64 keys, the flagship space axis, the longest group
     (3, 15), (3, 16), (2, 63), (2, 64), (2, 65), (1, 196), (1, 256)])
def test_op_matches_pallas_kernel_and_reference(G, L):
    args = _args(0, 3, G, L, 16)
    got = t_op.grouped_cls_attention(*map(torch.from_numpy, args)).numpy()
    jargs = tuple(map(jnp.asarray, args))
    for want in (j_op(*jargs, True), _reference(*jargs)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


def test_gradients_match_custom_vjp():
    args = _args(2, 2, 4, 6, 8)
    w = np.random.default_rng(3).standard_normal(args[0].shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(j_op(*a, True) * w),
                    argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in args]
    (t_op.grouped_cls_attention(*ins) * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-5)


def test_backward_goes_through_the_plain_version(monkeypatch):
    """The backward recomputes through ``grouped_cls_attention_plain`` (as
    the JAX package's ``_bwd`` takes the VJP of ``_reference``)."""
    calls = []
    plain = t_op.grouped_cls_attention_plain
    monkeypatch.setattr(t_op, "grouped_cls_attention_plain",
                        lambda *a: calls.append(1) or plain(*a))
    ins = [torch.from_numpy(a).requires_grad_(True)
           for a in _args(4, 2, 3, 5, 8)]
    out = t_op.grouped_cls_attention(*ins)
    n_forward = len(calls)
    out.sum().backward()
    assert len(calls) == n_forward + 1
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in ins)


def test_cuda_wrapper_raises_off_contract():
    """No card here: the CUDA wrapper must refuse CPU tensors rather than
    fall back, and count no launch."""
    before = t_op.launches
    with pytest.raises(ValueError, match="must be on"):
        t_op.grouped_cls_attention_cuda(
            *[torch.from_numpy(a).bfloat16() for a in _args(5, 2, 3, 4, 64)])
    assert t_op.launches == before
    assert t_op.pack_rows(8) == 128 and t_op.pack_rows(196) == 196
    assert t_op.MAX_GROUP_LEN == 256 and t_op.pack_rows(256) == 256


@pytest.mark.parametrize(
    "N,L,want",
    [
        # flagship time axis: 16 groups of 8 frames a pack, a ragged last pack
        (1568, 8, dict(rows_per_pack=128, n_packs=13, last_pack_rows=32,
                       query_tiles=8, warps=8, blocks_per_sm=2)),
        # flagship space axis: one group of 196 locations a pack, 13 query
        # tiles over 8 warps
        (1568, 196, dict(rows_per_pack=196, n_packs=8, last_pack_rows=196,
                         query_tiles=13, warps=8, blocks_per_sm=2)),
        # groups that straddle the 16-row query tiles, a ragged last pack
        (153, 17, dict(rows_per_pack=119, n_packs=2, last_pack_rows=34,
                       query_tiles=8, warps=8)),
        # the longest group: one block an SM
        (512, 256, dict(rows_per_pack=256, n_packs=2, last_pack_rows=256,
                        query_tiles=16, warps=8, blocks_per_sm=1)),
        # fewer rows than a pack: fewer warps than 8
        (40, 40, dict(rows_per_pack=120, n_packs=1, last_pack_rows=40,
                      query_tiles=3, warps=3)),
    ],
)
def test_grouped_plan_at_flagship_and_ragged_shapes(N, L, want):
    plan = t_op.grouped_plan(N, L)
    assert {k: plan[k] for k in want} == want
    rows = plan["rows_per_pack"]
    # q, k, v tiles of rows + 16 rows of 144 bytes, two CLS tiles of 16 rows
    assert plan["smem_bytes"] == (3 * (rows + 16) + 32) * 144 <= 227 * 1024
    assert plan["blocks_per_sm"] >= 1


@pytest.mark.parametrize("N,L", [(100, 8),     # N not whole groups
                                 (514, 257),   # a group too long
                                 (0, 8), (64, 0)])
def test_grouped_plan_refuses_what_the_kernel_refuses(N, L):
    with pytest.raises(ValueError):
        t_op.grouped_plan(N, L)


@pytest.mark.parametrize("axis", ["time", "space"])
def test_divided_attention_module_matches_jax(axis):
    """``DividedAttention`` (unfused form) against the JAX module on its
    fused-kernel path (interpret mode)."""
    from torch_port_util import CPU

    from vaura_tpu.models.motionformer import DividedAttention as JDA
    from vaura_tpu.models.motionformer import MotionFormerConfig as JCfg
    from vaura_tpu_torch.models.motionformer import DividedAttention as TDA
    from vaura_tpu_torch.models.motionformer import MotionFormerConfig as TCfg

    f, n, H, hd = 4, 9, 2, 16
    D = H * hd
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 1 + f * n, D)).astype(np.float32)
    jm = JDA(JCfg(embed_dim=D, num_heads=H, dtype=jnp.float32,
                  fused_divided_attention=True))
    p = jm.init(jax.random.PRNGKey(4), jnp.asarray(x), "time", f, n)["params"]
    p = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)
                              * 0.1), p)
    want = jm.apply({"params": p}, jnp.asarray(x), axis, f, n)
    tm = TDA(TCfg(embed_dim=D, num_heads=H, dtype=torch.float32), device=CPU)
    tm.load_state_dict({
        "qkv.weight": torch.from_numpy(np.asarray(p["qkv"]["kernel"]).T.copy()),
        "qkv.bias": torch.from_numpy(np.asarray(p["qkv"]["bias"]).copy()),
        "proj.weight": torch.from_numpy(np.asarray(p["proj"]["kernel"]).T.copy()),
        "proj.bias": torch.from_numpy(np.asarray(p["proj"]["bias"]).copy()),
    })
    with torch.no_grad():
        got = tm(torch.from_numpy(x), axis, f, n).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
