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


@pytest.mark.parametrize("G,L", [(9, 4), (4, 17), (14, 8), (2, 96)])
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
