"""Snake as one operator (``vaura_tpu_torch/ops/snake.py``,
``torch.ops.vaura_torch.snake``): its plain version against the eager
formula in float32 and the JAX package's bf16 form, the operator's
registration and fake, the export of a DAC decoder through it, the
wrapper's input contract, and the launch counter on CPU tensors. The
kernel itself (``csrc/snake.cu``) is held to the plain version on the card
by ``chip_smoke.py --phase snake``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from vaura_tpu.models.dac.layers import Snake1d as JSnake1d
from vaura_tpu_torch.kernels import ops as _registered  # noqa: F401
from vaura_tpu_torch.models.dac.model import DacConfig, DacDecoder
from vaura_tpu_torch.ops import snake as S

SHAPES = [(B, C, T) for B in (1, 3) for C, T in ((16, 221), (8, 1768),
                                                  (5, 97))]


def _inputs(shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 3.0
    alpha = torch.empty(shape[1]).uniform_(0.5, 2.0, generator=g)
    return x.to(dtype), alpha.to(dtype)


def _ordered(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (int16) as integers ordered like the values, so
    that one ulp is a difference of 1."""
    b = bits.astype(np.int32)
    return np.where(b < 0, -(b & 0x7FFF), b)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_float32_is_the_eager_formula_bit_for_bit(shape):
    x, alpha = _inputs(shape)
    a = alpha[None, :, None]
    want = x + torch.sin(a * x) ** 2 / (a + 1e-9)
    got = S.snake_plain(x, alpha)
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("shape", [(1, 16, 221), (3, 8, 1768)], ids=str)
def test_plain_bf16_matches_jax_bf16_form_within_one_ulp(shape):
    x, alpha = _inputs(shape, torch.bfloat16, seed=1)
    jm = JSnake1d(shape[1])  # the default: the polynomial sin^2
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16).transpose(0, 2, 1)
    want = jm.apply({"params": {"alpha": jnp.asarray(alpha.float().numpy())}},
                    xj)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(jax.lax.bitcast_convert_type(want, jnp.int16))
    got = S.snake_plain(x, alpha).transpose(1, 2).contiguous()
    got = got.view(torch.int16).numpy()
    ulps = np.abs(_ordered(got) - _ordered(want))
    assert ulps.max() <= 1
    assert (ulps == 0).mean() > 0.99


@pytest.mark.parametrize("key", ["CPU", "CUDA"])
def test_operator_is_registered(key):
    assert torch._C._dispatch_has_kernel_for_dispatch_key(
        "vaura_torch::snake", key)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_returns_x_shape_and_dtype(dtype):
    with FakeTensorMode():
        x = torch.empty(2, 6, 221, dtype=dtype)
        out = torch.ops.vaura_torch.snake(x, torch.empty(6, dtype=dtype))
    assert out.shape == (2, 6, 221) and out.dtype == dtype


@pytest.mark.parametrize("rates", [(4, 2), (2, 2, 2)])
def test_export_of_decoder_records_snake(rates):
    cfg = DacConfig(encoder_dim=8, encoder_rates=tuple(reversed(rates)),
                    decoder_dim=32, decoder_rates=rates, latent_dim=16,
                    n_codebooks=3, codebook_size=16, codebook_dim=4)
    dec = DacDecoder(cfg).eval()
    for name, p in dec.named_parameters():
        if name.endswith("alpha"):
            p.data.uniform_(0.5, 2.0)
    z = torch.randn(2, 16, 5)
    with torch.no_grad():
        ep = torch.export.export(dec, (z,))
        want = dec(z)
    calls = [n for n in ep.graph.nodes if n.op == "call_function"
             and n.target == torch.ops.vaura_torch.snake.default]
    assert len(calls) == 7 * len(rates) + 1  # 7 a block and the output's
    got = ep.module()(z)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["float16", "not_contiguous", "rank2",
                                 "alpha_shape", "alpha_dtype"])
def test_kernel_wrapper_raises_outside_its_contract(bad):
    x, alpha = _inputs((2, 4, 64))
    if bad == "float16":
        x, alpha = x.half(), alpha.half()
    elif bad == "not_contiguous":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "rank2":
        x = x[0]
    elif bad == "alpha_shape":
        alpha = alpha[None]
    else:
        alpha = alpha.bfloat16()
    before = S.launches
    with pytest.raises((TypeError, ValueError), match="snake"):
        S.snake_cuda(x, alpha)
    assert S.launches == before


@pytest.mark.parametrize("dtype,T,vec", [
    (torch.float32, 221, False), (torch.float32, 1768, True),
    (torch.float32, 113152, True), (torch.bfloat16, 1768, True),
    (torch.bfloat16, 1764, False), (torch.bfloat16, 221, False)])
def test_vector_path_where_rows_are_16_byte_aligned(dtype, T, vec):
    x = torch.empty(2, 3, T, dtype=dtype)
    assert S.vector_path(x, torch.empty_like(x)) == vec
    # a view that starts one element in is never aligned
    off = torch.empty(2 * 3 * T + 1, dtype=dtype)[1:].view(2, 3, T)
    assert not S.vector_path(off, torch.empty_like(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_counter_stays_at_zero_on_cpu(dtype):
    cfg = DacConfig(encoder_dim=8, encoder_rates=(2, 4), decoder_dim=32,
                    decoder_rates=(4, 2), latent_dim=16, n_codebooks=3,
                    codebook_size=16, codebook_dim=4, dtype=dtype)
    before = S.launches
    with torch.no_grad():
        out = DacDecoder(cfg)(torch.randn(1, 16, 4, dtype=dtype))
        torch.ops.vaura_torch.snake(*_inputs((1, 4, 221), dtype))
    assert out.shape == (1, 1, 4 * 8) and bool(torch.isfinite(out).all())
    assert S.launches == before == 0
