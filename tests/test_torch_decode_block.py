"""The decode block's fused operators (``vaura_tpu_torch/ops/decode_block.py``,
``torch.ops.vaura_torch.{rmsnorm, add_rmsnorm, rope_qkv_store, swiglu}``):
their plain paths against the eager modules they replace, bit for bit; the
registration and fakes; the wrappers' input contract; ``Sampler.
decode_rows`` against the eager composition of those modules, logits and
cache rows bit for bit, for the Llama block (bf16, int8 and int4 caches)
and the DeepSeek-V3 block; which calls issue the operators. The kernels
themselves (``csrc/decode_block.cu``) run only on a card: the ``card``
cases skip without one, and ``chip_smoke.py``'s ``decode_graph`` phase
holds them to their plain paths at the benchmark's widths."""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from vaura_tpu_torch.kernels.ops import decode_attention_op
from vaura_tpu_torch.models.sampler import (
    Attention,
    RMSNorm,
    Sampler,
    SamplerConfig,
)
from vaura_tpu_torch.ops import decode_block as db
from vaura_tpu_torch.ops.quantization import quantize_kv
from vaura_tpu_torch.ops.rope import apply_rotary_emb, precompute_freqs_cis

OPS = ("rmsnorm", "add_rmsnorm", "rope_qkv_store", "swiglu")
WIDTHS = (1536, 2048)
# widths -> (heads, head size) of the fused q/k/v
HEADS = {1536: (16, 96), 2048: (16, 128)}
ROWS = 6

LLAMA = dict(num_layers=3, d_model=64, nhead=4, d_codebook=32,
             num_codebooks=3, cond_in_dim=16, cond_token_num=8,
             block_size_audio=64, block_size_video=16,
             cond_feature_channel_scaler=3, dropout=0.0, rope_base=50000.0,
             codebook_dim=4)
DEEPSEEK = dict(LLAMA, kv_lora_rank=16, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8,
                num_experts_per_tok=2, n_shared_experts=1,
                moe_intermediate_size=32, first_k_dense_replace=1,
                intermediate_size=96, routed_scaling_factor=2.446)
# (config, cache keys, compute dtype) of each decode_rows case
SAMPLERS = {
    "llama_bf16_cache": (LLAMA, {}, torch.bfloat16),
    "llama_int8_cache": (LLAMA, {"quantize_cache": True}, torch.bfloat16),
    "llama_int8_cache_gqa": (dict(LLAMA, n_kv_head=2),
                             {"quantize_cache": True}, torch.bfloat16),
    "llama_int8_cache_float32": (LLAMA, {"quantize_cache": True},
                                 torch.float32),
    "llama_int4_cache": (LLAMA, {"quantize_cache": True, "cache_bits": 4},
                         torch.bfloat16),
    "deepseek_v3": (DEEPSEEK, {}, torch.float32),
}


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _randn(*shape, seed=0, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=_gen(seed)) * scale).to(dtype)


def _rope_row(hd: int, pos: int) -> torch.Tensor:
    return torch.as_tensor(precompute_freqs_cis(pos + 1, hd))[pos:pos + 1]


def _rows_buffers(L, B, n_kv, hd):
    return ([torch.zeros(L, B, n_kv, hd, dtype=torch.int8) for _ in range(2)]
            + [torch.zeros(L, B, n_kv) for _ in range(2)])


def _equal(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


# ------------------------------------------------ plain against the modules --
def _modules_and_plain(op: str, width: int):
    """``(what the eager modules compute, what the plain path computes)``
    for ``op`` at ``width`` on ``ROWS`` rows."""
    x = _randn(ROWS, 1, width, seed=1, scale=2.0)
    a = _randn(ROWS, 1, width, seed=2)
    if op in ("rmsnorm", "add_rmsnorm"):
        norm = RMSNorm(width)
        with torch.no_grad():
            norm.weight.uniform_(0.5, 1.5, generator=_gen(3))
        if op == "rmsnorm":
            return ((norm(x),), (db.rmsnorm_plain(x, norm.weight, norm.eps),))
        h = x + a
        return ((h, norm(h)),
                db.add_rmsnorm_plain(x, a, norm.weight, norm.eps))
    if op == "swiglu":
        return ((F.silu(x) * a,), (db.swiglu_plain(x, a),))
    H, hd = HEADS[width]
    L, layer, pos = 3, 1, 37
    qkv = _randn(ROWS, 1, 3 * H * hd, seed=4, scale=2.0)
    cs = _rope_row(hd, pos)
    q, k, v = qkv.split([H * hd] * 3, dim=-1)
    q = apply_rotary_emb(q.reshape(ROWS, 1, H, hd), cs)[:, 0]
    k = apply_rotary_emb(k.reshape(ROWS, 1, H, hd), cs)[:, 0]
    v = v.reshape(ROWS, H, hd).contiguous()
    want = _rows_buffers(L, ROWS, H, hd)
    for t, rows, scale in ((k, want[0], want[2]), (v, want[1], want[3])):
        tq, ts = quantize_kv(torch.stack([t] * L))
        rows[layer], scale[layer] = tq[layer], ts[layer]
    got_rows = _rows_buffers(L, ROWS, H, hd)
    got = db.rope_qkv_store_plain(qkv, cs, H, H, *got_rows, layer=layer)
    return (q, k, v, *want), (*got, *got_rows)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("op", OPS)
def test_plain_path_equals_the_eager_modules_bit_for_bit(op, width):
    want, got = _modules_and_plain(op, width)
    _equal(got, want)
    assert all(t.is_contiguous() for t in got)


# -------------------------------------------------------------- operators --
@pytest.mark.parametrize("key", ["CPU", "CUDA"])
@pytest.mark.parametrize("op", OPS)
def test_operator_is_registered(op, key):
    assert torch._C._dispatch_has_kernel_for_dispatch_key(
        f"vaura_torch::{op}", key)


def _op_args(op: str, store: bool = False):
    x, a = _randn(4, 1, 32, seed=5), _randn(4, 1, 32, seed=6)
    w = torch.rand(32, generator=_gen(7)) + 0.5
    if op == "rmsnorm":
        return (x, w, 1e-5)
    if op == "add_rmsnorm":
        return (x, a, w, 1e-5)
    if op == "swiglu":
        return (x, a)
    qkv = _randn(4, 1, 3 * 2 * 16, seed=8)
    bufs = _rows_buffers(3, 4, 2, 16) if store else [None] * 4
    return (qkv, _rope_row(16, 5), 2, 2, *bufs, 2)


OPCHECK = [("rmsnorm", False), ("add_rmsnorm", False),
           ("rope_qkv_store", False), ("rope_qkv_store", True),
           ("swiglu", False)]


@pytest.mark.parametrize("op,store", OPCHECK,
                         ids=[f"{o}{'_store' if s else ''}"
                              for o, s in OPCHECK])
def test_opcheck(op, store):
    torch.library.opcheck(getattr(torch.ops.vaura_torch, op).default,
                          _op_args(op, store))


@pytest.mark.parametrize("op", OPS)
def test_fake_outputs_match_the_plain_outputs(op):
    args = _op_args(op, store=True)
    want = getattr(db, f"{op}_plain")(*args)
    want = want if isinstance(want, tuple) else (want,)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                for a in args]
        got = getattr(torch.ops.vaura_torch, op)(*fake)
    got = got if isinstance(got, tuple) else (got,)
    assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype)
                                                 for t in want]


def test_plain_paths_count_no_launch():
    before = dict(db.launches)
    for op in OPS:
        getattr(torch.ops.vaura_torch, op)(*_op_args(op, store=True))
    assert db.launches == before


# -------------------------------------------------------- input contract --
CONTRACT = {
    "float16": (lambda: db.swiglu_cuda(torch.ones(8, dtype=torch.float16),
                                       torch.ones(8, dtype=torch.float16)),
                TypeError),
    "swiglu_shapes": (lambda: db.swiglu_cuda(_randn(2, 8), _randn(2, 16)),
                      ValueError),
    "norm_weight": (lambda: db.add_rmsnorm_cuda(
        _randn(2, 8), _randn(2, 8), torch.ones(4), 1e-5), ValueError),
    "norm_weight_dtype": (lambda: db.add_rmsnorm_cuda(
        _randn(2, 8), _randn(2, 8), torch.ones(8, dtype=torch.bfloat16),
        1e-5), ValueError),
    "norm_strides": (lambda: db.rmsnorm_cuda(_randn(8, 2).t(), torch.ones(8),
                                             1e-5), ValueError),
    "rope_width": (lambda: db.rope_qkv_store_cuda(
        _randn(2, 1, 40), _rope_row(16, 1), 1, 1), ValueError),
    "rope_table": (lambda: db.rope_qkv_store_cuda(
        _randn(2, 1, 48), _rope_row(16, 1).double(), 1, 1), ValueError),
    "rope_some_buffers": (lambda: db.rope_qkv_store_cuda(
        _randn(2, 1, 48), _rope_row(16, 1), 1, 1,
        *_rows_buffers(2, 2, 1, 16)[:2]), ValueError),
    "rope_buffer_shape": (lambda: db.rope_qkv_store_cuda(
        _randn(2, 1, 48), _rope_row(16, 1), 1, 1,
        *_rows_buffers(2, 3, 1, 16)), ValueError),
    "rope_layer": (lambda: db.rope_qkv_store_cuda(
        _randn(2, 1, 48), _rope_row(16, 1), 1, 1,
        *_rows_buffers(2, 2, 1, 16), layer=2), ValueError),
}


@pytest.mark.parametrize("case", sorted(CONTRACT))
def test_wrapper_refuses_inputs_outside_its_contract(case):
    fn, error = CONTRACT[case]
    with pytest.raises(error):
        fn()


# ------------------------------------------------------------ decode_rows --
def _sampler(name: str, device="cpu", **overrides) -> Sampler:
    """The ``SAMPLERS`` case ``name`` with seeded weights (norms around 1,
    matrices scaled by their fan-in)."""
    base, cache, dtype = SAMPLERS[name]
    s = Sampler(SamplerConfig(**{**base, **overrides}, **cache, dtype=dtype),
                device=device)
    g = _gen(11)
    with torch.no_grad():
        for pname, p in s.named_parameters():
            v = torch.randn(p.shape, generator=g)
            if "norm" in pname:
                v = 1.0 + 0.25 * v
            elif p.ndim > 1:
                v = v * p.shape[-1] ** -0.5
            p.copy_(v.to(p.dtype))
    return s.eval()


def _eager_attention(att: Attention, x, freqs, cache_layer, row, starts):
    """``Attention.decode`` as the eager modules computed it: the split,
    ``apply_rotary_emb`` on q and k, contiguous copies."""
    cfg = att.cfg
    B = x.shape[0]
    H, Hkv, hd = att.n_heads, att.n_kv, cfg.head_dim
    q, k, v = att.wqkv(x).split([H * hd, Hkv * hd, Hkv * hd], dim=-1)
    q = apply_rotary_emb(q.reshape(B, 1, H, hd), freqs)[:, 0]
    k = apply_rotary_emb(k.reshape(B, 1, Hkv, hd), freqs)[:, 0]
    v = v.reshape(B, Hkv, hd).contiguous()
    k_cache, v_cache, *scales = cache_layer
    out = decode_attention_op(
        q.contiguous(), k_cache, v_cache, k.contiguous(), v, row, *scales,
        cache_bits=cfg.cache_bits,
        int8_dots=cfg.int8_dots and cfg.quantize_cache, chunk_starts=starts)
    return att.wo(out.reshape(B, 1, H * hd).to(cfg.dtype)), (k, v)


@torch.no_grad()
def _eager_decode_rows(s: Sampler, tokens_t, cond_t, cache, pos):
    """``Sampler.decode_rows`` as the eager modules composed it: each
    block's norms as ``RMSNorm`` modules after separate residual adds, the
    feed-forward's ``forward``, the rows stacked and stored by
    ``_store``."""
    row_t = pos.reshape(1).to(torch.int32)
    freqs = s.freqs_cis.index_select(0, pos.reshape(1))
    tok_emb = s.tok_embeddings(tokens_t)
    h = torch.cat([cond_t.to(tok_emb.dtype), tok_emb], dim=-1)
    ks, vs = [], []
    for layer, *cache_layer in zip(s.layers,
                                   *(cache[n] for n in s.cache_names)):
        x = layer.attention_norm(h)
        if isinstance(layer.attention, Attention):
            a, (k, v) = _eager_attention(layer.attention, x, freqs,
                                         tuple(cache_layer), row_t,
                                         cache.get("chunk_starts"))
        else:
            a, (k, v) = layer.attention.decode(x, freqs, tuple(cache_layer),
                                               row_t)
        h = h + a
        h = h + layer.feed_forward(layer.ffn_norm(h))
        ks.append(k)
        vs.append(v)
    return (s._logits(h)[:, :, 0, :],
            s._store(torch.stack(ks), torch.stack(vs)))


@pytest.mark.parametrize("name", sorted(SAMPLERS))
@torch.no_grad()
def test_decode_rows_equals_the_eager_composition(name):
    s = _sampler(name)
    cfg = s.cfg
    B, T = 3, 7
    g = _gen(12)
    tokens = torch.randint(0, cfg.d_codebook + 1, (B, cfg.num_codebooks, T),
                           generator=g)
    feats = torch.randn(B, 4, cfg.cond_in_dim, generator=g)
    cond = s.build_cond_seq(s.embed_cond(feats), T, 2)
    fused, eager = s.init_cache(B, T), s.init_cache(B, T)
    for p in range(T):
        pos = torch.tensor(p)
        args = (tokens[:, :, p:p + 1], cond[:, p:p + 1])
        got = s.decode_rows(*args, fused, pos)
        want = _eager_decode_rows(s, *args, eager, pos)
        _equal(got[:1], want[:1])
        assert list(got[1]) == list(want[1])
        _equal(list(got[1].values()), list(want[1].values()))
        s.commit_rows(fused, got[1], pos)
        s.commit_rows(eager, want[1], pos)


class _Calls(TorchDispatchMode):
    """The decode block's operators a region issues, by name."""

    def __init__(self):
        super().__init__()
        self.calls = dict.fromkeys(OPS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name().split("::")[-1].split(".")[0]
        if func.namespace == "vaura_torch" and name in self.calls:
            self.calls[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["llama_int8_cache", "deepseek_v3"])
def test_only_decode_issues_the_fused_operators(name):
    s = _sampler(name)
    cfg = s.cfg
    L, B, T = cfg.num_layers, 2, 5
    g = _gen(13)
    tokens = torch.randint(0, cfg.d_codebook + 1, (B, cfg.num_codebooks, T),
                           generator=g)
    feats = torch.randn(B, 4, cfg.cond_in_dim, generator=g)
    with torch.no_grad():
        cond = s.build_cond_seq(s.embed_cond(feats), T, 2)
        with _Calls() as prefill:
            s.prefill(tokens, cond)
        with _Calls() as decode:
            s.decode_rows(tokens[:, :, :1], cond[:, :1], s.init_cache(B, T),
                          torch.tensor(0))
    with _Calls() as forward:
        s.forward(tokens, feats, train=not cfg.deepseek)
    assert prefill.calls == forward.calls == dict.fromkeys(OPS, 0)
    assert decode.calls == {"rmsnorm": 1, "add_rmsnorm": 2 * L,
                            "rope_qkv_store": 0 if cfg.mla else L,
                            "swiglu": L}


# ------------------------------------------------------------ on the card --
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels build and run only "
                    "there")
    return torch.device("cuda")


def _max_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    itype = torch.int32 if a.dtype == torch.float32 else torch.int16
    top = (1 << 31) - 1 if a.dtype == torch.float32 else (1 << 15) - 1

    def ordered(t):
        bits = t.contiguous().view(itype).long()
        return torch.where(bits < 0, -(bits & top), bits)
    return int((ordered(a) - ordered(b)).abs().max())


@pytest.mark.card
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("op", OPS)
def test_kernel_equals_its_plain_path_on_the_card(card, op, width):
    x = _randn(ROWS, 1, width, seed=1, scale=2.0).to(card)
    a = _randn(ROWS, 1, width, seed=2).to(card)
    if op in ("rmsnorm", "add_rmsnorm"):
        w = torch.empty(width).uniform_(0.5, 1.5, generator=_gen(3)).to(card)
        if op == "rmsnorm":
            got = (torch.ops.vaura_torch.rmsnorm(x, w, 1e-5),)
            want = (db.rmsnorm_plain(x, w, 1e-5),)
        else:
            got = torch.ops.vaura_torch.add_rmsnorm(x, a, w, 1e-5)
            want = db.add_rmsnorm_plain(x, a, w, 1e-5)
        _equal(got[:-1], want[:-1])  # h: the add, bit for bit
        assert _max_ulps(got[-1], want[-1]) <= 1  # the sum's order
        return
    if op == "swiglu":
        _equal((torch.ops.vaura_torch.swiglu(x, a),),
               (db.swiglu_plain(x, a),))
        return
    H, hd = HEADS[width]
    qkv = _randn(ROWS, 1, 3 * H * hd, seed=4, scale=2.0).to(card)
    cs = _rope_row(hd, 37).to(card)
    bufs = [[t.to(card) for t in _rows_buffers(3, ROWS, H, hd)]
            for _ in range(2)]
    got = torch.ops.vaura_torch.rope_qkv_store(qkv, cs, H, H, *bufs[0], 1)
    want = db.rope_qkv_store_plain(qkv, cs, H, H, *bufs[1], layer=1)
    _equal((*got, *bufs[0]), (*want, *bufs[1]))


@pytest.mark.card
def test_launch_counters_a_llama_step_on_the_card(card):
    s = _sampler("llama_int8_cache", device=card, num_layers=24)
    B, T = 2, 4
    cache = s.init_cache(B, T)
    tokens = torch.zeros(B, s.cfg.num_codebooks, 1, dtype=torch.long,
                         device=card)
    cond = torch.zeros(B, 1, s.cfg.cond_dim, device=card)
    before = dict(db.launches)
    with torch.no_grad():
        s.decode_step(tokens, cond, cache, 0)
    torch.cuda.synchronize()
    assert {k: db.launches[k] - before[k] for k in before} == {
        "add_rmsnorm": 49, "rope_qkv_store": 24, "swiglu": 24}
