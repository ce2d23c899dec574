"""A CPU model, in plain torch, of how the int8 x int8 decode kernel's
cluster form (``vaura_tpu_torch/csrc/decode_attention.cu::dots_kernel``)
splits one (batch row, KV head) over the blocks of a cluster: each rank's
rows (its 64-row tiles rank, rank + cluster, ... below the rows the launch
covers), its partial max and sum, the whole sequence's M and Z from the
partials in rank order, each group's max of ``p * v_scale`` merged across
ranks, p8 with the group's scale, and the exact int32 group sums added
across ranks. The model is held against the port's plain version
(``_plain_dots``) and against the JAX package's ``int8_dots`` einsums (its
attention layer with identity projections,
``tests/test_torch_sampler_quant_modes.py::_attention_pair``).

Tolerance: the card check's allowance (``chip_smoke.py``): every output
within ``TOL_DECODE`` = 1e-2 of the reference (a probability on the
half-way point of its int8 step may round the other way when Z is summed in
another order; that moves an output by one p8 step, below 1e-2 here), and
the model at least ``DOTS_SEPARATION`` = 10 times closer to the reference
on average than the control, the plain version in one group instead of the
given ones (a model that lost the groups would sit on the control)."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_sampler_quant_modes import _attention_pair, tatt_freqs
from torch_port_util import J_SAMPLER

from vaura_tpu_torch.models.vaura import chunk_bounds
from vaura_tpu_torch.ops import decode_attention as da
from vaura_tpu_torch.ops.quantization import quantize_rows, unpack_int4

TOL_DECODE = 1e-2
DOTS_SEPARATION = 10.0
HD = 32
FLAGSHIP_GROUPS = chunk_bounds(230, 8)[:-1]  # [0, 31, 63, 87, ...]


def cluster_split(q, k8, v8, k_cur, v_cur, pos, k_scale, v_scale, starts,
                  pos_on_device=True):
    """The cluster form's arithmetic over ``launch_plan``'s ranks; ``k8`` /
    ``v8`` int8 values ``[B, S, H_kv, hd]`` (an int4 cache unpacked).
    Returns the float32 output ``[B, H, hd]`` and what each rank held."""
    B, H, hd = q.shape
    S, Hkv = k8.shape[1], k8.shape[2]
    rep = H // Hkv
    rp = lambda t, dim: t.repeat_interleave(rep, dim)
    plan = da.launch_plan(S, pos, pos_on_device)
    cs = plan["cluster"]
    lim = min(S, plan["tiles"] * da.TILE)
    scale = hd ** -0.5
    q8, q_s = quantize_rows(q)
    self_s = (q.float() * rp(k_cur.float(), 1)).sum(-1) * scale  # [B, H]
    kc, vc = rp(k8.to(torch.int32), 2), rp(v8.to(torch.int32), 2)
    ks, vs = rp(k_scale.float(), 2), rp(v_scale.float(), 2)      # [B, S, H]

    # each rank's rows: its tiles below lim, the arithmetic on those below pos
    ranks = []
    for r in range(cs):
        rows = [t for T in range(r, -(-lim // da.TILE), cs)
                for t in range(T * da.TILE, min(T * da.TILE + da.TILE, lim))]
        rows = torch.tensor([t for t in rows if t < pos], dtype=torch.long)
        dots = (q8.to(torch.int32)[:, None] * kc[:, rows]).sum(-1)  # [B, n, H]
        s = (dots.float() * (scale * q_s)[:, None] * ks[:, rows]).transpose(1, 2)
        if len(rows):
            m = s.amax(-1)
            l = torch.exp(s - m[..., None]).sum(-1)
        else:
            m = torch.full((B, H), -math.inf)
            l = torch.zeros(B, H)
        ranks.append({"rows": rows, "scores": s, "m": m, "l": l})

    # the whole sequence's M and Z from the partials in rank order
    M = self_s.clone()
    for rk in ranks:
        M = torch.maximum(M, rk["m"])
    Z = torch.zeros(B, H)
    for rk in ranks:
        if len(rk["rows"]):
            Z = Z + rk["l"] * torch.exp(rk["m"] - M)
    Z = Z + torch.exp(self_s - M)

    # p * v_scale per rank, each group's max merged across ranks
    bounds = da.group_bounds(starts, pos)
    gmax = torch.zeros(B, H, len(bounds))
    for rk in ranks:
        rk["pc"] = (torch.exp(rk["scores"] - M[..., None]) / Z[..., None]
                    * vs[:, rk["rows"]].transpose(1, 2))
        for g, (lo, hi) in enumerate(bounds):
            sel = (rk["rows"] >= lo) & (rk["rows"] < hi)
            if sel.any():
                gmax[..., g] = torch.maximum(gmax[..., g],
                                             rk["pc"][..., sel].amax(-1))
    p_s = (gmax / 127).clamp_min(1e-8)

    # p8 with the group's scale, exact int32 sums per rank, added across ranks
    acc = torch.zeros(B, H, len(bounds), hd, dtype=torch.int64)
    for rk in ranks:
        rk["groups"] = set()
        for g, (lo, hi) in enumerate(bounds):
            sel = (rk["rows"] >= lo) & (rk["rows"] < hi)
            if not sel.any():
                continue
            rk["groups"].add(g)
            p8 = torch.round(rk["pc"][..., sel] / p_s[..., g:g + 1]).clamp(
                -127, 127).to(torch.int64)                          # [B, H, n]
            v = vc[:, rk["rows"][sel]].to(torch.int64)              # [B, n, H, hd]
            acc[:, :, g] += (p8[..., None] * v.transpose(1, 2)).sum(2)
    assert acc.abs().max() < 2 ** 31  # the kernel's int32 sums do not overflow
    out = torch.zeros(B, H, hd)
    for g in range(len(bounds)):
        out = out + acc[:, :, g].float() * p_s[..., g:g + 1]
    out = out + (torch.exp(self_s - M) / Z)[..., None] * rp(v_cur.float(), 1)
    return out, {"ranks": ranks, "bounds": bounds}


def _inputs(seed, S, H, Hkv, bits):
    rng = np.random.default_rng(seed)
    width = HD // 2 if bits == 4 else HD
    lo = -128 if bits == 4 else -127  # every byte a valid pair of nibbles
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    i8 = lambda: torch.from_numpy(
        rng.integers(lo, 128, (2, S, Hkv, width)).astype(np.int8))
    sc = lambda: torch.from_numpy(
        rng.uniform(0.005, 0.05, (2, S, Hkv)).astype(np.float32))
    return dict(q=f(2, H, HD), k=i8(), v=i8(), k_cur=f(2, Hkv, HD),
                v_cur=f(2, Hkv, HD), k_scale=sc(), v_scale=sc())


def _model(x, pos, starts, bits, pos_on_device=True):
    unpack = unpack_int4 if bits == 4 else (lambda t: t)
    return cluster_split(x["q"], unpack(x["k"]), unpack(x["v"]), x["k_cur"],
                         x["v_cur"], pos, x["k_scale"], x["v_scale"], starts,
                         pos_on_device)


def _plain(x, pos, starts, bits):
    return da.decode_attention_plain(
        x["q"], x["k"], x["v"], x["k_cur"], x["v_cur"], pos, x["k_scale"],
        x["v_scale"], cache_bits=bits, int8_dots=True,
        chunk_starts=torch.tensor(starts, dtype=torch.int32))


class _Hold:
    """Every output within TOL_DECODE of its reference; over all calls, the
    model on average at least DOTS_SEPARATION times closer to the
    references than the controls are."""

    def __init__(self):
        self.own = self.ctl = 0.0

    def __call__(self, got, want, control):
        diff = (got - want).abs()
        assert float(diff.max()) <= TOL_DECODE
        self.own += float(diff.mean())
        self.ctl += float((control - want).abs().mean())

    def separated(self):
        assert self.ctl > 0 and DOTS_SEPARATION * self.own < self.ctl, (
            self.own, self.ctl)


CASES = {
    # the flagship's cache and its 8 groups (some straddle two ranks' tiles);
    # pos in device memory: 4 ranks over S + 1 rows, most of them idle at a
    # small pos
    "flagship": dict(S=230, H=4, Hkv=4, starts=FLAGSHIP_GROUPS,
                     positions=[0, 1, 30, 63, 64, 65, 100, 128, 229, 230]),
    "gqa_rep4": dict(S=230, H=8, Hkv=2, starts=FLAGSHIP_GROUPS,
                     positions=[0, 31, 64, 150, 230]),
    # more tiles than a cluster: ranks walk two tiles each
    "s1024": dict(S=1024, H=4, Hkv=4, starts=[0, 100, 513],
                  positions=[0, 64, 511, 512, 513, 1000, 1024]),
}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_cluster_split_matches_plain_dots(case, bits):
    c = CASES[case]
    x = _inputs(len(case) + bits, c["S"], c["H"], c["Hkv"], bits)
    hold = _Hold()
    for pos in c["positions"]:
        got, _ = _model(x, pos, c["starts"], bits)
        want = _plain(x, pos, c["starts"], bits)
        if pos == 0:  # no cache row: the current position alone
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
            continue
        hold(got, want, _plain(x, pos, [0], bits))
    hold.separated()


@pytest.mark.parametrize("bits", [8, 4])
def test_host_pos_split_matches_device_pos_split(bits):
    """With ``pos`` on the host the cluster is as large as pos needs; the
    rows each rank holds below pos are the same, so the two splits agree
    (here to float rounding: torch sums the masked rows in other blocks)."""
    c = CASES["flagship"]
    x = _inputs(3, c["S"], c["H"], c["Hkv"], bits)
    for pos in c["positions"]:
        host, hd_ = _model(x, pos, c["starts"], bits, pos_on_device=False)
        dev, dd = _model(x, pos, c["starts"], bits)
        assert len(hd_["ranks"]) <= len(dd["ranks"])
        for a, b in zip(hd_["ranks"], dd["ranks"]):
            assert torch.equal(a["rows"], b["rows"])
        torch.testing.assert_close(host, dev, rtol=1e-6, atol=1e-6)


def test_the_cases_cover_the_split():
    """Groups that straddle ranks, ranks with no row below pos (and idle
    ranks of a cluster larger than pos needs), ranks walking several tiles,
    pos 0 and pos S all occur in ``CASES``."""
    x = _inputs(0, 230, 4, 4, 8)
    _, d = _model(x, 100, FLAGSHIP_GROUPS, 8)
    owners = {}
    for r, rk in enumerate(d["ranks"]):
        for g in rk["groups"]:
            owners.setdefault(g, set()).add(r)
    assert any(len(o) > 1 for o in owners.values())           # straddling
    assert any(len(rk["rows"]) == 0 for rk in d["ranks"])     # idle ranks
    x = _inputs(0, 1024, 4, 4, 8)
    _, d = _model(x, 1024, [0, 100, 513], 8)
    assert len(d["ranks"]) == da.MAX_CLUSTER
    assert all(len(rk["rows"]) == 2 * da.TILE for rk in d["ranks"])
    assert all(0 in c["positions"] for c in CASES.values())
    assert all(c["S"] in c["positions"] for c in CASES.values())


def _jax_attention(cfg, x, pos, starts):
    """JAX's attention layer (identity projections: q, k and v are ``x``'s
    own values, bit for bit on both sides) over the cache split into chunk
    buffers at ``starts``; returns its output as ``[B, H, hd]``."""
    jatt, jparams, _ = _attention_pair(cfg)
    S = x["k"].shape[1]
    names = ("k", "v", "k_scale", "v_scale")
    edges = list(starts) + [S]
    chunks = tuple(tuple(jnp.asarray(x[n][:, a:b].numpy()) for n in names)
                   for a, b in zip(edges[:-1], edges[1:]))
    masks = tuple(None for _ in starts[1:]) + (
        starts[-1] + jnp.arange(S - starts[-1]) < pos,)
    xin = x["q"].reshape(x["q"].shape[0], 1, -1).numpy()
    out, _ = jatt.apply({"params": jparams}, jnp.asarray(xin),
                        jnp.asarray(np.asarray(tatt_freqs(cfg))), None, chunks,
                        jnp.int32(pos), False, masks)
    return torch.from_numpy(np.array(out)).reshape(x["q"].shape)


JAX_CASES = {
    "flagship": dict(S=230, H=4, Hkv=4, starts=FLAGSHIP_GROUPS,
                     positions=[207, 229, 230]),
    "gqa_rep4": dict(S=230, H=8, Hkv=2, starts=FLAGSHIP_GROUPS,
                     positions=[210, 230]),
    "s1024": dict(S=1024, H=4, Hkv=4, starts=[0, 100, 513],
                  positions=[513, 1000, 1024]),
}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", list(JAX_CASES))
def test_cluster_split_matches_jax_int8_dots(case, bits):
    """The model against the JAX package's ``int8_dots`` einsums: its
    attention layer on the same q, current k/v and chunked cache (pos in the
    last chunk, as the JAX decode loop has it)."""
    c = JAX_CASES[case]
    cfg = dataclasses.replace(
        J_SAMPLER, d_model=c["H"] * HD, nhead=c["H"], n_kv_head=c["Hkv"],
        block_size_audio=c["S"] + 8, quantize_cache=True, int8_dots=True,
        cache_bits=bits)
    x = _inputs(7 + bits, c["S"], c["H"], c["Hkv"], bits)
    # identity projections: k and v of the current position are q's first
    # H_kv heads
    x["k_cur"] = x["q"][:, :c["Hkv"]].clone()
    x["v_cur"] = x["q"][:, :c["Hkv"]].clone()
    hold = _Hold()
    for pos in c["positions"]:
        got, _ = _model(x, pos, c["starts"], bits)
        want = _jax_attention(cfg, x, pos, c["starts"])
        hold(got, want, _jax_attention(cfg, x, pos, [0]))
    hold.separated()
