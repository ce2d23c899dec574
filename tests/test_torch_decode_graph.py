"""The port's one decode loop (``VauraSystem._device_loop``), which a card
replays from a CUDA graph and which runs eagerly here: the position a 0-d
int64 tensor that the step advances, the sampling's uniform draw made into
one buffer before each step. Through ``generate_tokens`` it must give the
sequence and cache of a plain loop with host ``int`` positions
(``torch_port_util.reference_decode_loop``), token for token and byte for
byte, with every kind of cache, with and without a prefilled prompt; its
draws must be ``uniform_noise``'s, call after call (the benchmark's check
draws them again); and ``generate_tokens`` must record a graph only on a
card without a mesh, with enough steps to repay the recording. On the card
``chip_smoke.py``'s ``decode_graph`` phase holds the replayed codes to the
same loop run eagerly."""

from types import SimpleNamespace

import pytest
import torch
from torch_port_util import reference_decode_loop

from vaura_tpu_torch.models import vaura as V
from vaura_tpu_torch.models.dac.model import DacConfig
from vaura_tpu_torch.models.sampler import SamplerConfig
from vaura_tpu_torch.ops import decode_attention as da
from vaura_tpu_torch.ops.sampling import uniform_noise
from vaura_tpu_torch.utils import seeded_init_

B, N_TOKENS, PROMPT = 2, 24, 20
SAMPLING = dict(use_sampling=True, temp=1.0, top_k=4, top_p=0.0,
                cfg_scale=3.0)
CACHES = {"unquantized": {}, "int8": {"quantize_cache": True},
          "int4": {"quantize_cache": True, "cache_bits": 4},
          "int8_dots": {"quantize_cache": True, "int8_dots": True}}


def tiny_system(**sampler) -> V.VauraSystem:
    cfg = SamplerConfig(num_layers=2, d_model=48, d_codebook=16,
                        num_codebooks=3, nhead=2, cond_in_dim=32,
                        block_size_audio=64, block_size_video=16,
                        dropout=0.0, **sampler)
    dac = DacConfig(encoder_dim=4, decoder_dim=16, n_codebooks=3,
                    codebook_size=16)
    system = V.VauraSystem(cfg, dac, None, device="cpu")
    seeded_init_(system, torch.Generator().manual_seed(0))
    return system.requires_grad_(False)


def loop_inputs(system, prompt: bool):
    """``(cond_seq, gen_seq, valid_mask, S, start_step, initial_cache)`` as
    ``VauraSystem.generate`` makes them; with ``prompt`` the first
    ``PROMPT`` timesteps are given and ingested by ``Sampler.prefill``."""
    pattern, valid_mask, S = system.prepare_generation(N_TOKENS)
    codes = torch.full((B, 3, N_TOKENS), V.UNKNOWN_TOKEN, dtype=torch.long)
    g = torch.Generator().manual_seed(3)
    if prompt:
        codes[:, :, :PROMPT] = torch.randint(0, 16, (B, 3, PROMPT),
                                             generator=g)
    gen_seq, _, _ = pattern.build_pattern_sequence(codes,
                                                   system.special_token_id)
    feats = torch.randn(B, 8, 32, generator=g)
    cond = system.build_cond_seq_for_generation(feats, S, 7, cfg=True)
    start_step, cache = 1, None
    if prompt:
        start_step = pattern.get_first_step_with_timesteps(PROMPT)
        assert start_step > 16
        _, cache = system.sampler.prefill(
            gen_seq.repeat(2, 1, 1).clamp_min(0), cond)
    return cond, gen_seq, valid_mask, S, start_step, cache


def run_loop(system, inputs, reference: bool):
    """``inputs``' steps through ``generate_tokens`` (its one loop, eager
    on the CPU), or (``reference``) through the plain host-int loop on the
    cache ``generate_tokens`` would make. Returns ``(sequence, cache, eager
    steps, replayed steps)``."""
    cond, gen_seq, valid_mask, S, start_step, cache = inputs
    cache = ({k: v.clone() for k, v in cache.items()} if cache is not None
             else system.sampler.init_cache(2 * B, S))
    generator = torch.Generator().manual_seed(5)
    eager, replayed = V.eager_steps, V.replayed_steps
    if reference:
        if system._quantizes_probs():
            cache["chunk_starts"] = torch.tensor(
                V.chunk_bounds(S, 8, start_step)[:-1], dtype=torch.int32)
        seq = reference_decode_loop(system, cache, gen_seq.clone(), cond,
                                    valid_mask, generator,
                                    range(start_step, S), **SAMPLING)
    else:
        seq = system.generate_tokens(
            cond, gen_seq, generator, S=S, valid_mask=valid_mask,
            start_step=start_step, initial_cache=cache, decode_buckets=8,
            **SAMPLING)
    return (seq, cache, V.eager_steps - eager,
            V.replayed_steps - replayed)


@pytest.mark.parametrize(
    "mode,prompt", [(m, p) for p in (False, True) for m in CACHES],
    ids=list(CACHES) + [f"{m}_prompt" for m in CACHES])
def test_device_loop_equals_host_int_loop(mode, prompt):
    system = tiny_system(**CACHES[mode])
    inputs = loop_inputs(system, prompt)
    S, start_step = inputs[3], inputs[4]
    seq_a, cache_a, _, _ = run_loop(system, inputs, True)
    seq_b, cache_b, eager_b, rep_b = run_loop(system, inputs, False)
    assert eager_b == S - start_step and rep_b == 0
    assert (seq_a >= 0).all()
    assert torch.equal(seq_a, seq_b)
    assert cache_a.keys() == cache_b.keys()
    for name in cache_a:
        assert cache_a[name].dtype == cache_b[name].dtype, name
        assert torch.equal(cache_a[name], cache_b[name]), name
    if prompt:  # the prompt's timesteps kept
        assert torch.equal(seq_a[..., :start_step], inputs[1][..., :start_step])


def test_noise_buffer_draw_equals_uniform_noise():
    """The buffer's draw and ``uniform_noise`` on generators seeded alike
    give the same values call after call, other draws between them."""
    shape = (4, 3, 16)
    g_buf = torch.Generator().manual_seed(11)
    g_ref = torch.Generator().manual_seed(11)
    buf = torch.empty(shape)
    for i in range(5):
        buf.uniform_(generator=g_buf)
        want = uniform_noise(shape, g_ref, "cpu")
        assert torch.equal(buf, want), i
        torch.rand(7, generator=g_buf)
        torch.rand(7, generator=g_ref)


def test_device_loop_draws_the_host_loops_noise(monkeypatch):
    """Every step's buffer holds the draw the plain host-int loop makes
    inside ``sample_tokens``."""
    system = tiny_system(quantize_cache=True)
    inputs = loop_inputs(system, False)
    drawn = {False: [], True: []}
    rand = torch.rand
    uniform = torch.Tensor.uniform_

    def record_rand(*a, **kw):
        out = rand(*a, **kw)
        drawn[False].append(out.clone())
        return out

    def record_uniform(t, *a, **kw):
        out = uniform(t, *a, **kw)
        drawn[True].append(out.clone())
        return out

    with monkeypatch.context() as m:
        m.setattr(torch, "rand", record_rand)
        run_loop(system, inputs, True)
    monkeypatch.setattr(torch.Tensor, "uniform_", record_uniform)
    run_loop(system, inputs, False)
    assert len(drawn[False]) == len(drawn[True]) == inputs[3] - 1
    for a, b in zip(drawn[False], drawn[True]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["cpu", "mesh", "few_steps", "card"])
def test_graph_loop_only_on_a_card_without_a_mesh(case):
    system = tiny_system()
    card = {"k": SimpleNamespace(is_cuda=True)}
    steps = V.GRAPH_MIN_STEPS
    if case == "cpu":
        cache = system.sampler.init_cache(2, 8)
        assert not system._replays_steps(cache, 10 ** 6)
        inputs = loop_inputs(system, False)
        eager, replayed = V.eager_steps, V.replayed_steps
        system.generate_tokens(inputs[0], inputs[1], None, S=inputs[3],
                               valid_mask=inputs[2], use_sampling=False,
                               cfg_scale=3.0)
        assert V.eager_steps - eager == inputs[3] - 1
        assert V.replayed_steps == replayed
    elif case == "mesh":
        system.placement = object()
        assert not system._replays_steps(card, 10 ** 6)
    elif case == "few_steps":
        assert not system._replays_steps(card, steps - 1)
    else:
        assert system._replays_steps(card, steps)


def test_replays_count_their_recordings_launches():
    """The launch counters' bookkeeping of a replay: what a recording
    launched, read as a difference of ``_launch_counts``, added back once
    a replay, the forms' dict included."""
    before = V._launch_counts()
    da.launches += 24
    da.device_pos_launches += 24
    da.form_launches["serve"] += 24
    recorded = {k: n - before[k] for k, n in V._launch_counts().items()
                if n != before[k]}
    assert set(recorded.values()) == {24} and len(recorded) == 3
    V._add_launch_counts({k: -n for k, n in recorded.items()})
    assert V._launch_counts() == before
    for _ in range(3):
        V._add_launch_counts(recorded)
    assert da.launches == before[(da, "launches", None)] + 72
    assert da.form_launches["serve"] == before[(da, "form_launches",
                                                "serve")] + 72
    V._add_launch_counts({k: -3 * n for k, n in recorded.items()})
    assert V._launch_counts() == before
