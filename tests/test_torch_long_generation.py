"""The port's long-horizon generation against ``vaura_tpu``'s on the tiny
float32 system of ``tests/test_system.py`` (RoPE table of 128 positions),
the same weights and per-segment features on both sides: chunked generation
with the prompt carried over (``generate_long``: every chunk after the first
ingests its prompt with ``prefill``), the rolling cache
(``generate_long_kv``, chunks dropping), both streaming generators and the
chunk arithmetic.

Greedy codes must match the JAX package's token for token. Within the port,
the streams' audio increments concatenate to the one-shot waveform within
5e-5 absolute (windowed and full DAC decodes sum in other orders; a missing
margin errs by more than 1e-3, ``tests/test_stream.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (
    CPU,
    J_SAMPLER,
    init_jax_system,
    port_dac_config,
    port_encoder_config,
    port_sampler_config,
)

from vaura_tpu.models.vaura import VauraSystem as JSystem
from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.models.vaura import VauraSystem as TSystem

J_LONG = dataclasses.replace(J_SAMPLER, block_size_audio=128)
LONG = dict(total_tokens=60, stride_tokens=12, model_max_tokens=36)
KV = dict(total_tokens=76, window_chunks=2, chunk_steps=16)
SAMPLED = dict(use_sampling=True, temp=1.0, top_k=8, cfg_scale=3.0)


@pytest.fixture(scope="module")
def systems():
    jsys, tree = init_jax_system(seed=0, sampler_config=J_LONG)
    tsys = TSystem(port_sampler_config(J_LONG), port_dac_config(),
                   port_encoder_config(), device=CPU)
    tsys.load_state_dicts(from_jax_params(tree))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    # per-segment features [B, S_total, t, D]: 3 segments of 4 tokens
    feats = np.random.default_rng(3).standard_normal((2, 3, 4, 24)).astype(
        np.float32)
    return jsys, jparams, tsys, feats


@pytest.mark.parametrize("total,stride,max_tokens", [
    (60, 12, 36), (72, 24, 36), (221, 55, 221), (441, 55, 221),
    (882, 55, 221), (100, 100, 221), (50, 10, 221), (300, 221, 221),
    (7, 3, 5), (1000, 1, 4),
])
def test_long_chunk_schedule_matches_jax(total, stride, max_tokens):
    got = TSystem.long_chunk_schedule(total, stride, max_tokens)
    assert got == JSystem.long_chunk_schedule(total, stride, max_tokens)
    assert sum(got) == total


def test_greedy_generate_long_matches_jax(systems):
    jsys, jp, tsys, feats = systems
    kw = dict(LONG, tokens_per_frame=7, use_sampling=False, cfg_scale=3.0,
              decode_to_audio=False)
    want = jsys.generate_long(jp, None, jax.random.PRNGKey(0),
                              vis_feats_segments=jnp.asarray(feats),
                              decode_buckets=1, **kw)["codes"]
    got = tsys.generate_long(vis_feats_segments=torch.from_numpy(feats),
                             check=True, **kw)
    assert got["codes"].shape == (2, 3, LONG["total_tokens"])
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want))
    assert set(got["stage_ms"]) == {"encoder", "decode_loop"}


@pytest.mark.parametrize("sink_chunks", [0, 1])
def test_greedy_generate_long_kv_with_chunks_dropping_matches_jax(systems,
                                                                  sink_chunks):
    jsys, jp, tsys, feats = systems
    kw = dict(KV, tokens_per_frame=7, sink_chunks=sink_chunks,
              use_sampling=False, cfg_scale=1.0, decode_to_audio=False)
    want = jsys.generate_long_kv(jp, None, jax.random.PRNGKey(0),
                                 vis_feats_segments=jnp.asarray(feats),
                                 **kw)["codes"]
    got = tsys.generate_long_kv(vis_feats_segments=torch.from_numpy(feats),
                                check=True, **kw)["codes"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rolling_cache_plan():
    """S = 79 steps of chunks of 16: chunk 0 holds positions 0..14, the last
    one 63..78; a window of 2 with one sink keeps chunk 0 and the last two."""
    eff, bounds, kept = TSystem.rolling_cache_plan(79, 16, 2, 1)
    assert eff == [16, 32, 48, 64, 79]
    assert bounds == [0, 15, 31, 47, 63, 79]
    assert kept == [[0], [0, 1], [0, 1, 2], [0, 2, 3], [0, 3, 4]]
    _, _, kept0 = TSystem.rolling_cache_plan(79, 16, 2, 0)
    assert kept0 == [[0], [0, 1], [1, 2], [2, 3], [3, 4]]
    for bad in ((79, 12, 2, 0), (79, 16, 0, 0)):
        with pytest.raises(ValueError):
            TSystem.rolling_cache_plan(*bad)


def _flat_window(tsys, feats, total, tokens_per_frame=7):
    """The features ``generate_long_kv`` lays out over the horizon."""
    B, s_total, t_seg, d = feats.shape
    _, _, S = tsys.prepare_generation(total)
    n_feat = -(-S // tokens_per_frame)
    n_seg = -(-n_feat // t_seg)
    return feats[:, np.arange(n_seg) % s_total].reshape(B, n_seg * t_seg, d)


def test_generate_long_kv_without_drops_is_generate(systems):
    """With ``window_chunks * chunk_steps >= S`` nothing drops: the rolling
    decode is ``generate``'s, sampled from the same generator."""
    _, _, tsys, feats = systems
    total = 40
    one = tsys.generate_long_kv(
        vis_feats_segments=torch.from_numpy(feats), total_tokens=total,
        window_chunks=16, chunk_steps=16, tokens_per_frame=7, seed=5,
        decode_to_audio=False, **SAMPLED)["codes"]
    ref = tsys.generate(vis_feats=torch.from_numpy(
        _flat_window(tsys, feats, total)), max_new_tokens=total,
        tokens_per_frame=7, seed=5, decode_to_audio=False, **SAMPLED)["codes"]
    assert torch.equal(one, ref)


def _check_stream(chunks, one, hop):
    assert len(chunks) >= 2  # streamed in pieces
    codes = torch.cat([c["codes"] for c in chunks], dim=-1)
    assert torch.equal(codes, one["codes"])
    audio = torch.cat([c["audio"] for c in chunks], dim=-1)
    want = one["audio"].reshape(audio.shape[0], -1)
    assert audio.shape == want.shape
    torch.testing.assert_close(audio, want, rtol=0, atol=5e-5)
    n = 0
    for c in chunks:  # each increment starts where the previous ended
        assert c["token_start"] * hop == n
        n += c["audio"].shape[-1]


def test_generate_long_stream_matches_generate_long(systems):
    _, _, tsys, feats = systems
    kw = dict(LONG, vis_feats_segments=torch.from_numpy(feats),
              tokens_per_frame=7, seed=3, **SAMPLED)
    one = tsys.generate_long(**kw)
    chunks = list(tsys.generate_long_stream(**kw))
    assert [c["codes"].shape[-1] for c in chunks] == \
        TSystem.long_chunk_schedule(60, 12, 36)
    _check_stream(chunks, one, tsys.dac.cfg.hop_length)


def test_generate_long_kv_stream_matches_generate_long_kv(systems):
    _, _, tsys, feats = systems
    kw = dict(total_tokens=60, window_chunks=2, chunk_steps=16,
              vis_feats_segments=torch.from_numpy(feats), tokens_per_frame=7,
              seed=11, **SAMPLED)
    one = tsys.generate_long_kv(**kw)
    chunks = list(tsys.generate_long_kv_stream(**kw))
    _check_stream(chunks, one, tsys.dac.cfg.hop_length)


def test_generate_long_kv_needs_rope_rows_for_the_horizon(systems):
    _, _, tsys, feats = systems
    with pytest.raises(ValueError, match="block_size"):
        tsys.generate_long_kv(vis_feats_segments=torch.from_numpy(feats),
                              total_tokens=300, decode_to_audio=False)


def test_decoder_receptive_field_matches_jax():
    from vaura_tpu.models.dac.model import DacConfig as JDac

    from torch_port_util import J_DAC

    for jcfg in (J_DAC, JDac()):
        tcfg = dataclasses.replace(port_dac_config(), **{
            f: getattr(jcfg, f) for f in ("decoder_rates", "decoder_dim")})
        assert tcfg.decoder_receptive_field_frames == \
            jcfg.decoder_receptive_field_frames
