"""The port's greedy generation in the last sampler modes (the int4 KV
cache, the int8 x int8 attention products, both) against ``vaura_tpu``'s
with a prompt through ``prefill`` (``generate``) and over the rolling cache
of ``generate_long_kv`` with a sink chunk, on the tiny float32 system of
``tests/test_system.py`` (RoPE table of 128 positions for the long run).

Codes must match token for token. Under ``int8_dots`` the quantization
groups are the chunks the JAX package builds its decode steps with: after a
prompt, ``chunk_bounds`` from the first generated step; in the rolling
cache, the kept chunks (sink first, then the window), which the port keeps
packed in one buffer and hands over as those chunks' first rows."""

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
from vaura_tpu_torch.models.sampler import Sampler as TSampler
from vaura_tpu_torch.models.vaura import VauraSystem as TSystem
from vaura_tpu_torch.models.vaura import chunk_bounds

MODES = {"int4": dict(cache_bits=4), "dots": dict(int8_dots=True),
         "int4_dots": dict(cache_bits=4, int8_dots=True)}
J_LONG = dataclasses.replace(J_SAMPLER, block_size_audio=128)
MAX_NEW, PROMPT = 40, 20  # the prompt's first generated step is 21: prefill
KV = dict(total_tokens=76, window_chunks=2, chunk_steps=16, sink_chunks=1)


@pytest.fixture(scope="module")
def systems():
    jsys, tree = init_jax_system(seed=0, sampler_config=J_LONG)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    state = from_jax_params(tree)
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((2, 3, 4, 24)).astype(np.float32)
    vis = rng.standard_normal((2, 8, 24)).astype(np.float32)

    def pair(mode):
        extra = dict(quantize_cache=True, **MODES[mode])
        j = dataclasses.replace(jsys, sampler_config=dataclasses.replace(
            J_LONG, **extra))
        t = TSystem(port_sampler_config(J_LONG, **extra), port_dac_config(),
                    port_encoder_config(), device=CPU)
        return j, t.load_state_dicts(state)

    return pair, jparams, feats, vis


def _spy_starts(monkeypatch):
    """Record the chunk starts of every decode segment JAX builds and the
    ``chunk_starts`` of every cache the port steps with."""
    seen = {"jax": [], "port": []}
    build = JSystem.build_generation_step

    def record(self, *a, chunk_starts=None, **k):
        seen["jax"].append(chunk_starts)  # traced in the rolling path
        return build(self, *a, chunk_starts=chunk_starts, **k)

    monkeypatch.setattr(JSystem, "build_generation_step", record)
    step = TSampler.decode_rows

    def spy(self, tokens_t, cond_t, cache, pos, row=None):
        starts = cache.get("chunk_starts")
        seen["port"].append(None if starts is None
                            else tuple(starts.tolist()))
        return step(self, tokens_t, cond_t, cache, pos, row)

    monkeypatch.setattr(TSampler, "decode_rows", spy)
    return seen


@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_generation_with_a_long_prompt_matches_jax(systems,
                                                          monkeypatch, mode):
    """The prompt's K/V through ``prefill`` into the quantized cache, then
    the decode loop from step 21 over the chunks JAX makes from there."""
    pair, jp, _, vis = systems
    jsys, tsys = pair(mode)
    seen = _spy_starts(monkeypatch)
    prompt = np.random.default_rng(1).integers(
        0, J_SAMPLER.d_codebook, (2, J_SAMPLER.num_codebooks, PROMPT)
    ).astype(np.int32)
    kw = dict(max_new_tokens=MAX_NEW, use_sampling=False, cfg_scale=3.0,
              decode_to_audio=False, decode_buckets=8)
    want = jsys.generate(jp, None, jax.random.PRNGKey(0),
                         vis_feats=jnp.asarray(vis),
                         audio_prompt_codes=jnp.asarray(prompt),
                         **kw)["codes"]
    got = tsys.generate(vis_feats=torch.from_numpy(vis),
                        audio_prompt_codes=torch.from_numpy(prompt),
                        check=True, **kw)["codes"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[..., :PROMPT].numpy(), prompt)
    _, _, S = tsys.prepare_generation(MAX_NEW)
    first = tsys.pattern_provider.get_pattern(MAX_NEW) \
        .get_first_step_with_timesteps(PROMPT)
    assert len(seen["port"]) == S - first  # the steps after the prefill
    if MODES[mode].get("int8_dots"):
        jax_starts = tuple(int(c) for c in seen["jax"][-1])
        assert set(seen["port"]) == {jax_starts}
        assert list(jax_starts) == chunk_bounds(S, 8, first)[:-1]
    else:
        assert set(seen["port"]) == {None}


@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_generate_long_kv_with_a_sink_matches_jax(systems,
                                                         monkeypatch, mode):
    """The rolling cache with one sink chunk and a window of two, chunks
    dropping: the port's groups are the kept chunks' rows in its packed
    buffer (padded with the buffer's length to the most any segment
    keeps), JAX's the kept chunk buffers."""
    pair, jp, feats, _ = systems
    jsys, tsys = pair(mode)
    seen = _spy_starts(monkeypatch)
    kw = dict(KV, tokens_per_frame=7, use_sampling=False, cfg_scale=1.0,
              decode_to_audio=False)
    want = jsys.generate_long_kv(jp, None, jax.random.PRNGKey(0),
                                 vis_feats_segments=jnp.asarray(feats),
                                 **kw)["codes"]
    got = tsys.generate_long_kv(vis_feats_segments=torch.from_numpy(feats),
                                check=True, **kw)["codes"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if not MODES[mode].get("int8_dots"):
        assert set(seen["port"]) == {None}
        return
    _, _, S = tsys.prepare_generation(KV["total_tokens"])
    eff, bounds, kept = TSystem.rolling_cache_plan(
        S, KV["chunk_steps"], KV["window_chunks"], KV["sink_chunks"])
    rows = max(sum(bounds[i + 1] - bounds[i] for i in k) for k in kept)
    want_starts = []
    for k in kept:  # the kept chunks packed in order, then the padding
        starts = [sum(bounds[i + 1] - bounds[i] for i in k[:n])
                  for n in range(len(k))]
        want_starts.append(tuple(starts + [rows] * (3 - len(starts))))
    lo = 1
    for j, hi in enumerate(eff):
        assert set(seen["port"][lo - 1:hi - 1]) == {want_starts[j]}, j
        lo = hi
