"""The port's greedy generation in the last sampler modes (the int4 KV
cache, the int8 x int8 attention products, both) against ``vaura_tpu``'s
``VauraSystem.generate`` on the tiny float32 system of
``tests/test_system.py``, the same weights and features on both sides, at
``decode_buckets`` 8 and 1 (with a prompt and over the rolling cache:
``tests/test_torch_long_quant_modes.py``).

Codes must match token for token (greedy decoding over float32 logits that
agree to ~1e-6). Under ``int8_dots`` the JAX package quantizes the
attention probabilities per chunk buffer; the port is handed the same
chunks (``chunk_bounds``), held here against the ``chunk_starts`` JAX's
decode loop builds its steps with."""

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

MAX_NEW = 40
MODES = {"int4": dict(cache_bits=4), "dots": dict(int8_dots=True),
         "int4_dots": dict(cache_bits=4, int8_dots=True)}
KW = dict(max_new_tokens=MAX_NEW, use_sampling=False, cfg_scale=3.0,
          decode_to_audio=False)


@pytest.fixture(scope="module")
def systems():
    jsys, tree = init_jax_system(seed=0)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    frames = np.random.default_rng(0).standard_normal(
        (2, 2, 3, 4, 16, 16)).astype(np.float32)
    vis_feats = np.array(jax.jit(jsys.visual_features)(
        jparams, jnp.asarray(frames)))
    state = from_jax_params(tree)

    def pair(mode):
        extra = dict(quantize_cache=True, **MODES[mode])
        j = dataclasses.replace(jsys, sampler_config=dataclasses.replace(
            J_SAMPLER, **extra))
        t = TSystem(port_sampler_config(**extra), port_dac_config(),
                    port_encoder_config(), device=CPU)
        return j, t.load_state_dicts(state)

    return pair, jparams, vis_feats


def _run_both(systems, monkeypatch, mode, buckets, prompt=None):
    """Both systems' greedy codes, with the chunk starts of JAX's last
    decode segment and the ``chunk_starts`` of the port's cache."""
    pair, jp, vis = systems
    jsys, tsys = pair(mode)
    seen = {"jax": None, "port": set()}
    build = JSystem.build_generation_step

    def record(self, *a, chunk_starts=None, **k):
        seen["jax"] = tuple(int(c) for c in chunk_starts)
        return build(self, *a, chunk_starts=chunk_starts, **k)

    monkeypatch.setattr(JSystem, "build_generation_step", record)
    step = TSampler.decode_rows

    def spy(self, tokens_t, cond_t, cache, pos, row=None):
        starts = cache.get("chunk_starts")
        seen["port"].add(None if starts is None else tuple(starts.tolist()))
        return step(self, tokens_t, cond_t, cache, pos, row)

    monkeypatch.setattr(TSampler, "decode_rows", spy)
    want = jsys.generate(jp, None, jax.random.PRNGKey(0),
                         vis_feats=jnp.asarray(vis), decode_buckets=buckets,
                         audio_prompt_codes=None if prompt is None
                         else jnp.asarray(prompt), **KW)["codes"]
    got = tsys.generate(vis_feats=torch.from_numpy(vis), check=True,
                        decode_buckets=buckets,
                        audio_prompt_codes=None if prompt is None
                        else torch.from_numpy(prompt), **KW)["codes"]
    return np.asarray(want), got.numpy(), seen, tsys


@pytest.mark.parametrize("buckets", [8, 1])
@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_generation_matches_jax(systems, monkeypatch, mode, buckets):
    want, got, seen, tsys = _run_both(systems, monkeypatch, mode, buckets)
    np.testing.assert_array_equal(got, want)
    _, _, S = tsys.prepare_generation(MAX_NEW)
    if MODES[mode].get("int8_dots"):
        assert seen["port"] == {seen["jax"]}
        assert list(seen["jax"]) == chunk_bounds(S, buckets)[:-1]
        assert len(seen["jax"]) == (1 if buckets == 1 else len(
            {min(-(-((i + 1) * S) // buckets // 8) * 8, S)
             for i in range(buckets)}))
    else:  # the groups matter only to int8_dots: the port makes none
        assert seen["port"] == {None}
    packed = tsys.sampler.init_cache(2, 4)["k"]
    assert packed.shape[-1] == (tsys.sampler_config.head_dim // 2
                                if mode.startswith("int4")
                                else tsys.sampler_config.head_dim)


@pytest.mark.parametrize("S,buckets,start", [
    (230, 8, 1), (230, 1, 1), (49, 8, 1), (49, 8, 21), (58, 2, 30),
    (64, 8, 1), (100, 3, 57), (230, 8, 200),
])
def test_chunk_bounds(S, buckets, start):
    """Chunk ``j`` holds the rows segment ``j`` writes: segment ends
    rounded up to multiples of 8, the segments before ``start`` dropped."""
    got = chunk_bounds(S, buckets, start)
    assert got[0] == 0 and got[-1] == S and got == sorted(set(got))
    ends = sorted({min(-(-((i + 1) * S) // buckets // 8) * 8, S)
                   for i in range(buckets)})
    eff = [e for e in ends if e > start]
    assert got[1:-1] == [e - 1 for e in eff[:-1]]
    if (S, buckets, start) == (230, 8, 1):  # the flagship's groups
        assert got == [0, 31, 63, 87, 119, 143, 175, 207, 230]


def test_generate_action_keeps_the_int4_cache_under_quantize(tmp_path,
                                                            monkeypatch):
    """``model.sampler_config.params.cache_bits: 4`` in a config reaches the
    port's generate action through ``SamplerSpec`` and ``build_system``, and
    ``quantize=true`` (int8 weights and a quantized cache) keeps it, as the
    JAX action's ``dataclasses.replace`` of the ``quantize_*`` fields does:
    every decode step reads an int4 cache with int8 weights."""
    from vaura_tpu_torch.main import main

    seen = set()
    step = TSampler.decode_rows

    def spy(self, tokens_t, cond_t, cache, pos, row=None):
        seen.add((self.cfg.cache_bits, self.cfg.quantize_weights,
                  self.cfg.quantize_cache, cache["k"].shape[-1]))
        return step(self, tokens_t, cond_t, cache, pos, row)

    monkeypatch.setattr(TSampler, "decode_rows", spy)
    main(["config=configs/experiments/dummy.yaml", "action=generate",
          "duration=0.15", "model_max_duration=0.64",
          "dataloader.batch_size=1", "max_batches=1", "quantize=true",
          "model.sampler_config.params.cache_bits=4",
          "trainer.platform=cpu", f"output_dir={tmp_path}"])
    hd = J_SAMPLER.head_dim
    assert seen == {(4, True, True, hd // 2)}
    assert (tmp_path / "0.wav").exists()
