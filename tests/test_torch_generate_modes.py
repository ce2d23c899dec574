"""The port's generation with a long prompt (``Sampler.prefill``) and with
the int8 KV cache against ``vaura_tpu``'s ``VauraSystem.generate`` on the
tiny float32 system of ``tests/test_system.py``, greedy, the same weights
and features on both sides.

Codes must match token for token (greedy decoding over float32 logits that
agree to ~1e-6; ``lm_head`` is random so the argmax is not a tie)."""

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

from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.models.vaura import VauraSystem as TSystem

MAX_NEW = 40
PROMPT = 20  # its first generated step is 21, past step 16: prefill runs


@pytest.fixture(scope="module")
def systems():
    jsys, tree = init_jax_system(seed=0)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    frames = np.random.default_rng(0).standard_normal(
        (2, 2, 3, 4, 16, 16)).astype(np.float32)
    vis_feats = np.array(jax.jit(jsys.visual_features)(
        jparams, jnp.asarray(frames)))
    state = from_jax_params(tree)

    def port(**sampler_extra):
        t = TSystem(port_sampler_config(**sampler_extra), port_dac_config(),
                    port_encoder_config(), device=CPU)
        return t.load_state_dicts(state)

    return jsys, jparams, port, vis_feats


def _prompt(seed=1):
    return np.random.default_rng(seed).integers(
        0, J_SAMPLER.d_codebook, (2, J_SAMPLER.num_codebooks, PROMPT)
    ).astype(np.int32)


@pytest.mark.parametrize("cfg_scale", [1.0, 3.0])
def test_greedy_generation_with_a_long_prompt_matches_jax(systems, cfg_scale):
    jsys, jp, port, vis = systems
    prompt = _prompt()
    kw = dict(max_new_tokens=MAX_NEW, use_sampling=False, cfg_scale=cfg_scale,
              decode_to_audio=False)
    want = jsys.generate(jp, None, jax.random.PRNGKey(0),
                         vis_feats=jnp.asarray(vis),
                         audio_prompt_codes=jnp.asarray(prompt),
                         decode_buckets=1, **kw)["codes"]
    tsys = port()
    got = tsys.generate(vis_feats=torch.from_numpy(vis),
                        audio_prompt_codes=torch.from_numpy(prompt),
                        check=True, **kw)["codes"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[..., :PROMPT].numpy(), prompt)
    cut = tsys.generate(vis_feats=torch.from_numpy(vis),
                        audio_prompt_codes=torch.from_numpy(prompt),
                        remove_prompts=True, **kw)["codes"]
    assert torch.equal(cut, got[..., PROMPT:])


def test_long_prompt_runs_one_prefill_and_the_steps_after_it(systems, monkeypatch):
    _, _, port, vis = systems
    tsys = port()
    calls = {"prefill": 0, "steps": 0}
    prefill, step = tsys.sampler.prefill, tsys.sampler.decode_rows

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tsys.sampler, "prefill", count("prefill", prefill))
    monkeypatch.setattr(tsys.sampler, "decode_rows", count("steps", step))
    _, _, S = tsys.prepare_generation(MAX_NEW)
    first = tsys.pattern_provider.get_pattern(MAX_NEW) \
        .get_first_step_with_timesteps(PROMPT)
    tsys.generate(vis_feats=torch.from_numpy(vis),
                  audio_prompt_codes=torch.from_numpy(_prompt()),
                  max_new_tokens=MAX_NEW, decode_to_audio=False)
    assert calls == {"prefill": 1, "steps": S - first}
    calls.update(prefill=0, steps=0)
    tsys.generate(vis_feats=torch.from_numpy(vis),
                  audio_prompt_codes=torch.from_numpy(_prompt()[..., :10]),
                  max_new_tokens=MAX_NEW, decode_to_audio=False)
    assert calls == {"prefill": 0, "steps": S - 1}  # a short prompt: no prefill


@pytest.mark.parametrize("with_prompt", [False, True])
def test_greedy_generation_with_the_int8_cache_matches_jax(systems, with_prompt):
    jsys, jp, port, vis = systems
    j8 = dataclasses.replace(jsys, sampler_config=dataclasses.replace(
        J_SAMPLER, quantize_cache=True))
    prompt = _prompt(2) if with_prompt else None
    kw = dict(max_new_tokens=MAX_NEW, use_sampling=False, cfg_scale=3.0,
              decode_to_audio=False)
    want = j8.generate(jp, None, jax.random.PRNGKey(0),
                       vis_feats=jnp.asarray(vis), decode_buckets=1,
                       audio_prompt_codes=None if prompt is None
                       else jnp.asarray(prompt), **kw)["codes"]
    tsys = port(quantize_cache=True)
    got = tsys.generate(vis_feats=torch.from_numpy(vis), check=True,
                        audio_prompt_codes=None if prompt is None
                        else torch.from_numpy(prompt), **kw)["codes"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tsys.sampler.init_cache(2, 4)["k"].dtype == torch.int8
