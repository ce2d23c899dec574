"""The port's codebook patterns (``vaura_tpu_torch/ops/patterns.py``)
against ``vaura_tpu/ops/patterns.py``: every provider's layout for several
T, resolved from both target spellings, and the build/revert round trip;
then greedy generation on the tiny float32 system of
``tests/test_torch_system.py`` with ``UnrolledPatternProvider`` and
``VALLEPattern``, token for token against JAX's, and with
``MusicLMPattern``, whose default groups of 2 do not divide the tiny
system's 3 codebooks: there JAX's ``generate`` raises ``IndexError`` and so
must the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (
    CPU,
    init_jax_system,
    port_dac_config,
    port_encoder_config,
    port_sampler_config,
)

from vaura_tpu.ops import patterns as J
from vaura_tpu_torch.config import instantiate_from_config
from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.models.vaura import VauraSystem as TSystem
from vaura_tpu_torch.ops import patterns as T

PROVIDERS = [
    ("DelayedPatternProvider", {"n_q": 4}),
    ("DelayedPatternProvider", {"n_q": 4, "delays": [0, 2, 2, 5]}),
    ("DelayedPatternProvider", {"n_q": 3, "flatten_first": 2}),
    ("DelayedPatternProvider", {"n_q": 3, "empty_initial": 2}),
    ("DelayedPatternProvider", {"n_q": 3, "delays": [0, 1, 3],
                                "flatten_first": 3, "empty_initial": 1}),
    ("ParallelPatternProvider", {"n_q": 3}),
    ("UnrolledPatternProvider", {"n_q": 4}),
    ("UnrolledPatternProvider", {"n_q": 4, "flattening": [0, 1, 1, 3],
                                 "delays": [0, 2, 2, 3]}),
    ("UnrolledPatternProvider", {"n_q": 3, "flattening": [0, 0, 1]}),
    ("VALLEPattern", {"n_q": 4}),
    ("VALLEPattern", {"n_q": 4, "delays": [0, 1, 3]}),
    ("MusicLMPattern", {"n_q": 4}),
    ("MusicLMPattern", {"n_q": 6, "group_by": 3}),
]
IDS = [f"{n}-{i}" for i, (n, _) in enumerate(PROVIDERS)]


@pytest.mark.parametrize("name,params", PROVIDERS, ids=IDS)
def test_layouts_match_jax(name, params):
    j = getattr(J, name)(**params)
    for prefix in ("vaura_tpu.ops.patterns", "models.modules.misc."
                   "codebook_patterns"):
        t = instantiate_from_config({"target": f"{prefix}.{name}",
                                     "params": params})
        assert type(t) is getattr(T, name)
        assert isinstance(t, T.CodebooksPatternProvider)
    for steps in (1, 2, 5, 11):
        pj, pt = j.get_pattern(steps), t.get_pattern(steps)
        assert pt.layout == pj.layout, steps
        assert pt.num_sequence_steps == pj.num_sequence_steps
        assert pt.max_delay == pj.max_delay
        for keep in (False, True):
            for a, b in zip(pt._build_seq_tables(steps, keep),
                            pj._build_seq_tables(steps, keep)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,params", PROVIDERS, ids=IDS)
def test_build_revert_round_trip(name, params):
    t = getattr(T, name)(**params)
    steps, K = 7, params["n_q"]
    z = torch.randint(0, 16, (2, K, steps), generator=torch.Generator()
                      .manual_seed(0))
    pattern = t.get_pattern(steps)
    seq, _, mask = pattern.build_pattern_sequence(z, special_token=99)
    assert seq.shape == (2, K, len(pattern.layout))
    assert bool((seq[:, torch.from_numpy(~mask)] == 99).all())
    back, _, rmask = pattern.revert_pattern_sequence(seq, special_token=99)
    assert rmask.all()
    assert torch.equal(back, z)
    # the same sequence through the JAX package's revert
    jback, _, _ = getattr(J, name)(**params).get_pattern(
        steps).revert_pattern_sequence(jnp.asarray(seq.numpy()), 99)
    np.testing.assert_array_equal(np.asarray(jback), z.numpy())


def test_invalid_providers_raise():
    with pytest.raises(ValueError):
        T.DelayedPatternProvider(3, delays=[0, 2, 1])
    with pytest.raises(ValueError):
        T.UnrolledPatternProvider(3, flattening=[0, 0, 1], delays=[0, 1, 1])
    with pytest.raises(ValueError):
        T.VALLEPattern(3, delays=[0])


MAX_NEW = 12


@pytest.fixture(scope="module")
def system():
    jsys, tree = init_jax_system(seed=0)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    frames = np.random.default_rng(0).standard_normal(
        (2, 2, 3, 4, 16, 16)).astype(np.float32)
    vis_feats = jax.jit(jsys.visual_features)(jparams, jnp.asarray(frames))
    return jsys, jparams, tree, frames, vis_feats


@pytest.mark.parametrize("name,raises", [
    ("UnrolledPatternProvider", None), ("VALLEPattern", None),
    ("MusicLMPattern", IndexError)])
def test_greedy_generation_matches_jax(system, name, raises):
    import dataclasses

    jsys, jparams, tree, frames, vis_feats = system
    n_q = jsys.sampler_config.num_codebooks
    jsys = dataclasses.replace(jsys, pattern_provider=getattr(J, name)(n_q))
    tsys = TSystem(port_sampler_config(), port_dac_config(),
                   port_encoder_config(), device=CPU,
                   pattern_provider=getattr(T, name)(n_q))
    tsys.load_state_dicts(from_jax_params(tree))
    kw = dict(max_new_tokens=MAX_NEW, use_sampling=False, cfg_scale=3.0,
              decode_to_audio=False)
    run_jax = lambda: jsys.generate(jparams, None, jax.random.PRNGKey(0),
                                    vis_feats=vis_feats, decode_buckets=1,
                                    **kw)
    if raises is not None:
        with pytest.raises(raises):
            run_jax()
        with pytest.raises(raises):
            tsys.generate(torch.from_numpy(frames), **kw)
        return
    want = run_jax()
    got = tsys.generate(torch.from_numpy(frames), check=True, **kw)
    codes = got["codes"].numpy()
    assert codes.shape == (2, n_q, MAX_NEW)
    np.testing.assert_array_equal(codes, np.asarray(want["codes"]))
