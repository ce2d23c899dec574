"""The port's benchmark (``vaura_tpu_torch/bench.py``) against the repo's
``bench.py`` on the CPU, at the tiny configuration of
``tests/torch_port_util.py``.

* Generate mode's timed function (``make_generate``) with ``--greedy
  --no-dac``, CFG 6.0, batch 2, 12 tokens, on converted float32 weights:
  codes equal, token for token, to JAX's from the same steps as
  ``bench.py``'s inner ``generate`` (``prepare_generation``,
  ``build_cond_seq_for_generation``, the pattern, ``generate_tokens``); with
  the DAC, the checksum ``sum(|audio|)`` within the DAC decode's tolerance
  (1e-4 a sample, ``tests/test_torch_dac.py``) summed over the samples.
* ``resolve_args`` against the resolution of ``bench.py``'s ``main``,
  captured by running it up to the mode's first step.
* Train mode's parameter count and ``train_model_flops`` against the count
  of JAX's ``sampler.init`` leaves and ``bench.py``'s formula.
* Each mode from the command line (``--platform cpu``, a tiny
  ``overrides``) prints one JSON line with JAX's keys and ``device``;
  without ``--platform cpu`` and without CUDA every mode raises.
"""

import argparse
import dataclasses
import json
import math
import sys

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

from vaura_tpu_torch import bench
from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.models.vaura import VauraSystem as TSystem

TOKENS = 12
CFG_SCALE = 6.0
# the tiny geometry of torch_port_util (the flagship's dtypes: bf16 compute)
TINY = {
    "sampler": {f: getattr(J_SAMPLER, f) for f in (
        "num_layers", "d_model", "d_codebook", "num_codebooks", "nhead",
        "block_size_audio", "block_size_video", "cond_in_dim",
        "cond_token_num", "codebook_dim", "dropout")},
    "dac": port_dac_config(),
    "encoder": dict(img_size=16, patch_size=8, embed_dim=24, depth=2,
                    num_heads=2, temporal_resolution=2, z_block_size=2),
    "frames": (2, 3, 4, 16, 16),
    "train_audio_samples": 10 * port_dac_config().hop_length,
}
COMMON = ("metric", "value", "unit", "vs_baseline")
JAX_KEYS = {
    "generate": COMMON + ("quant_mode", "batch"),
    "encoder": COMMON + ("sweep",),
    "long": COMMON + ("duration_s", "stride_s", "long_kv", "batch",
                      "p50_batch_seconds", "p50_latency_per_clip_s"),
    "train": COMMON + ("mfu",),
}


def _args(*argv):
    return bench.resolve_args(bench.build_parser().parse_args(
        [*argv, "--platform", "cpu"]))


@pytest.fixture(scope="module")
def generation():
    """The port's system on converted float32 weights, seeded features and
    JAX's greedy codes and audio from ``bench.py``'s steps."""
    jsys, tree = init_jax_system(seed=0)
    tsys = TSystem(port_sampler_config(), port_dac_config(),
                   port_encoder_config(), device=CPU)
    tsys.load_state_dicts(from_jax_params(tree))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    feats = np.random.default_rng(3).standard_normal(
        (2, bench.FEATURE_ROWS, J_SAMPLER.cond_in_dim)).astype(np.float32)

    pattern, valid_mask, S = jsys.prepare_generation(TOKENS)

    @jax.jit
    def j_codes(params, vis_feats):
        cond_seq = jsys.build_cond_seq_for_generation(
            params, vis_feats, S, tokens_per_frame=7, cfg=True)
        gen_seq = jnp.full((2, J_SAMPLER.num_codebooks, TOKENS), -1,
                           jnp.int32)
        gen_seq, _, _ = pattern.build_pattern_sequence(
            gen_seq, jsys.special_token_id)
        gen_seq = jsys.generate_tokens(
            params, cond_seq, gen_seq, jax.random.PRNGKey(2), S=S,
            valid_mask=valid_mask, use_sampling=False, temp=1.0, top_k=128,
            cfg_scale=CFG_SCALE, decode_buckets=8)
        codes, _, _ = pattern.revert_pattern_sequence(gen_seq, -1)
        return jnp.clip(codes[..., :TOKENS], 0, J_SAMPLER.d_codebook - 1)

    codes = j_codes(jp, jnp.asarray(feats))
    audio = jax.jit(jsys.decode_audio)(jp, codes)
    return tsys, feats, np.asarray(codes), np.asarray(audio)


def test_greedy_generation_matches_jax(generation):
    tsys, feats, want, _ = generation
    args = _args("--greedy", "--no-dac", "--tokens", str(TOKENS),
                 "--batch", "2", "--cfg-scale", str(CFG_SCALE))
    generate = bench.make_generate(tsys, args)
    codes = generate(torch.from_numpy(feats), torch.Generator().manual_seed(2))
    assert codes.shape == (2, J_SAMPLER.num_codebooks, TOKENS)
    assert len(np.unique(want)) > 4  # not a degenerate rollout
    np.testing.assert_array_equal(codes.numpy(), want)


def test_dac_checksum_matches_jax(generation):
    tsys, feats, _, want_audio = generation
    args = _args("--greedy", "--tokens", str(TOKENS), "--batch", "2")
    total = bench.make_generate(tsys, args)(
        torch.from_numpy(feats), torch.Generator().manual_seed(2))
    assert total.ndim == 0 and total.dtype == torch.float32
    want = float(np.abs(want_audio).sum())
    assert want > 0
    assert abs(total.item() - want) <= 1e-4 * want_audio.size


class _Resolved(Exception):
    pass


def _jax_resolution(argv, monkeypatch):
    """The namespace ``bench.py``'s ``main`` resolves from ``argv``, taken
    when the mode starts (before any model is built)."""
    import bench as jbench

    seen = []
    parse = argparse.ArgumentParser.parse_args

    def capture(self, *a, **kw):
        seen.append(parse(self, *a, **kw))
        return seen[-1]

    def stop(*a, **kw):
        raise _Resolved

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        m.setattr(sys, "argv", ["bench.py", *argv])
        for name in ("bench_train", "bench_encoder", "bench_long"):
            m.setattr(jbench, name, stop)
        # generate mode's first step
        m.setattr("vaura_tpu.models.dac.model.config_for_sample_rate", stop)
        with pytest.raises(_Resolved):
            jbench.main()
    return seen[-1]


@pytest.mark.parametrize("argv", [
    [],
    ["--int8"],
    ["--no-int8", "--with-encoder"],
    ["--int8-cache-only", "--with-encoder", "--batch", "64",
     "--decode-buckets", "2"],
    ["--mode", "long"],
    ["--mode", "long", "--int8-cache-only", "--batch", "8",
     "--decode-buckets", "4"],
    ["--mode", "train", "--batch", "12"],
    ["--mode", "train", "--with-encoder"],
    ["--mode", "encoder", "--no-int8", "--decode-buckets", "1"],
])
def test_resolve_args_matches_jax_bench(argv, monkeypatch):
    want = _jax_resolution(argv, monkeypatch)
    got = bench.resolve_args(bench.build_parser().parse_args(argv))
    for key in ("quant_mode", "int8", "int8_cache_only", "batch",
                "decode_buckets", "mode", "with_encoder"):
        assert getattr(got, key) == getattr(want, key), key
    # every flag of bench.py is the port's, with its default
    port = vars(got)
    for key, value in vars(want).items():
        assert key in port and port[key] == value, key


def test_train_count_and_flops_match_jax():
    from vaura_tpu.models.sampler import Sampler as JSampler

    args = _args("--mode", "train", "--batch", "128")
    system, state, _, batch, tokens = bench.build_train(
        args, device=torch.device(CPU), overrides=TINY)
    assert tokens == 10  # codec frames of the tiny clip
    assert {k: tuple(v.shape) for k, v in batch.items()} == {
        "audio": (12, 1, TINY["train_audio_samples"]),
        "vis_feats": (12, bench.FEATURE_ROWS, J_SAMPLER.cond_in_dim)}
    assert all(v.dtype == torch.float32 for v in state.params.values())
    n_params = sum(v.numel() for v in state.params.values())

    jcfg = dataclasses.replace(J_SAMPLER, remat=True)
    shapes = jax.eval_shape(lambda r: JSampler(jcfg).init(
        {"params": r, "dropout": r, "cfg_dropout": r},
        jnp.zeros((1, jcfg.num_codebooks, 16), jnp.int32),
        jnp.zeros((1, 8, jcfg.cond_in_dim)), False)["params"],
        jax.random.PRNGKey(0))
    want_n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert n_params == want_n
    # bench.py:633-639 at B=12, S=221
    B, S = 12, 221
    want = (6 * want_n * B * S
            + 12 * jcfg.num_layers * jcfg.d_model * S * S * B)
    cfg = system.sampler_config
    assert bench.train_model_flops(n_params, cfg.num_layers, cfg.d_model,
                                   B, S) == want


@pytest.mark.parametrize("argv", [
    ["--batch", "2", "--tokens", str(TOKENS)],
    ["--batch", "2", "--tokens", str(TOKENS), "--with-encoder",
     "--int8-encoder", "--encoder-chunk", "1"],
    ["--mode", "long", "--batch", "2", "--duration", "0.5", "--stride",
     "0.16"],
    ["--mode", "long", "--long-kv", "--batch", "2", "--duration", "0.5",
     "--window-chunks", "2", "--chunk-steps", "8", "--no-int8"],
    ["--mode", "train", "--batch", "2"],
    ["--mode", "train", "--batch", "2", "--precomputed-codes",
     "--remat-policy", "dots", "--mu-dtype", "bfloat16"],
    ["--mode", "encoder", "--int8-encoder"],
])
def test_each_mode_prints_one_json_line(argv, capsys):
    out = bench.main([*argv, "--iters", "1", "--platform", "cpu",
                      "--compilation-cache-dir", "unused"], overrides=TINY)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if not ln.startswith("#")]
    assert len(lines) == 1
    printed = json.loads(lines[0])
    assert printed == json.loads(json.dumps(out))
    mode = bench.resolve_args(bench.build_parser().parse_args(argv)).mode
    assert tuple(printed) == JAX_KEYS[mode] + ("device",)
    assert printed["device"] == "cpu"
    assert math.isfinite(printed["value"]) and printed["value"] > 0
    if mode == "train":
        assert printed["mfu"] is None  # no card, no utilisation
    if mode == "encoder":
        assert list(printed["sweep"]) == ["1", "8", "16", "32"]
    if mode == "generate":
        assert printed["metric"] == ("frames_to_audio_sec_per_sec_per_chip"
                                     if "--with-encoder" in argv
                                     else "audio_sec_per_sec_per_chip")


@pytest.mark.parametrize("mode", ["generate", "long", "train", "encoder"])
def test_without_cuda_every_mode_raises(mode, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--mode", mode, "--iters", "1"], overrides=TINY)
