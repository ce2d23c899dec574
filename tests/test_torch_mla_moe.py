"""The DeepSeek-V3 block in the port's sampler (latent attention, routed
experts) against the benchmark's plain float32 reference
(``port_bench/reference/sampler_mla_moe.py``), on seeded weights at a tiny
size on the CPU: d 64, 4 heads, latent 16, rope 8, nope 16, v 16, 8 experts
(top 2) and one shared, layer 0 dense, 3 layers.

Tolerances: the program runs float32 here (``dtype=torch.float32``), so it
and the reference differ only in the order of float32 sums (einsum against
matmul, the absorbed products against ``wkv_b``'s, the grouped products
against the per-expert loop): 1e-4 absolute on logits of about 1-5, some
hundred times float32's rounding of such sums, and far under what one
wrong expert or one dropped position moves (checked by the fault cases).
"""

from __future__ import annotations

import dataclasses

import pytest
import torch
from torch_port_util import reference_decode_loop

from port_bench import weights as W
from port_bench.reference import dac as ref_dac
from port_bench.reference import sampler_mla_moe as ref
from vaura_tpu_torch.models.dac.model import DacSpec
from vaura_tpu_torch.models.sampler import (
    PORT_ONLY_FIELDS,
    MoEFeedForward,
    Sampler,
    SamplerConfig,
    SamplerSpec,
)
from vaura_tpu_torch.models.vaura import VauraSystem

CFG = dict(num_layers=3, d_model=64, nhead=4, d_codebook=32, num_codebooks=3,
           cond_in_dim=16, cond_token_num=8, block_size_audio=64,
           block_size_video=16, cond_feature_channel_scaler=3, dropout=0.0,
           rope_base=50000.0, kv_lora_rank=16, qk_nope_head_dim=16,
           qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8,
           num_experts_per_tok=2, n_shared_experts=1, moe_intermediate_size=32,
           first_k_dense_replace=1, intermediate_size=96,
           routed_scaling_factor=2.446)
CODEC = {"model_sr": 44100, "encoder_dim": 4, "decoder_dim": 32,
         "n_codebooks": 3, "codebook_size": 32}
TOL = 1e-4  # float32 sums in another order (module docstring)
TPF = 5  # tokens a visual row


def sampler(cfg=CFG, seed: int = 3, **extra):
    """A float32 sampler of ``cfg`` and the reference's weights, loaded."""
    s = Sampler(SamplerSpec(**cfg, dtype=torch.float32, **extra))
    sd = W.make(ref.param_specs(cfg), W.storage_dtypes(s),
                W.generator("cpu", seed, 0), "cpu")
    s.load_state_dict(sd, strict=True)
    return s.eval(), sd


def inputs(B=2, T=20, seed=0):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, CFG["d_codebook"] + 1, (B, CFG["num_codebooks"], T),
                           generator=g)
    feats = torch.randn(B, 4, CFG["cond_in_dim"], generator=g)
    return tokens, feats


def reference_logits(sd, tokens, feats):
    T = tokens.shape[-1]
    cond = ref.S.cond_sequence(sd, ref.S.project_cond(sd, feats), T, TPF)
    return ref.forward(sd, CFG, tokens, cond)


@pytest.fixture(scope="module")
def model():
    return sampler()


@torch.no_grad()
def test_forward_logits_match_the_reference(model):
    s, sd = model
    tokens, feats = inputs()
    got = s(tokens, feats, tokens_per_frame=TPF)
    want = reference_logits(sd, tokens, feats)
    assert want.abs().max() > 1.0  # not a test of zeros
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("prompt", [1, 8])
@torch.no_grad()
def test_prefill_then_decode_through_the_latent_cache(model, prompt):
    """A prompt prefilled, then one decode step a position through the
    latent cache, against the reference's full forward at every position:
    logits, not tokens."""
    s, sd = model
    tokens, feats = inputs(T=20)
    T = tokens.shape[-1]
    want = reference_logits(sd, tokens, feats)
    cond = s.build_cond_seq(s.embed_cond(feats), T, TPF)
    logits, pre = s.prefill(tokens[:, :, :prompt], cond[:, :prompt])
    torch.testing.assert_close(logits, want[:, :, :prompt], atol=TOL, rtol=0)
    cache = s.init_cache(tokens.shape[0], T)
    assert set(cache) == {"c", "k_pe"}
    assert cache["c"].shape == (3, 2, T, 16) and cache["k_pe"].shape == (3, 2, T, 8)
    for name in ("c", "k_pe"):
        cache[name][:, :, :prompt] = pre[name]
    for p in range(prompt, T):
        got = s.decode_step(tokens[:, :, p:p + 1], cond[:, p:p + 1], cache, p)
        torch.testing.assert_close(got, want[:, :, p], atol=TOL, rtol=0)


@torch.no_grad()
def test_absorbed_decode_matches_the_full_sequence_form(model):
    """``LatentAttention.decode`` (queries moved into the latent space,
    attention over the cached ``[c; k_pe]`` rows) against ``forward_kv``
    over the whole sequence, at its last position."""
    s, _ = model
    att = s.layers[1].attention
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 9, 64, generator=g)
    freqs = s.freqs_cis[:9]
    mask = torch.ones(9, 9, dtype=torch.bool).tril()
    full, (c, k_pe) = att.forward_kv(x, freqs, mask)
    row = torch.tensor([8], dtype=torch.int32)
    out, (c_new, pe_new) = att.decode(x[:, 8:9], freqs[8:9], (c, k_pe), row)
    torch.testing.assert_close(out[:, 0], full[:, 8], atol=TOL, rtol=0)
    torch.testing.assert_close(c_new, c[:, 8], atol=TOL, rtol=0)
    torch.testing.assert_close(pe_new, k_pe[:, 8], atol=TOL, rtol=0)


@torch.no_grad()
def test_moe_layer_matches_the_per_expert_loop(model):
    """Choice by ``s + bias``, weights from ``s`` alone, renormalised and
    scaled, the shared expert added: against the reference's loop. A bias
    that favours one expert puts it in every choice while its weight stays
    its (low) score's share."""
    s, sd = model
    ff = s.layers[2].feed_forward
    assert isinstance(ff, MoEFeedForward)
    pre = "layers.2.feed_forward."
    g = torch.Generator().manual_seed(2)
    x = torch.randn(30, 64, generator=g)
    w = ref.widths(CFG)
    bias = ff.gate.e_score_correction_bias
    kept = bias.detach().clone()
    try:
        bias.data[5] = 10.0
        sd2 = dict(sd, **{pre + "gate.e_score_correction_bias": bias.detach()})
        choice, weights = ff.route(x)
        r_choice, r_weights = ref.route(sd2, pre, w, x)
        assert (choice == 5).any(-1).all()
        assert torch.equal(choice.sort(-1).values, r_choice.sort(-1).values)
        torch.testing.assert_close(weights, r_weights, atol=1e-6, rtol=0)
        torch.testing.assert_close(weights.sum(-1), torch.full((30,), 2.446))
        scores = torch.sigmoid(x @ ff.gate.weight.t())
        torch.testing.assert_close(weights[choice == 5] / 2.446,
                                   (scores[:, 5] / scores.gather(1, choice).sum(-1)),
                                   atol=1e-6, rtol=0)
        got = ff(x)
        torch.testing.assert_close(got, ref.moe(sd2, pre, w, x), atol=TOL, rtol=0)
        assert torch.equal(ff.routed_rows, torch.bincount(
            choice.flatten(), minlength=8).int())
    finally:
        bias.data.copy_(kept)


@torch.no_grad()
def test_the_tolerance_sees_one_expert_fewer(model):
    """The fault the benchmark plants (the router keeps one expert fewer)
    moves the logits hundreds of times the tolerance."""
    _, sd = model
    s = Sampler(SamplerSpec(**dict(CFG, num_experts_per_tok=1),
                            dtype=torch.float32))
    s.load_state_dict(sd, strict=True)
    tokens, feats = inputs()
    gap = (s(tokens, feats, tokens_per_frame=TPF)
           - reference_logits(sd, tokens, feats)).abs().max()
    assert gap > 100 * TOL, gap


@torch.no_grad()
def test_route_gap_sees_a_router_without_the_bias():
    """The other router fault the benchmark plants (the choice by ``s``
    alone, the correction bias left out; ``generate_mla_moe.FAULTS``):
    the reference's ``route_gap`` of its choices passes the cell's limit
    on some token, where the program's own router reads 0 on every one."""
    import json
    from pathlib import Path
    from types import SimpleNamespace

    from port_bench.traffic import generate_mla_moe

    cell = json.loads((Path(__file__).resolve().parents[1] / "port_bench"
                       / "workloads" / "gen_feats_moonlight_b512.json"
                       ).read_text())
    s, sd = sampler()
    pre = "layers.2.feed_forward."
    x = torch.randn(400, 64, generator=torch.Generator().manual_seed(4))
    biased = (torch.sigmoid(x @ sd[pre + "gate.weight"].t())
              + sd[pre + "gate.e_score_correction_bias"])
    sound = ref.route_gap(biased, s.layers[2].feed_forward.route(x)[0], 2)
    assert sound.max() == 0.0
    generate_mla_moe.FAULTS["no_bias"](SimpleNamespace(sampler=s))
    gap = ref.route_gap(biased, s.layers[2].feed_forward.route(x)[0], 2)
    assert gap.max() > cell["limits"]["route_gap"], gap.max()


def _system(seed: int = 3):
    s_cfg = SamplerSpec(**CFG, dtype=torch.float32, param_dtype=torch.float32,
                        codebook_dim=8)
    system = VauraSystem(s_cfg, DacSpec(**CODEC).config, device="cpu")
    sd = W.make(ref.param_specs(CFG), W.storage_dtypes(system.sampler),
                W.generator("cpu", seed, 0), "cpu")
    system.sampler.load_state_dict(sd, strict=True)
    dac = W.make(ref_dac.param_specs(CODEC), W.storage_dtypes(system.dac),
                 W.generator("cpu", seed, 1), "cpu")
    system.dac.load_state_dict(dac, strict=True)
    return system.requires_grad_(False)


@pytest.fixture(scope="module")
def system():
    return _system()


def _steps(system, reference: bool, T: int = 10):
    """Tokens of one generation's steps, through ``generate_tokens`` (its
    one loop, eager here) or (``reference``) the plain host-int loop
    (``torch_port_util.reference_decode_loop``), and the expert counter."""
    g = torch.Generator().manual_seed(4)
    feats = torch.randn(2, 4, CFG["cond_in_dim"], generator=g)
    pattern, mask, S = system.prepare_generation(T)
    codes = torch.full((2, 3, T), -1, dtype=torch.long)
    seq, _, _ = pattern.build_pattern_sequence(codes, system.special_token_id)
    cond = system.build_cond_seq_for_generation(feats, S, TPF, cfg=True)
    kw = dict(S=S, valid_mask=mask, temp=1.0, top_k=8, cfg_scale=3.0)
    gen = torch.Generator().manual_seed(5)
    if not reference:
        return system.generate_tokens(cond, seq, gen, **kw), system.expert_load()
    cache = system.sampler.init_cache(4, S)
    cfg = system.sampler_config
    system.sampler.expert_load = torch.zeros(S, cfg.moe_layers, 8,
                                             dtype=torch.int32)
    system.sampler.expert_choices = None
    out = reference_decode_loop(system, cache, seq.clone(), cond, mask, gen,
                                range(1, S), use_sampling=True, temp=1.0,
                                top_k=8, top_p=0.0, cfg_scale=3.0)
    return out, system.expert_load()


def test_device_position_step_matches_the_host_int_step(system):
    host, load_h = _steps(system, reference=True)
    dev, load_d = _steps(system, reference=False)
    assert torch.equal(host, dev)
    assert torch.equal(load_h, load_d)
    S = host.shape[-1]
    # every step routes 4 rows (2 clips and their null condition) to 2
    # experts in each of the 2 routed layers; position S - 1 is never read
    assert load_h.shape == (S, 2, 8)
    assert (load_h[:S - 1].sum(-1) == 8).all() and (load_h[S - 1] == 0).all()


def test_generate_end_to_end(system):
    feats = torch.randn(3, 4, CFG["cond_in_dim"],
                        generator=torch.Generator().manual_seed(6))
    out = system.generate(vis_feats=feats, max_new_tokens=8, cfg_scale=3.0,
                          top_k=8, tokens_per_frame=TPF, check=True, seed=1)
    codes = out["codes"]
    assert codes.shape == (3, 3, 8)
    assert int(codes.min()) >= 0 and int(codes.max()) < CFG["d_codebook"]
    assert out["audio"].shape[0] == 3 and torch.isfinite(out["audio"]).all()
    assert system.expert_load().shape[1:] == (2, 8)


def _raises(fn, match):
    with pytest.raises(NotImplementedError, match=match):
        fn()


@pytest.mark.parametrize("case", [
    "quantize_cache", "quantize_weights", "q_lora_rank", "scoring_func",
    "n_group", "lora", "mesh", "rolling_cache", "training", "train_forward",
    "aot"])
def test_unsupported_combinations_raise(system, case):
    if case in ("quantize_cache", "quantize_weights"):
        return _raises(lambda: SamplerSpec(**CFG, **{case: True}), case)
    if case == "q_lora_rank":
        return _raises(lambda: SamplerSpec(**CFG, q_lora_rank=8), "q_lora_rank")
    if case == "scoring_func":
        return _raises(lambda: SamplerSpec(**CFG, scoring_func="softmax"),
                       "sigmoid")
    if case == "n_group":
        return _raises(lambda: SamplerSpec(**CFG, n_group=2), "group")
    if case == "lora":
        return _raises(lambda: VauraSystem(
            system.sampler_config, system.dac.cfg, device="cpu", lora_rank=2),
            "LoRA")
    if case == "mesh":
        from vaura_tpu_torch.parallel import shard_module

        return _raises(lambda: shard_module(system, None), "mesh")
    if case == "rolling_cache":
        feats = torch.randn(1, 4, CFG["cond_in_dim"])
        return _raises(lambda: system.generate_long_kv(
            vis_feats_segments=feats[None], total_tokens=12, chunk_tokens=8,
            stride_tokens=4), "rolling cache")
    tokens, feats = inputs()
    if case == "training":
        return _raises(lambda: system.sampler(tokens, feats, train=True),
                       "training")
    if case == "train_forward":
        codes = torch.randint(0, 32, (2, 3, 12))
        return _raises(lambda: system.train_forward(
            None, None, vis_feats=feats, codes=codes), "training")
    from vaura_tpu_torch.utils import aot

    _raises(lambda: aot._cache_names(system), "exporting")


@pytest.mark.parametrize("path", ["forward", "decode"])
@torch.no_grad()
def test_llama_block_unchanged_by_the_new_defaults(path):
    """The new keys at their defaults build the Llama block (the same
    parameters) and compute what the Llama reference computes."""
    from port_bench.reference import sampler as llama

    cfg = {k: CFG[k] for k in ("num_layers", "d_model", "nhead", "d_codebook",
                               "num_codebooks", "cond_in_dim", "cond_token_num",
                               "block_size_audio", "block_size_video",
                               "cond_feature_channel_scaler", "dropout")}
    plain = SamplerConfig(**cfg, dtype=torch.float32)
    spelled = SamplerConfig(**cfg, **PORT_ONLY_FIELDS, dtype=torch.float32)
    assert plain == spelled and not plain.deepseek
    s = Sampler(spelled)
    assert {n for n, _, _ in llama.param_specs(cfg)} == set(s.state_dict())
    sd = W.make(llama.param_specs(cfg), W.storage_dtypes(s),
                W.generator("cpu", 9, 0), "cpu")
    s.load_state_dict(sd, strict=True)
    tokens, feats = inputs()
    T = tokens.shape[-1]
    cond = llama.cond_sequence(sd, llama.project_cond(sd, feats), T, TPF)
    want = llama.forward(sd, cfg, tokens, cond)
    if path == "forward":
        got = s(tokens, feats, tokens_per_frame=TPF)
        torch.testing.assert_close(got, want, atol=TOL, rtol=0)
        return
    cseq = s.build_cond_seq(s.embed_cond(feats), T, TPF)
    cache = s.init_cache(tokens.shape[0], T)
    assert set(cache) == {"k", "v"}
    for p in range(T):
        got = s.decode_step(tokens[:, :, p:p + 1], cseq[:, p:p + 1], cache, p)
        torch.testing.assert_close(got, want[:, :, p], atol=TOL, rtol=0)


def test_config_keys_and_derived_widths():
    cfg = SamplerSpec(**CFG)
    assert cfg.mla and cfg.moe and cfg.moe_layers == 2
    assert cfg.qk_head_dim == 24 and cfg.rope_dim == 8
    assert cfg.ffn_hidden_dim == 96
    assert dataclasses.replace(cfg, intermediate_size=None).ffn_hidden_dim == 256
    assert set(PORT_ONLY_FIELDS) <= {f.name for f in dataclasses.fields(cfg)}


def test_generate_action_runs_the_block(tmp_path, monkeypatch):
    """The generate action, as a user runs it, with the dummy experiment's
    sampler turned into the DeepSeek-V3 block by the config's keys (those
    of ``configs/modules/samplers/moonlight_9cbs.yaml``, at tiny widths):
    WAVs written."""
    from pathlib import Path

    from vaura_tpu_torch.main import main
    from vaura_tpu_torch.ops.audio import read_wav

    repo = Path(__file__).resolve().parents[1]
    monkeypatch.chdir(repo)
    pre = "model.sampler_config."
    block = {"target": "vaura_tpu_torch.models.sampler.SamplerSpec",
             "params.kv_lora_rank": 16, "params.qk_nope_head_dim": 8,
             "params.qk_rope_head_dim": 16, "params.v_head_dim": 8,
             "params.n_routed_experts": 8, "params.num_experts_per_tok": 2,
             "params.n_shared_experts": 1, "params.moe_intermediate_size": 16,
             "params.first_k_dense_replace": 1,
             "params.routed_scaling_factor": 2.446}
    out = main(["config=configs/experiments/dummy.yaml", "action=generate",
                "duration=0.15", "model_max_duration=0.64",
                "dataloader.batch_size=2", "max_batches=1", "cfg_scale=3.0",
                "trainer.platform=cpu", f"output_dir={tmp_path}"]
               + [f"{pre}{k}={v}" for k, v in block.items()])
    assert out["num_generated"] == 2
    wav, sr = read_wav(tmp_path / "0.wav")
    assert sr == 44100 and wav.shape == (1, 12 * 8)
