"""The plain reference agrees with the program's own plain path (the CPU
versions of its kernels) at tiny widths in float32: the sampler's
teacher-forced logits and its greedy decode through the KV cache, the
encoder's features, the codec both ways, and the training step's loss,
gradients (with the recipe's dropout masks worked out again) and AdamW."""

import json

import pytest
import torch

from port_bench import system as SYS
from port_bench import weights as W
from port_bench.reference import dac as ref_dac
from port_bench.reference import encoder as ref_encoder
from port_bench.reference import sampler as ref_sampler
from port_bench.reference import train as ref_train

from tiny import REPO, tiny_config

CPU = torch.device("cpu")


def f32_system(training=False, seed=5):
    """The program at tiny widths computing in float32, and the weights."""
    cfg = tiny_config(json.loads(
        (REPO / "port_bench/configs/vaura_vgg_train.json").read_text()))
    from vaura_tpu_torch.models.factory import build_system

    system = build_system(SYS.model_cfg(cfg, encoder=True), precision="f32",
                          device=CPU, param_dtype=torch.float32)
    made = {}
    for k, (part, ref) in enumerate(SYS.PARTS):
        module = getattr(system, part)
        specs = ref.param_specs(SYS.part_config(cfg, part))
        made[part] = W.make(specs, W.storage_dtypes(module),
                            W.generator(CPU, seed, k), CPU)
        module.load_state_dict(made[part], strict=True)
    return system, made, cfg


def test_sampler_logits_and_greedy_decode():
    system, made, cfg = f32_system()
    g = torch.Generator().manual_seed(1)
    K, V = cfg["sampler"]["num_codebooks"], cfg["sampler"]["d_codebook"]
    feats = torch.randn(2, 6, cfg["sampler"]["cond_in_dim"], generator=g)
    tokens = torch.randint(0, V + 1, (2, K, 10), generator=g)
    with torch.no_grad():
        got = system.sampler(tokens, feats, tokens_per_frame=2).float()
    cond = ref_sampler.cond_sequence(made["sampler"], ref_sampler.project_cond(
        made["sampler"], feats), 10, 2)
    want = ref_sampler.forward(made["sampler"], cfg["sampler"], tokens, cond)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    out = system.generate(vis_feats=feats, generator=g, max_new_tokens=8,
                          use_sampling=False, cfg_scale=3.0, tokens_per_frame=2,
                          decode_to_audio=False)
    seq, valid = ref_sampler.delayed_sequence(out["codes"], V)
    blended = ref_sampler.guided_logits(made["sampler"], cfg["sampler"], seq, feats, 2, 3.0)
    assert ref_sampler.served_gap(blended, seq, valid, 1).max().item() < 1e-4


def test_sampled_tokens_follow_the_reference_draw():
    """Top-k sampling through the KV cache draws the tokens that the
    reference draws with the call's noise made again from its generator;
    other noise, or tokens moved to the next entry, read gaps."""
    system, made, cfg = f32_system()
    g = torch.Generator().manual_seed(3)
    K, V = cfg["sampler"]["num_codebooks"], cfg["sampler"]["d_codebook"]
    feats = torch.randn(2, 6, cfg["sampler"]["cond_in_dim"], generator=g)
    out = system.generate(vis_feats=feats, generator=torch.Generator().manual_seed(5),
                          max_new_tokens=8, use_sampling=True, temp=1.0, top_k=4,
                          cfg_scale=3.0, tokens_per_frame=2, decode_to_audio=False)
    seq, valid = ref_sampler.delayed_sequence(out["codes"], V)
    blended = ref_sampler.guided_logits(made["sampler"], cfg["sampler"], seq, feats, 2, 3.0)
    rows = torch.arange(2)
    noise = ref_sampler.gumbel_draws(torch.Generator().manual_seed(5), 2, K, V,
                                     seq.shape[-1] - 1, rows)
    assert ref_sampler.served_gap(blended, seq, valid, 4, 1.0, noise).max().item() < 1e-4
    other = ref_sampler.gumbel_draws(torch.Generator().manual_seed(6), 2, K, V,
                                     seq.shape[-1] - 1, rows)
    assert ref_sampler.served_gap(blended, seq, valid, 4, 1.0, other).mean().item() > 0.1
    moved, _ = ref_sampler.delayed_sequence((out["codes"] + 1) % V, V)
    gap = ref_sampler.served_gap(blended, moved, valid, 4, 1.0, noise)
    assert (gap > 0).float().mean().item() > 0.5


def test_encoder_features():
    system, made, cfg = f32_system()
    frames = torch.randn(2, 2, 3, 4, 32, 32, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = system.visual_features(frames).float()
    want = ref_encoder.features(made["encoder"], cfg["encoder"], frames)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_codec_both_ways():
    system, made, cfg = f32_system()
    g = torch.Generator().manual_seed(3)
    codes = torch.randint(0, cfg["codec"]["codebook_size"], (2, 3, 5), generator=g)
    torch.testing.assert_close(system.dac.decode(codes),
                               ref_dac.decode(made["dac"], cfg["codec"], codes),
                               rtol=1e-4, atol=1e-4)
    audio = 0.1 * torch.randn(2, 1, 512 * 5 - 7, generator=g)
    assert torch.equal(system.encode_audio(audio),
                       ref_dac.encode(made["dac"], cfg["codec"], audio))


@pytest.mark.parametrize("remat", [True, False])
def test_training_step(remat):
    from vaura_tpu_torch.train.state import TrainState, build_schedule, make_optimizer
    from vaura_tpu_torch.train.steps import make_train_step, split_params

    from port_bench.traffic.train import optimizer_kw

    system, made, cfg = f32_system(training=True)
    cfg["sampler"]["remat"] = remat
    system.sampler.cfg = system.sampler_config = type(system.sampler_config)(
        **{**system.sampler_config.__dict__, "remat": remat})
    for layer in system.sampler.layers:
        layer.attention.cfg = system.sampler_config
    o = cfg["optimizer"]
    o = {**o, "schedule_config": {**o["schedule_config"], "params": {
        **o["schedule_config"]["params"], "warmup_steps": 2}}}
    cfg["optimizer"] = o
    state = TrainState.create(split_params(system)[0], make_optimizer(
        build_schedule(o["schedule_config"], o["learning_rate"]), **optimizer_kw(cfg)))
    step = make_train_step(system)
    g = torch.Generator().manual_seed(4)
    B, Ta = 4, 12
    feats = torch.randn(B, 6, cfg["sampler"]["cond_in_dim"], generator=g)
    codes = torch.randint(0, cfg["sampler"]["d_codebook"], (B, 3, Ta), generator=g)
    p0 = {k: v.clone() for k, v in made["sampler"].items()}
    params = {k: v.clone() for k, v in p0.items()}
    adam = ref_train.AdamW(params, {
        "betas": o["betas"], "gradient_clip_val": o["gradient_clip_val"],
        "weight_decay": o["weight_decay"], "learning_rate": o["learning_rate"],
        "schedule": o["schedule_config"]["params"]})
    for k in range(3):
        gen = torch.Generator().manual_seed(100 + k)
        state, m = step(state, {"vis_feats": feats, "codes": codes}, gen)
        null, masks, keep = ref_train.draw_masks(
            cfg["sampler"], B, Ta + 3, torch.Generator().manual_seed(100 + k), CPU)
        loss, grads = ref_train.loss_and_grads(params, cfg["sampler"], feats, codes,
                                               null, masks, keep, block=3)
        assert m["loss"].item() == pytest.approx(loss, rel=1e-5)
        clipped = adam.step(grads)
        if k == 0:
            for n, mu in state.opt_state.mu.items():
                torch.testing.assert_close(mu / (1 - o["betas"][0]),
                                           clipped[n.split(".", 1)[1]],
                                           rtol=1e-4, atol=1e-6)
    for n, p in params.items():
        torch.testing.assert_close(state.params["sampler." + n].detach(), p,
                                   rtol=1e-5, atol=1e-7)
