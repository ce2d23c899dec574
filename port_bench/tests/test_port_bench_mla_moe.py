"""The DeepSeek-V3 configuration's cell: the new counts against
hand-worked values at small shapes, the four new readers on hand-made
records (and nothing read where their program counters or kernels are
absent), and the cell's planted faults at a tiny size on the CPU."""

import json
from pathlib import Path

import pytest
import torch

from port_bench import counts as C
from port_bench import run as R
from port_bench.counts import mla_moe as M
from port_bench.traffic import generate_mla_moe

REPO = Path(__file__).resolve().parents[2]
MOON = json.loads((REPO / "port_bench/configs/vaura_moonlight16b.json").read_text())
TRAIN = json.loads((REPO / "port_bench/configs/vaura_vgg_train.json").read_text())
GEN = json.loads((REPO / "port_bench/configs/vaura_vgg.json").read_text())
SEED = 2 ** 33 + 17

S = dict(d_model=4, num_layers=2, nhead=2, multiple_of=2, num_codebooks=2,
         d_codebook=3, codebook_dim=2, cond_feature_channel_scaler=2,
         kv_lora_rank=2, qk_nope_head_dim=1, qk_rope_head_dim=2, v_head_dim=1,
         n_routed_experts=4, num_experts_per_tok=2, n_shared_experts=1,
         moe_intermediate_size=3, first_k_dense_replace=1, intermediate_size=5)


def test_counts():
    # wq 4*2*3, wkv_a 4*4, wkv_b 2*2*2, wo 2*1*4
    assert M.attention_params(S) == 24 + 16 + 8 + 8
    # 2 layers' attention, the dense SwiGLU 3*4*5, the routed layer's router
    # 4*4 and 2 chosen + 1 shared experts 3*4*(2*3 + 3), head, projections
    assert M.active_params(S) == 112 + 60 + 124 + 24 + 8
    # keys 1 + 2; per head and key 2 * (2R + dr)
    assert M.mla_decode_attention_flops(S, rows=1, steps=2) == 2 * 2 * 12 * 3
    # cached rows 0 + 1 of 4 bf16 values; a step's q, new row, output
    assert M.mla_decode_attention_bytes(S, rows=1, steps=2) == 2 * (8 + 2 * 40)
    assert M.sampler_decode_flops(S, rows=1, steps=2) == 2 * 328 * 2 + 144
    assert M.expert_flops(S, rows=1, steps=2) == 2 * 2 * 2 * 3 * 4 * 3
    # every expert's weights and the routed rows in and out, a step
    assert M.expert_bytes(S, rows=1, steps=2) == 2 * (288 + 84)


def test_counts_at_the_published_widths():
    s = MOON["sampler"]
    # 2.26 B weights a position runs through (of 15.3 B; Moonlight's "A3B"
    # adds its 0.67 B of text embedding and head)
    assert 2.25e9 < M.active_params(s) < 2.27e9
    # every expert's weights a step: 26 layers x 64 x 3 x 2048 x 1408 x 2 B
    assert M.expert_bytes(s, rows=0, steps=1) == 26 * 64 * 3 * 2048 * 1408 * 2


TRACE = {"wall_s": 10.0, "busy_s": 9.0,
         "kernels": {"mla_decode_kernel": [27 * 229, 0.6],
                     "_ZN7cutlass13device_kernel...GroupProblemShape...": [
                         3 * 26 * 229, 3.0],
                     "void at::cuda::detail::prepare_grouped_gemm_data<...>": [
                         3 * 26 * 229, 0.1]},
         "stages": {"decode_loop": {"launches": 2700, "host_s": 4.0}},
         "breakdown": {"device_ops": [], "idle_gaps": []}}


def gen_record(config=MOON, trace=TRACE) -> dict:
    calls = [{"t0": 10.0 * i, "t1": 10.0 * i + 10.0, "clips": 512,
              "audio_s": 1313.7, "traced": i == 2, "expert_load_max": 3.0 + i,
              "stage_ms": {"encoder": 0.01, "decode_loop": 5000.0,
                           "dac": 3300.0}} for i in range(3)]
    return {"kind": "generate", "setup_s": 20.0, "calls": calls,
            "window_s": 30.0, "config": config, "peak_window_bytes": 2 ** 35,
            "shapes": {"batch": 512, "tokens": 221, "steps": 229,
                       "encoder": False, "frames": None},
            "trace": trace}


def train_record() -> dict:
    calls = [{"t0": 1.0 * i, "t1": 1.0 * i + 1.0, "tokens": 48 * 221,
              "traced": i == 2, "loss": 7.0,
              "clock_ms": {"forward": 400.0, "backward": 550.0,
                           "optimizer": 30.0}} for i in range(3)]
    return {"kind": "train", "setup_s": 15.0, "calls": calls, "window_s": 3.0,
            "config": TRAIN, "peak_window_bytes": 2 ** 34, "trace": None,
            "shapes": {"batch": 48, "frames": [4, 3, 16, 224, 224],
                       "audio_samples": 112896, "codec_frames": 221}}


def read(name, rec):
    return R.load_reader(REPO, name)(rec)


def test_generation_readers():
    rec = gen_record()
    s, rows, steps = MOON["sampler"], 1024, 229
    assert read("mla_decode_attention_roofline", rec) == pytest.approx(
        C.roofline_pct(M.mla_decode_attention_flops(s, rows, steps),
                       M.mla_decode_attention_bytes(s, rows, steps), 0.6))
    assert read("moe_experts_roofline", rec) == pytest.approx(
        C.roofline_pct(M.expert_flops(s, rows, steps),
                       M.expert_bytes(s, rows, steps), 3.1))
    assert 0 < read("moe_experts_roofline", rec) <= 100
    assert read("moe_expert_load_max.gen", rec) == pytest.approx(4.0)
    flops = (M.sampler_decode_flops(s, rows, steps)
             + 512 * C.dac_decode_flops(MOON["codec"], 221))
    assert read("mfu.gen_mla_moe", rec) == pytest.approx(
        100 * flops * 2 / 20.0 / C.PEAK_BF16_FLOPS)


@pytest.mark.parametrize("name", ["mla_decode_attention_roofline",
                                  "moe_experts_roofline",
                                  "moe_expert_load_max.gen"])
def test_readers_find_nothing_without_their_source(name):
    """The Llama sampler's record (no latent kernel, no grouped products,
    no expert counter), a training step, and for the trace's readers a run
    without a trace: left out, not zero."""
    bare = gen_record(GEN, dict(TRACE, kernels={}))
    for c in bare["calls"]:
        del c["expert_load_max"]
    recs = [bare, train_record()]
    if name != "moe_expert_load_max.gen":  # a counter, read untraced too
        recs.append(gen_record(trace=None))
    for rec in recs:
        assert read(name, rec) is None


def test_dense_sampler_mfu_counts_every_weight():
    rec = gen_record(GEN)
    flops = (C.sampler_decode_flops(GEN["sampler"], 1024, 229)
             + 512 * C.dac_decode_flops(GEN["codec"], 221))
    assert read("mfu.gen_mla_moe", rec) == pytest.approx(
        100 * flops * 2 / 20.0 / C.PEAK_BF16_FLOPS)


def test_load_summary():
    load = torch.zeros(3, 2, 4, dtype=torch.int32)
    load[0, 0] = torch.tensor([4, 0, 0, 0])  # all on one: max / mean = 4
    load[0, 1] = torch.tensor([1, 1, 1, 1])  # even: 1
    load[1, 0] = torch.tensor([2, 2, 0, 0])  # 2
    load[1, 1] = torch.tensor([3, 1, 0, 0])  # 3
    assert generate_mla_moe.load_summary(load) == pytest.approx(2.5)


def _token_altered(system):
    V = system.sampler_config.d_codebook
    fn = system.generate_tokens

    def altered(*a, **kw):
        seq = fn(*a, **kw)
        return torch.where(seq < V, (seq + 1) % V, seq)
    system.generate_tokens = altered


def _state_unchanged(system):
    system.sampler.commit_rows = lambda cache, rows, row: None


@pytest.mark.parametrize("name,fault", [
    ("top5", generate_mla_moe.FAULTS["top5"]),
    ("no_bias", generate_mla_moe.FAULTS["no_bias"]),
    ("token_altered", _token_altered), ("state_unchanged", _state_unchanged)])
def test_fault_is_not_correct(tiny_tree, name, fault):
    out = R.run_cell(tiny_tree, "gen_feats_moonlight_b512", SEED, 0.0, 0,
                     device="cpu", patch=fault)
    assert out["result"]["correct"] is False, out["result"]["checks"]


def test_sound_run_is_correct_and_follows_the_routing(tiny_tree):
    out = R.run_cell(tiny_tree, "gen_feats_moonlight_b512", SEED, 0.0, 0,
                     device="cpu")
    assert out["result"]["correct"] is True, out["result"]["checks"]
    assert set(out["record"]["readings"]) == {
        "token_gap", "token_gap_mean", "wave_rel_err", "route_gap"}
