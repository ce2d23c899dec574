"""Offline generation: one caller sends batches back to back (a closed loop
of one client), each through ``VauraSystem.generate``, the entry that the
generate action and the server call, sampling as the configuration says.

A mix file (``kind: generate``) gives ``batch``, ``input`` (``features``:
``[B, feature_rows, cond_in_dim]`` float32; ``frames``: ``[B, *frames]``
bf16; both standard normal from the seed, as the program's own bench makes
them), ``dac_chunk`` and ``encoder_chunk`` (the clips each slice of the
codec and of the encoder takes), ``check_rows`` (the rows of each call
that the reference compares, drawn from the seed and the call's index)
and ``warmup_tokens`` (the decode steps of the warm-up).

Set-up makes the weights and inputs from the seed and warms every kernel
and shape of the window up in pieces (``warm_pieces``): a whole call
would cost as much again for nothing more. The
window then calls while less than ``seconds`` have passed (once at
least); each call's sampling generator is seeded from the seed and the
call's index. With ``trace`` one more call follows, under the profiler
(``trace.py``), so that the span readers, which leave it out, read every
call of a whole window. ``warmup=False`` and ``variant``
(a control: see ``system.build``) serve ``calibrate.py``.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from port_bench import check, trace as T, weights as W
from port_bench.system import build

# the intervals between the marks of the program's ``StageClock``
STAGES = ["encoder", "decode_loop", "dac"]


def make_inputs(config: dict, mix: dict, seed: int, device) -> torch.Tensor:
    g = W.generator(device, seed, 10)
    B = mix["batch"]
    if mix["input"] == "features":
        return torch.randn(B, mix["feature_rows"], config["sampler"]["cond_in_dim"],
                           generator=g, device=device)
    return torch.randn(B, *mix["frames"], generator=g, device=device,
                       dtype=torch.bfloat16)


def warm_pieces(system, config: dict, mix: dict, x: torch.Tensor,
                sampling: dict, device, seed: int) -> None:
    """Every kernel and shape of the window once, in a fraction of a call:
    one encoder chunk (frames), ``warmup_tokens`` decode steps over the
    cell's batch, one codec slice at the cell's length."""
    B, T_new = mix["batch"], config["generate"]["max_new_tokens"]
    feats = x
    if mix["input"] == "frames":
        c = mix["encoder_chunk"]
        feats = system.visual_features(x[:c], chunk_size=c)
        feats = feats.repeat(-(-B // c), 1, 1)[:B]
    system.generate(vis_feats=feats, generator=W.generator(device, seed, 98),
                    max_new_tokens=mix["warmup_tokens"], decode_to_audio=False,
                    **sampling)
    codes = torch.randint(0, config["sampler"]["d_codebook"],
                          (mix["dac_chunk"], system.num_codebooks, T_new),
                          generator=W.generator(device, seed, 99), device=device)
    system.decode_audio(codes, chunk_size=mix["dac_chunk"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: dict, *, seed: int, seconds: float, trace: bool, device,
        t0: float, patch=None, variant: Dict = None, warmup: bool = True
        ) -> dict:
    config, mix = cell["config_data"], cell["mix"]
    frames_in = mix["input"] == "frames"
    system, made = build(config, device, seed, encoder=frames_in,
                         **(variant or {}))
    if patch is not None:
        patch(system)
    x = make_inputs(config, mix, seed, device)
    g = config["generate"]
    B, T_new = mix["batch"], g["max_new_tokens"]
    audio_per_clip = T_new * system.dac.cfg.hop_length / system.dac.cfg.sample_rate
    sampling = dict(temp=g["temperature"], top_k=g["top_k"],
                    cfg_scale=g["cfg_scale"],
                    tokens_per_frame=g["tokens_per_frame"])
    rows = {"now": None}
    captured: Dict[str, torch.Tensor] = {}
    if frames_in:  # the program's features of the compared rows
        features = system.visual_features

        def capture_features(*a, **kw):
            feats = features(*a, **kw)
            if rows["now"] is not None:
                captured["feats"] = feats.index_select(0, rows["now"]).float()
            return feats
        system.visual_features = capture_features

    def call(index: int):
        kw = {"frames": x} if frames_in else {"vis_feats": x}
        out = system.generate(
            generator=W.generator(device, seed, 100 + index),
            max_new_tokens=T_new, decode_to_audio=True,
            dac_chunk_size=mix["dac_chunk"],
            encoder_chunk_size=mix.get("encoder_chunk"), **sampling, **kw)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    if warmup:
        warm_pieces(system, config, mix, x, sampling, device, seed)
    setup_s = time.perf_counter() - t0
    setup_peak = check.peak(device) or 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    calls: List[dict] = []
    served: List[dict] = []
    traced = None
    start = time.perf_counter()
    while True:
        i = len(calls)
        over = i >= 1 and time.perf_counter() - start >= seconds
        if over and (not trace or traced is not None):
            break
        profiled = over  # a traced run's last call, once the time is up
        rows["now"] = check.sample_rows(B, mix["check_rows"], seed, i).to(device)
        a = time.perf_counter()
        if profiled:
            with T.profiled(device) as prof:
                out = call(i)
            b = time.perf_counter()
            traced = T.summarise(prof, STAGES, b - a)
            del prof
        else:
            out = call(i)
            b = time.perf_counter()
        calls.append({"t0": a - start, "t1": b - start, "clips": B,
                      "audio_s": B * audio_per_clip, "traced": profiled,
                      "stage_ms": out["stage_ms"]})
        kept = {"codes": out["codes"].index_select(0, rows["now"]),
                "audio": out["audio"].index_select(0, rows["now"]),
                "rows": rows["now"], "batch": B,
                "generator": W.generator(device, seed, 100 + i)}
        if frames_in:
            kept["frames"] = x.index_select(0, rows["now"])
            kept["prog_feats"] = captured.pop("feats")
        else:
            kept["feats"] = x.index_select(0, rows["now"])
        served.append(kept)
        del out
    peak_window = check.peak(device)
    memory_peak = max(setup_peak, peak_window or 0)  # the run's, before the reference

    # the program's state goes before the reference runs
    steps = system.prepare_generation(T_new)[2] - 1
    del system, x
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    complete = bool(served) and all(
        check.sequence_complete(s["codes"], config["sampler"]["d_codebook"])
        for s in served)
    readings = check.compare_generation(made, config, served) if served else {}
    correct, checks = check.verdict(readings, cell["limits"], complete)
    record = {
        "kind": "generate", "setup_s": setup_s, "calls": calls,
        "window_s": calls[-1]["t1"] - calls[0]["t0"],
        "shapes": {"batch": B, "tokens": T_new, "steps": steps,
                   "encoder": frames_in, "frames": mix.get("frames"),
                   "feature_rows": mix.get("feature_rows")},
        "config": config, "peak_window_bytes": peak_window,
        "trace": traced, "correct": correct, "checks": checks,
        "readings": readings,
        "attempted": B * len(calls), "failed": 0,
        "device": {"memory_peak_bytes": memory_peak},
    }
    if traced:
        record["device"].update(busy_s=traced["busy_s"], window_s=traced["wall_s"])
        record["breakdown"] = traced["breakdown"]
    return record


# controls: the program with a lower-precision path of its own switched on
CONTROLS = {
    "int8_weights": {"sampler_overrides": {"quantize_weights": True}},
    "int4_cache": {"sampler_overrides": {"cache_bits": 4}},
    "bf16_codec": {"codec_dtype": "bfloat16"},
    "int8_encoder": {"quantize_encoder": True},
}


def calibration_run(cell: dict, variant: str, seed: int, device) -> dict:
    """``calibrate.py``'s reading of one seed: one call at the cell's batch,
    comparing as many rows as four calls of a window do, by the program
    (``variant`` ``program``) or a control."""
    import copy

    calib = copy.deepcopy(cell)
    calib["mix"].update(check_rows=4 * cell["mix"]["check_rows"])
    rec = run(calib, seed=seed, seconds=0, trace=False, device=device,
              t0=time.perf_counter(), warmup=False,
              variant=None if variant == "program" else CONTROLS[variant])
    return rec["readings"]
