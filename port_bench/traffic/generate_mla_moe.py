"""Offline generation with a DeepSeek-V3 sampler (latent attention, routed
experts): ``generate.py``'s closed loop of one client, each call through
``VauraSystem.generate``, with the weights of ``reference/sampler_mla_moe.py``'s
table and the comparison through that reference.

A mix file (``kind: generate_mla_moe``) gives what ``generate.py``'s
``features`` mixes give: ``batch``, ``feature_rows`` (features ``[B, rows,
cond_in_dim]``, standard normal from the seed), ``dac_chunk``,
``check_rows`` and ``warmup_tokens``. The inputs, the warm-up in pieces,
the window, the traced call and the record are ``generate.py``'s (its
``make_inputs`` and ``warm_pieces``; the same record fields, so the readers
that do not depend on the architecture read it unchanged). Besides, each
call's expert counter (``VauraSystem.expert_load``: the rows routed to each
expert at each step and routed layer) is read once after the call and
summarised in the call's entry (``expert_load_max``: the mean over steps
and layers of the busiest expert's rows over the mean rows).

The comparison follows the program's routing (``reference/sampler_mla_moe.py``,
"Routing ties"): the program records each decode row's chosen experts
(``VauraSystem.record_routes``), the compared rows' and their
null-condition rows' are read after each call, and besides ``generate.py``'s
readings ``route_gap`` says how far the program's choices lie below the
reference's own top-k (the widest over the compared rows, steps and layers).

The sampler's weights are made once: the program's own parameters are
dropped (moved to the meta device) before the seed's tensors are drawn,
and the drawn tensors become its parameters (``load_state_dict(...,
assign=True)``), so the card holds one copy of the 30 GB.

``CONTROLS``, ``CODEC_CONTROL`` and ``FAULTS`` serve ``calibrate.py``: the
latent cache rounded through float8 e4m3 (a precision below the
configuration's bf16), the codec in bf16 (below its float32), and two
wrong routers: one that keeps one expert fewer than the configuration says
(``top5``), and one that chooses by the scores alone, without the
correction bias (``no_bias``).
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List

import torch

from port_bench import check, trace as T, weights as W
from port_bench.reference import dac as ref_dac
from port_bench.reference import sampler as ref_sampler
from port_bench.reference import sampler_mla_moe as ref_mla
from port_bench.system import DTYPES, check_widths, model_cfg
from port_bench.traffic.generate import STAGES, make_inputs, warm_pieces

PARTS = (("sampler", ref_mla), ("dac", ref_dac))


def build(config: dict, device: torch.device, seed: int,
          codec_dtype: str = None):
    """``(system, weights)``: the program's ``VauraSystem`` (no encoder) with
    the seed's weights as its own, checked against the widths the file
    states; ``codec_dtype`` a control's codec."""
    from vaura_tpu_torch.models.factory import build_system

    cfg = model_cfg(config, encoder=False)
    if codec_dtype:
        cfg["audio_encoder_config"]["params"] = {
            **config["codec"], "dtype": DTYPES[codec_dtype]}
    system = build_system(cfg, device=device,
                          param_dtype=DTYPES[config["dtypes"]["params"]])
    made: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, (part, ref) in enumerate(PARTS):
        module = getattr(system, part)
        specs = ref.param_specs(config["sampler"] if part == "sampler"
                                else config["codec"])
        dtypes = W.storage_dtypes(module)
        missing = sorted({n for n, _, _ in specs} - set(dtypes))
        if missing:
            raise ValueError(f"{part}: the program has no {missing[:3]}")
        if part == "sampler":  # one copy on the card: the drawn tensors
            kept = {n: b for n, b in module.named_buffers()
                    if n not in dtypes}  # non-persistent (the RoPE table)
            module.to_empty(device="meta")
            if device.type == "cuda":
                torch.cuda.empty_cache()
            made[part] = W.make(specs, dtypes, W.generator(device, seed, k),
                                device)
            module.load_state_dict(made[part], strict=True, assign=True)
            for name, buf in kept.items():
                owner, _, leaf = name.rpartition(".")
                module.get_submodule(owner)._buffers[leaf] = buf
        else:
            made[part] = W.make(specs, dtypes, W.generator(device, seed, k),
                                device)
            module.load_state_dict(made[part], strict=True)
    check_widths(system, config)
    system.requires_grad_(False)
    return system, made


def load_summary(load: torch.Tensor) -> float:
    """The mean over (step, routed layer) of the busiest expert's rows over
    the mean rows a expert, over the steps that ran (``[S, L, E]``)."""
    load = load.float()
    ran = load.sum(-1) > 0
    ratio = load.amax(-1) / load.mean(-1).clamp_min(1e-30)
    return float(ratio[ran].mean()) if ran.any() else float("nan")


def run(cell: dict, *, seed: int, seconds: float, trace: bool, device,
        t0: float, patch=None, variant: str = None, warmup: bool = True
        ) -> dict:
    config, mix = cell["config_data"], cell["mix"]
    system, made = build(config, device, seed,
                         "bfloat16" if variant == CODEC_CONTROL else None)
    for fn in (patch, CONTROLS.get(variant), FAULTS.get(variant)):
        if fn is not None:
            fn(system)
    system.record_routes = True
    x = make_inputs(config, mix, seed, device)
    g = config["generate"]
    B, T_new = mix["batch"], g["max_new_tokens"]
    audio_per_clip = T_new * system.dac.cfg.hop_length / system.dac.cfg.sample_rate
    sampling = dict(temp=g["temperature"], top_k=g["top_k"],
                    cfg_scale=g["cfg_scale"],
                    tokens_per_frame=g["tokens_per_frame"])

    def call(index: int):
        out = system.generate(
            vis_feats=x, generator=W.generator(device, seed, 100 + index),
            max_new_tokens=T_new, decode_to_audio=True,
            dac_chunk_size=mix["dac_chunk"], **sampling)
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
        rows = check.sample_rows(B, mix["check_rows"], seed, i).to(device)
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
        entry = {"t0": a - start, "t1": b - start, "clips": B,
                 "audio_s": B * audio_per_clip, "traced": profiled,
                 "stage_ms": out["stage_ms"]}
        entry["expert_load_max"] = load_summary(system.expert_load())
        calls.append(entry)
        routes = system.expert_choices(torch.cat([rows, rows + B])
                                       if g["cfg_scale"] > 1.0 else rows)
        served.append({"codes": out["codes"].index_select(0, rows),
                       "audio": out["audio"].index_select(0, rows),
                       "feats": x.index_select(0, rows), "rows": rows,
                       "batch": B, "routes": routes,
                       "generator": W.generator(device, seed, 100 + i)})
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
    readings = compare_generation(made, config, served) if served else {}
    correct, checks = check.verdict(readings, cell["limits"], complete)
    record = {
        "kind": "generate", "setup_s": setup_s, "calls": calls,
        "window_s": calls[-1]["t1"] - calls[0]["t0"],
        "shapes": {"batch": B, "tokens": T_new, "steps": steps,
                   "encoder": False, "frames": None,
                   "feature_rows": mix["feature_rows"]},
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


@torch.no_grad()
def compare_generation(made: Dict[str, Dict[str, torch.Tensor]], config: dict,
                       served: List[dict], block: int = 2) -> Dict[str, float]:
    """``check.compare_generation`` through this decoder's reference (the
    features cells' part), which follows the program's recorded routing:
    ``token_gap``, ``token_gap_mean``, ``wave_rel_err`` and
    ``route_gap``."""
    g = config["generate"]
    V = config["sampler"]["d_codebook"]
    out = {"token_gap": 0.0, "wave_rel_err": 0.0, "route_gap": 0.0}
    total, n_slots = 0.0, 0
    with check.exact_matmuls():
        for call in served:
            n, K, T_ = call["codes"].shape
            noise = ref_sampler.gumbel_draws(call["generator"], call["batch"],
                                             K, V, T_ + K - 1, call["rows"])
            routes = call["routes"].to(call["rows"].device)
            for sl in ref_sampler.blocks(n, block):
                codes = call["codes"][sl]
                seq, valid = ref_sampler.delayed_sequence(codes, V)
                gaps = []
                both = (routes[:, :, sl], routes[:, :, n:][:, :, sl]) \
                    if g["cfg_scale"] > 1.0 else (routes[:, :, sl], None)
                blended = ref_mla.guided_logits(
                    made["sampler"], config["sampler"], seq, call["feats"][sl],
                    g["tokens_per_frame"], g["cfg_scale"], both, gaps)
                out["route_gap"] = max(out["route_gap"],
                                       max(float(t.max()) for t in gaps))
                gap = ref_sampler.served_gap(blended, seq, valid, g["top_k"],
                                             g["temperature"], noise[sl])
                del blended
                out["token_gap"] = max(out["token_gap"], gap.max().item())
                total += gap.double().sum().item()
                n_slots += gap.numel()
                wave = ref_dac.decode(made["dac"], config["codec"], codes)
                err = check.rel_err(call["audio"][sl], wave).max().item()
                out["wave_rel_err"] = max(out["wave_rel_err"], err)
            del noise
    out["token_gap_mean"] = total / max(n_slots, 1)
    return out


def _fp8_cache(system):
    """Control: every latent row the cache stores rounded through float8
    e4m3 (3 mantissa bits) and back."""
    store = system.sampler._store

    def rounded(k, v):
        return {n: t.to(torch.float8_e4m3fn).to(t.dtype)
                for n, t in store(k, v).items()}
    system.sampler._store = rounded


def _top5(system):
    """Fault: each routed layer keeps one expert fewer than configured."""
    for layer in system.sampler.layers:
        ff = layer.feed_forward
        if hasattr(ff, "route"):
            ff.cfg = dataclasses.replace(
                ff.cfg, num_experts_per_tok=ff.cfg.num_experts_per_tok - 1)


def _no_bias(system):
    """Fault: each routed layer chooses by ``topk(s)``, the correction bias
    left out of the choice (a zero bias in its place; the drawn one, which
    the reference holds, untouched). The weights still come from ``s``."""
    for layer in system.sampler.layers:
        ff = layer.feed_forward
        if hasattr(ff, "route"):
            bias = ff.gate.e_score_correction_bias
            ff.gate.e_score_correction_bias = torch.nn.Parameter(
                torch.zeros_like(bias), requires_grad=False)


CONTROLS = {"fp8_cache": _fp8_cache}
CODEC_CONTROL = "bf16_codec"  # the program built with the bf16 codec
FAULTS = {"top5": _top5, "no_bias": _no_bias}


def calibration_run(cell: dict, variant: str, seed: int, device) -> dict:
    """``calibrate.py``'s reading of one seed: one call at the cell's batch,
    comparing as many rows as four calls of a window do, by the program
    (``program``), a control (``CONTROLS``, ``CODEC_CONTROL``) or a fault
    (``FAULTS``)."""
    import copy

    calib = copy.deepcopy(cell)
    calib["mix"].update(check_rows=4 * cell["mix"]["check_rows"])
    rec = run(calib, seed=seed, seconds=0, trace=False, device=device,
              t0=time.perf_counter(), warmup=False,
              variant=None if variant == "program" else variant)
    return rec["readings"]
