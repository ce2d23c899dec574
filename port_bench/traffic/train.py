"""The recipe's training step, step after step, through
``train.steps.make_train_step`` over one ``TrainState``.

A mix file (``kind: train``) gives ``batch``, ``frames`` (one clip's
``[S, C, T, H, W]``, bf16 standard normal), ``audio_samples`` (a clip's
waveform, standard normal times ``audio_scale``, float32), ``codec_frames``
(the codec frames a clip's waveform makes: a step's tokens are the batch's),
``pool`` (the distinct batches made from the seed; the window cycles
through them) and ``block`` (rows a block of the reference's backward
takes).

Set-up builds the system (float32 parameters, the frozen encoder and
codec), the state and the step, makes the batches, and runs the first
three steps on three distinct batches: they warm every kernel and shape
up, and they are what the reference follows (each step's loss, the first
gradient as the optimizer got it, the parameters' change after the
three). The window then steps while less than ``seconds`` have passed,
each step read to the host (its loss) before the next; the benchmark's
clock marks each step's forward, backward and optimizer. With ``trace``
one more step follows, under the profiler.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List

import torch

from port_bench import check, trace as T, weights as W
from port_bench.reference import dac as ref_dac
from port_bench.reference import encoder as ref_encoder
from port_bench.reference import train as ref_train
from port_bench.system import build

STAGES = ["forward", "backward", "optimizer"]
FIRST_STEPS = 3


class Clock:
    """CUDA events at ``mark(name)`` (the clock ``make_train_step`` takes);
    ``ms()`` the intervals by the name of the mark that ends each."""

    def __init__(self):
        self.marks = []

    def mark(self, name: str):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev))

    def ms(self) -> Dict[str, float]:
        self.marks[-1][1].synchronize()
        return {n: a.elapsed_time(b) for (_, a), (n, b)
                in zip(self.marks, self.marks[1:])}


def make_batches(mix: dict, seed: int, device) -> List[dict]:
    B = mix["batch"]
    out = []
    for i in range(mix["pool"]):
        g = W.generator(device, seed, 20 + i)
        out.append({
            "frames": torch.randn(B, *mix["frames"], generator=g, device=device,
                                  dtype=torch.bfloat16),
            "audio": mix["audio_scale"] * torch.randn(
                B, 1, mix["audio_samples"], generator=g, device=device)})
    return out


def optimizer_kw(config: dict) -> dict:
    o = config["optimizer"]
    return dict(weight_decay=o["weight_decay"], betas=tuple(o["betas"]),
                gradient_clip_val=o["gradient_clip_val"],
                gradient_clip_algorithm=o["gradient_clip_algorithm"])


def run(cell: dict, *, seed: int, seconds: float, trace: bool, device,
        t0: float, patch=None, variant: Dict = None, warmup: bool = True
        ) -> dict:
    from vaura_tpu_torch.train.state import (
        TrainState,
        build_schedule,
        make_optimizer,
    )
    from vaura_tpu_torch.train.steps import make_train_step, split_params

    config, mix = cell["config_data"], cell["mix"]
    o = config["optimizer"]
    system, made = build(config, device, seed, encoder=True, training=True,
                         **(variant or {}))
    trainable, _ = split_params(system)
    lr = build_schedule(o["schedule_config"], o["learning_rate"])
    state = TrainState.create(trainable, make_optimizer(lr, **optimizer_kw(config)))
    step = make_train_step(system)
    if patch is not None:
        step = patch(system, step)
    batches = make_batches(mix, seed, device)
    cuda = device.type == "cuda"
    B = mix["batch"]

    # the first steps: warm-up, and what the reference follows
    seen: Dict[str, List[torch.Tensor]] = {"feats": [], "codes": []}
    enc, feat = system.encode_audio, system.visual_features

    def encode_audio(*a, **kw):
        out = enc(*a, **kw)
        seen["codes"].append(out.detach().clone())
        return out

    def visual_features(*a, **kw):
        out = feat(*a, **kw)
        seen["feats"].append(out.detach().float())
        return out

    kept = {n: vars(system).get(n) for n in ("encode_audio", "visual_features")}
    system.encode_audio, system.visual_features = encode_audio, visual_features
    losses, g1 = [], {}
    b1 = o["betas"][0]
    for k in range(FIRST_STEPS):
        state, m = step(state, batches[k], W.generator(device, seed, 200 + k))
        losses.append(m["loss"].item())
        if k == 0:
            g1 = {n.split(".", 1)[1]: (mu.float().norm() / (1 - b1)).item()
                  for n, mu in state.opt_state.mu.items()
                  if n.startswith("sampler.")}
    for n, fn in kept.items():  # the program's own (or a planted fault)
        if fn is None:
            delattr(system, n)
        else:
            setattr(system, n, fn)
    p0 = made["sampler"]
    d3 = {n: (state.params["sampler." + n].detach() - p0[n]).norm().item()
          for n in p0 if "sampler." + n in state.params}
    setup_s = time.perf_counter() - t0
    setup_peak = check.peak(device) or 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    steps: List[dict] = []
    traced = None
    start = time.perf_counter()
    while True:
        over = len(steps) >= 1 and time.perf_counter() - start >= seconds
        if over and (not trace or traced is not None):
            break
        k = FIRST_STEPS + len(steps)
        profiled = over  # a traced run's last step, once the time is up
        clock = Clock() if cuda else None
        a = time.perf_counter()
        with (T.profiled(device) if profiled else contextlib.nullcontext()) as prof:
            if clock:
                clock.mark("start")
            state, m = step(state, batches[k % len(batches)],
                            W.generator(device, seed, 200 + k), clock=clock)
            loss = m["loss"].item()
        b = time.perf_counter()
        if profiled:
            traced = T.summarise(prof, STAGES, b - a)
            del prof
        steps.append({"t0": a - start, "t1": b - start, "tokens": B * mix["codec_frames"],
                      "traced": profiled, "loss": loss,
                      "clock_ms": clock.ms() if clock else {}})
    peak_window = check.peak(device)
    memory_peak = max(setup_peak, peak_window or 0)  # the run's, before the reference
    del state, step, system, trainable
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    readings = compare_training(made, config, mix, batches[:FIRST_STEPS], seed,
                                device, losses, g1, d3, seen)
    complete = len(losses) == FIRST_STEPS and all(map(_finite, losses))
    correct, checks = check.verdict(readings, cell["limits"], complete)
    record = {
        "kind": "train", "setup_s": setup_s, "calls": steps,
        "window_s": steps[-1]["t1"] - steps[0]["t0"],
        "shapes": {"batch": B, "frames": mix["frames"],
                   "audio_samples": mix["audio_samples"],
                   "codec_frames": mix["codec_frames"]},
        "config": config, "peak_window_bytes": peak_window, "trace": traced,
        "correct": correct, "checks": checks, "readings": readings,
        "attempted": len(steps), "failed": 0,
        "device": {"memory_peak_bytes": memory_peak},
    }
    if traced:
        record["device"].update(busy_s=traced["busy_s"], window_s=traced["wall_s"])
        record["breakdown"] = traced["breakdown"]
    return record


def _finite(x: float) -> bool:
    return x == x and abs(x) != float("inf")


@torch.no_grad()
def reference_inputs(made, config, mix, batches, device, block: int = 4):
    """The frozen encoder's features and the codec's codes of each batch,
    worked out again in float32."""
    feats, codes = [], []
    with check.exact_matmuls():
        for b in batches:
            f, c = [], []
            for sl in ref_train.S.blocks(mix["batch"], block):
                f.append(ref_encoder.features(made["encoder"], config["encoder"],
                                              b["frames"][sl]))
                c.append(ref_dac.encode(made["dac"], config["codec"], b["audio"][sl]))
            feats.append(torch.cat(f))
            codes.append(torch.cat(c))
    return feats, codes


def follow(made, config, mix, batches, seed, device, feats, codes, matmul=None):
    """The reference over the first steps: ``(losses, first clipped
    gradient's leaf norms, leaf norms of the change after the steps)``."""
    o = config["optimizer"]
    opt = {"betas": o["betas"], "gradient_clip_val": o["gradient_clip_val"],
           "weight_decay": o["weight_decay"], "learning_rate": o["learning_rate"],
           "schedule": o["schedule_config"]["params"]}
    p0 = made["sampler"]
    params = {k: v.detach().float().clone() for k, v in p0.items()}
    adam = ref_train.AdamW(params, opt)
    losses, g1 = [], {}
    s_cfg = config["sampler"]
    with check.exact_matmuls():
        for k, (f, c) in enumerate(zip(feats, codes)):
            Sq = c.shape[-1] + c.shape[1]
            null_rows, masks, keep = ref_train.draw_masks(
                s_cfg, mix["batch"], Sq, W.generator(device, seed, 200 + k), device)
            loss, grads = ref_train.loss_and_grads(
                params, s_cfg, f, c, null_rows, masks, keep, mix["block"], matmul)
            del masks
            losses.append(loss)
            clipped = adam.step(grads)
            if k == 0:
                g1 = {n: g.norm().item() for n, g in clipped.items()}
            del grads, clipped
    d3 = {n: (params[n] - p0[n].float()).norm().item() for n in params}
    return losses, g1, d3


def compare_training(made, config, mix, batches, seed, device, losses, g1, d3,
                     seen) -> Dict[str, float]:
    feats, codes = reference_inputs(made, config, mix, batches, device)
    # the rows the program encoded (all of them in a sound run)
    out = {
        "feat_rel_err": max(check.rel_err(p, r[:len(p)]).max().item()
                            for p, r in zip(seen["feats"], feats)),
        "code_mismatch": max((p != r[:len(p)]).float().mean().item()
                             for p, r in zip(seen["codes"], codes)),
    }
    # The sampler's step follows from the codes the program's codec served
    # (``code_mismatch`` holds the codec on its own): its float32 products
    # run in TF32 and move a few per cent of the codes across a boundary,
    # which the loss would see far above the sampler's own rounding. Rows
    # the program did not encode keep the reference's codes.
    served = []
    for p, r in zip(seen["codes"], codes):
        c = r.clone()
        c[:len(p)] = p.to(c.device)
        served.append(c)
    r_losses, r_g1, r_d3 = follow(made, config, mix, batches, seed, device,
                                  feats, served)
    out["loss_rel_gap"] = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))
    out["grad_norm_gap"] = ref_train.worst_leaf_gap(g1, r_g1)
    out["update_norm_gap"] = ref_train.worst_leaf_gap(d3, r_d3)
    return out


def _half_batch(system, step):
    """Fault: half of the batch left out, the mean taken over the rest."""
    def half(state, batch, generator=None, clock=None):
        n = next(iter(batch.values())).shape[0] // 2
        return step(state, {k: v[:n] for k, v in batch.items()}, generator,
                    clock)
    return half


def _codes_altered(system, step):
    """Fault: every code the codec produces moved to the next entry."""
    enc = system.encode_audio
    V = system.sampler_config.d_codebook
    system.encode_audio = lambda audio: (enc(audio) + 1) % V
    return step


FAULTS = {"half_batch": _half_batch, "codes_altered": _codes_altered}
# the control: the program with a lower-precision path of its own on
CONTROLS = {"bf16_codec": {"codec_dtype": "bfloat16"}}


def calibration_run(cell: dict, variant: str, seed: int, device) -> dict:
    """``calibrate.py``'s reading of one seed: the first steps and one
    window step, compared as a run compares, by the program (``program``),
    with a planted fault (``FAULTS``), a control (``CONTROLS``), or
    ``fp8_reference``: the reference itself with its sampler products over
    e4m3-rounded operands, read against the float32 reference."""
    t0 = time.perf_counter()
    if variant != "fp8_reference":
        rec = run(cell, seed=seed, seconds=0, trace=False, device=device,
                  t0=t0, patch=FAULTS.get(variant), variant=CONTROLS.get(variant))
        return rec["readings"]
    config, mix = cell["config_data"], cell["mix"]
    system, made = build(config, device, seed, encoder=True, training=True)
    del system
    batches = make_batches(mix, seed, device)[:FIRST_STEPS]
    feats, codes = reference_inputs(made, config, mix, batches, device)
    ref = follow(made, config, mix, batches, seed, device, feats, codes)
    low = follow(made, config, mix, batches, seed, device, feats, codes,
                 matmul=ref_train.fp8_matmul)
    return {"loss_rel_gap": max(abs(a - b) / abs(b) for a, b in zip(low[0], ref[0])),
            "grad_norm_gap": ref_train.worst_leaf_gap(low[1], ref[1]),
            "update_norm_gap": ref_train.worst_leaf_gap(low[2], ref[2])}
