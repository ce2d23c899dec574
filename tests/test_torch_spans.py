"""The span recorder (``vaura_tpu_torch/utils/spans.py``): off, it records
nothing and makes no CUDA event; on, it records nested spans on the clock
of ``torch.profiler``; a generation call and a training step record the
spans of their layers, with no CUDA event beyond ``StageClock``'s marks
and no ``record_function`` range, and ``StageClock`` reads the same either
way."""

import collections

import pytest
import torch

from vaura_tpu_torch.models.dac.model import DacConfig
from vaura_tpu_torch.models.motionformer import MotionFormerConfig
from vaura_tpu_torch.models.sampler import SamplerConfig
from vaura_tpu_torch.models.vaura import VauraSystem
from vaura_tpu_torch.train.state import TrainState, make_optimizer
from vaura_tpu_torch.train.steps import make_train_step, split_params
from vaura_tpu_torch.utils import StageClock, seeded_init_
from vaura_tpu_torch.utils import spans as SP

STEPS = 6  # max_new_tokens 4 over 3 codebooks: 4 + 3 - 1 steps


def _refuse(*a, **kw):
    raise AssertionError("created where none may be")


@pytest.fixture
def no_event_no_range(monkeypatch):
    """``torch.cuda.Event`` and ``record_function`` raise when made."""
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__",
                        _refuse)


def tiny_system(training: bool = False) -> VauraSystem:
    sampler = SamplerConfig(num_layers=1, d_model=48, d_codebook=16,
                            num_codebooks=3, nhead=2, cond_in_dim=32,
                            block_size_audio=32, block_size_video=16)
    encoder = MotionFormerConfig(embed_dim=32, depth=1, num_heads=2,
                                 img_size=32, temporal_resolution=2)
    dac = DacConfig(encoder_dim=4, decoder_dim=16, n_codebooks=3,
                    codebook_size=16)
    system = VauraSystem(sampler, dac, encoder, device="cpu",
                         freeze_feature_extractor=True)
    seeded_init_(system, torch.Generator().manual_seed(0))
    if not training:
        system.requires_grad_(False)
    return system


def frames(batch: int) -> torch.Tensor:
    return torch.randn(batch, 2, 3, 4, 32, 32,
                       generator=torch.Generator().manual_seed(1))


def generate(system, **kw):
    return system.generate(frames(4), seed=0, max_new_tokens=4, top_k=4,
                           cfg_scale=2.0, encoder_chunk_size=2,
                           dac_chunk_size=2, **kw)


def test_off_records_nothing(no_event_no_range):
    assert SP.span("a") is SP.span("b")  # one shared object
    with SP.span("a"):
        with SP.span("a.b"):
            pass
    assert SP.stage_edge("a", None) is None
    with SP.recording() as rec:
        pass
    assert rec == []
    with SP.span("after"):
        pass
    assert rec == []


def test_nesting_and_dotted_names():
    with SP.recording() as rec:
        with SP.span("step"):
            with SP.span("step.forward"):
                with SP.span("step.forward.inner"):
                    pass
            with SP.span("step.sample"):
                pass
        with pytest.raises(RuntimeError):
            with SP.recording():
                pass
    by = {name: (depth, a, b) for name, depth, a, b in rec}
    assert [r[0] for r in rec] == ["step.forward.inner", "step.forward",
                                   "step.sample", "step"]  # as they close
    assert [by[n][0] for n in ("step", "step.forward", "step.forward.inner",
                               "step.sample")] == [0, 1, 2, 1]
    for child, parent in (("step.forward", "step"), ("step.sample", "step"),
                          ("step.forward.inner", "step.forward")):
        assert by[parent][1] <= by[child][1] <= by[child][2] <= by[parent][2]
    assert by["step.forward"][2] <= by["step.sample"][1]


def test_spans_share_the_profilers_clock():
    """A span around an operator holds the operator's kineto event."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            SP.recording() as rec:
        for _ in range(3):
            with SP.span("mm"):
                torch.mm(a, a)
    ops = sorted((e.start_ns(), e.end_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name() == "aten::mm")
    spans = sorted((t0, t1) for _, _, t0, t1 in rec)
    assert len(ops) == len(spans) == 3
    slack = 5_000  # ns
    for (e0, e1), (s0, s1) in zip(ops, spans):
        assert s0 - slack <= e0 <= e1 <= s1 + slack
        assert e0 - s0 < 1_000_000  # the same clock, not one close by


def test_generate_records_its_layers(no_event_no_range):
    system = tiny_system()
    off = generate(system)  # nothing recorded, the same codes
    with SP.recording() as rec:
        out = generate(system)
    assert torch.equal(out["codes"], off["codes"])
    assert set(out["stage_ms"]) == set(off["stage_ms"])
    names = collections.Counter(r[0] for r in rec)
    assert names["decode_step"] == STEPS
    assert names["decode_step.forward"] == names["decode_step.sample"] == STEPS
    assert names["decode_setup"] == names["decode_revert"] == 1
    assert names["encoder.chunk"] == names["dac.slice"] == 2
    assert names["encoder.blocks"] == 2
    assert {n: names[n] for n in ("encoder", "decode_loop", "dac")} == {
        "encoder": 1, "decode_loop": 1, "dac": 1}
    stage = {r[0]: r for r in rec if r[0] in ("encoder", "decode_loop", "dac")}
    assert stage["encoder"][3] == stage["decode_loop"][2]
    assert stage["decode_loop"][3] == stage["dac"][2]
    steps = sorted(r for r in rec if r[0] == "decode_step")
    for _, depth, a, b in steps:
        kids = [r for r in rec if r[0].startswith("decode_step.")
                and a <= r[2] <= r[3] <= b]
        assert sorted(k[0] for k in kids) == ["decode_step.forward",
                                              "decode_step.sample"]
        assert all(k[1] == depth + 1 for k in kids)
        assert stage["decode_loop"][2] <= a <= b <= stage["decode_loop"][3]
    assert out["codes"].shape == (4, 3, 4)


def test_train_step_records_its_six_parts(no_event_no_range):
    system = tiny_system(training=True)
    trainable, _ = split_params(system)
    state = TrainState.create(trainable, make_optimizer(1e-4))
    step = make_train_step(system)
    batch = {"frames": frames(2),
             "audio": 0.1 * torch.randn(2, 1, 512 * 6 - 100,
                                        generator=torch.Generator().manual_seed(2))}
    state, m = step(state, batch, torch.Generator().manual_seed(3))  # off
    with SP.recording() as rec:
        state, m = step(state, batch, torch.Generator().manual_seed(3))
    names = collections.Counter(r[0] for r in rec if r[0].startswith("train."))
    assert names == {f"train.{n}": 1 for n in (
        "codec_encode", "encoder", "sampler", "loss", "backward", "optimizer")}
    order = [r[0] for r in sorted(rec, key=lambda r: r[2])
             if r[0].startswith("train.")]
    assert order == ["train.codec_encode", "train.encoder", "train.sampler",
                     "train.loss", "train.backward", "train.optimizer"]
    assert torch.isfinite(m["loss"])


class _FakeEvent:
    made = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1
        self.t = 0.0

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 1.0


@pytest.mark.parametrize("on", [False, True])
def test_stage_clock_same_marks_and_keys(monkeypatch, on):
    """With spans on or off a clock on the card makes one CUDA event a mark
    and reads the same intervals; on, each interval is a span too."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.made = 0
    with SP.recording() if on else SP.span("off") as rec:
        clock = StageClock(torch.device("cuda"))
        for name in ("start", "encoder", "decode_loop", "dac"):
            clock.mark(name)
        ms = clock.ms()
    assert _FakeEvent.made == 4
    assert ms == {"encoder": 1.0, "decode_loop": 1.0, "dac": 1.0}
    if on:
        assert [r[0] for r in rec] == ["encoder", "decode_loop", "dac"]
    cpu = StageClock(torch.device("cpu"))
    for name in ("start", "encoder", "decode_loop"):
        cpu.mark(name)
    assert set(cpu.ms()) == {"encoder", "decode_loop"}


class _Ev:
    def __init__(self, name, dev, a, b, corr):
        self._v = (name, dev, a, b, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return type("D", (), {"name": self._v[1]})

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def test_profile_span_report_joins_by_correlation():
    """The profiling scripts' report: a kernel counts to the spans that hold
    the start of the call that launched it, wherever it runs, and device
    time is the union of such kernels' intervals."""
    from vaura_tpu_torch.profile_generate import span_report

    ev = [_Ev("cudaLaunchKernel", "CPU", 10, 12, 1),
          _Ev("Activity Buffer Request", "CPU", 11, 12, 1),
          _Ev("cudaLaunchKernel", "CPU", 14, 15, 2),
          _Ev("cudaLaunchKernel", "CPU", 30, 31, 3),
          _Ev("k", "CUDA", 20, 40, 1), _Ev("k", "CUDA", 30, 45, 2),
          _Ev("j", "CUDA", 50, 55, 3)]
    prof = type("P", (), {"profiler": type("Q", (), {
        "kineto_results": type("R", (), {"events": staticmethod(lambda: ev)})})})
    rec = [("step.forward", 1, 9, 13), ("step", 0, 8, 16), ("step", 0, 29, 33)]
    rep = span_report(prof, rec)
    assert list(rep) == ["step", "step.forward"]
    assert rep["step"]["count"] == 2 and rep["step"]["launches"] == 3
    assert rep["step"]["host_ms"] == pytest.approx(12e-6)
    assert rep["step"]["device_busy_ms"] == pytest.approx(30e-6)
    assert rep["step.forward"]["device_busy_ms"] == pytest.approx(20e-6)
    assert rep["step.forward"]["top_kernels"] == [
        {"name": "k", "launches": 1, "ms": pytest.approx(20e-6)}]
