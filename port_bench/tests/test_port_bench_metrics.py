"""Every metric of BENCHMARK.json has a reader, each reader reads a
synthetic record of its kind (and nothing from the other kind), and the
trace reduction works on a synthetic event list."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from port_bench import run as R
from port_bench import trace as T

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
GEN_CONFIG = json.loads((REPO / "port_bench/configs/vaura_vgg.json").read_text())
TRAIN_CONFIG = json.loads((REPO / "port_bench/configs/vaura_vgg_train.json").read_text())

TRACE = {"wall_s": 10.0, "busy_s": 7.5,
         "kernels": {"void serve_kernel<96, 8>(...)": [5496, 1.0],
                     "group_attention_kernel": [24, 0.5],
                     "gemm_bias_kernel": [72, 1.0], "layernorm_rows_kernel": [72, 0.1]},
         "stages": {"decode_loop": {"launches": 229 * 1000, "host_s": 6.0},
                    "forward": {"launches": 10, "host_s": 0.5}},
         "breakdown": {"device_ops": [], "idle_gaps": []}}


def gen_record(frames: bool) -> dict:
    calls = [{"t0": 10.0 * i, "t1": 10.0 * i + 10.0, "clips": 512,
              "audio_s": 1313.7, "traced": i == 1,
              "stage_ms": {"encoder": 3000.0 if frames else 0.01,
                           "decode_loop": 6000.0, "dac": 3300.0}}
             for i in range(4)]
    return {"kind": "generate", "setup_s": 20.0, "calls": calls, "window_s": 40.0,
            "shapes": {"batch": 512, "tokens": 221, "steps": 229, "encoder": frames,
                       "frames": [4, 3, 16, 224, 224] if frames else None},
            "config": GEN_CONFIG, "peak_window_bytes": 2 ** 34, "trace": TRACE}


def train_record() -> dict:
    calls = [{"t0": 1.0 * i, "t1": 1.0 * i + 1.0, "tokens": 48 * 221,
              "traced": i == 1, "loss": 7.0,
              "clock_ms": {"forward": 400.0, "backward": 550.0, "optimizer": 30.0}}
             for i in range(5)]
    return {"kind": "train", "setup_s": 15.0, "calls": calls, "window_s": 5.0,
            "shapes": {"batch": 48, "frames": [4, 3, 16, 224, 224],
                       "audio_samples": 112896, "codec_frames": 221},
            "config": TRAIN_CONFIG, "peak_window_bytes": 2 ** 35,
            "trace": dict(TRACE, wall_s=1.0, busy_s=0.75)}


@pytest.mark.parametrize("name", METRICS)
def test_reader(name):
    read = R.load_reader(REPO, name)
    m = next(m for m in BENCH["end_to_end"] + BENCH["per_layer"] if m["name"] == name)
    cells = m.get("workloads", [w["name"] for w in BENCH["workloads"]])
    kinds = {"train" if c.startswith("train") else "generate" for c in cells}
    records = {"generate": gen_record(frames="gen_frames_b512" in cells),
               "train": train_record()}
    shared = not (REPO / "port_bench" / "metrics" / f"{name}.py").exists()
    for kind, rec in records.items():
        v = read(rec)
        if kind in kinds or shared:  # a shared reader reads either kind
            assert isinstance(v, float) and v == v and v >= 0, (name, kind, v)
            if m["unit"] == "%":
                assert v <= 100.0
        else:
            assert v is None, (name, kind)


def test_reader_values():
    rec = gen_record(frames=True)
    read = lambda n: R.load_reader(REPO, n)(rec)
    assert read("audio_s_per_s") == pytest.approx(4 * 1313.7 / 40.0)
    assert read("decode_ms_per_step.gen") == pytest.approx(6000.0 / 229)
    assert read("encoder_ms_per_clip.gen") == pytest.approx(3000.0 / 512)
    assert read("dac_ms_per_audio_s.gen") == pytest.approx(3300.0 / 1313.7)
    assert read("decode_launches_per_step.gen") == pytest.approx(1000.0)
    assert read("device_idle_pct.gen") == pytest.approx(25.0)
    assert read("peak_mem_gib.gen") == pytest.approx(16.0)
    tr = train_record()
    assert R.load_reader(REPO, "train_tokens_per_s")(tr) == pytest.approx(5 * 48 * 221 / 5.0)
    assert R.load_reader(REPO, "backward_ms.train")(tr) == pytest.approx(550.0)


def test_shared_reader_and_faulty_record():
    """``device_idle_pct.gen`` and ``.train`` share one reader, which raises
    where the traced call's busy seconds pass the untraced calls' wall."""
    files = {R.load_reader(REPO, n).__code__.co_filename
             for n in ("device_idle_pct.gen", "device_idle_pct.train")}
    assert files == {str(REPO / "port_bench" / "metrics" / "device_idle_pct.py")}
    assert R.load_reader(REPO, "device_idle_pct.train")(train_record()) == \
        pytest.approx(25.0)
    rec = gen_record(frames=False)
    rec["trace"] = dict(TRACE, busy_s=10.5)
    with pytest.raises(ValueError):
        R.load_reader(REPO, "device_idle_pct.gen")(rec)


class _Event:
    def __init__(self, name, dev, a, b):
        self._n, self._d, self._a, self._b = name, dev, a, b

    def name(self):
        return self._n

    def device_type(self):
        return SimpleNamespace(name=self._d)

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b


def test_summarise_synthetic_events():
    ev = [_Event("cudaEventRecord", "CPU", 0, 1),
          _Event("cudaLaunchKernel", "CPU", 2, 3), _Event("k1", "CUDA", 5, 15),
          _Event("cudaEventRecord", "CPU", 20, 21),
          _Event("cudaLaunchKernel", "CPU", 22, 23),
          _Event("cudaLaunchKernel", "CPU", 24, 25), _Event("k2", "CUDA", 30, 40),
          _Event("k2", "CUDA", 40, 60), _Event("cudaEventRecord", "CPU", 70, 71)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev)))
    s = T.summarise(prof, ["a", "b"], wall_s=1e-7)
    assert s["busy_s"] == pytest.approx(40e-9)
    assert s["stages"]["a"]["launches"] == 1 and s["stages"]["b"]["launches"] == 2
    assert s["kernels"]["k2"] == [2, pytest.approx(30e-9)]
    assert s["breakdown"]["idle_gaps"] == [["a/host code", pytest.approx(15e-9)]]
    assert T.kernel_seconds(s, ["k"]) == (pytest.approx(40e-9), 3)
