"""A new configuration, traffic mix, cell and per-layer metric are added as
new files plus entries in BENCHMARK.json, and run, with no edit to a file
the benchmark already has."""

import hashlib
import json
import shutil

from port_bench import run as R

from tiny import make_tiny_tree

READER = '''"""Calls in the window (a count)."""


def read(rec):
    return float(len(rec["calls"]))
'''


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "port_bench").rglob("*")) if p.is_file()}


def test_add_cell_config_mix_and_metric(tmp_path):
    root = make_tiny_tree(tmp_path / "bench")
    before = digest(root)
    data = root / "port_bench"
    cfg = json.loads((data / "configs/vaura_vgg.json").read_text())
    cfg["name"] = "vaura_vgg_b"
    cfg["generate"]["cfg_scale"] = 3.0
    (data / "configs/vaura_vgg_b.json").write_text(json.dumps(cfg))
    mix = json.loads((data / "traffic/feats_b512.json").read_text())
    mix["batch"] = 6
    (data / "traffic/feats_b6.json").write_text(json.dumps(mix))
    (data / "workloads/gen_feats_b6.json").write_text(json.dumps({
        "config": "vaura_vgg_b", "traffic": "feats_b6", "chips": 1,
        "why": "a cell added as files",
        "limits": {"token_gap": 1.0, "wave_rel_err": 1.0}}))
    (data / "metrics/calls_in_window.py").write_text(READER)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "vaura_vgg_b", "source": "x",
                             "file": "port_bench/configs/vaura_vgg_b.json",
                             "reduced": [], "why": "added"})
    bench["workloads"].append({"name": "gen_feats_b6", "config": "vaura_vgg_b",
                               "traffic": "feats_b6", "chips": 1, "why": "added"})
    for m in bench["end_to_end"]:
        if m["name"] == "audio_s_per_s":
            m["workloads"].append("gen_feats_b6")
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                               "better": "higher", "source": "program_counter",
                               "layer": "whole call or step", "moves": "audio_s_per_s",
                               "workloads": ["gen_feats_b6"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    e2e = R.run_cell(root, "gen_feats_b6", 7, 0.0, 0, device="cpu")["result"]
    assert set(e2e["metrics"]) == {"audio_s_per_s", "setup_s"} and e2e["correct"]
    traced = R.run_cell(root, "gen_feats_b6", 7, 0.0, 1, device="cpu")["result"]
    assert traced["metrics"]["calls_in_window"]["value"] >= 1.0
    after = digest(root)
    assert all(after[p] == h for p, h in before.items())
    shutil.rmtree(root)
