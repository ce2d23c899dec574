"""Each cell's runner, at a tiny size on the CPU, prints a last line of the
contract's shape; without a card the command exits non-zero and prints no
result."""

import json

import pytest

from port_bench import run as R

from tiny import cells

SEED = 2 ** 33 + 17  # more than 32 signed bits hold


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", cells())
def test_cell_line(tiny_tree, cell, trace):
    out = R.run_cell(tiny_tree, cell, SEED, 0.5, trace, device="cpu")
    line = json.loads(json.dumps(out["result"]))
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    bench = json.loads((tiny_tree / "BENCHMARK.json").read_text())
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    wanted = {m["name"] for m in R.cell_metrics(bench, cell, trace)}
    assert set(line["metrics"]) <= wanted
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    if not trace:  # the host-clock metrics read on any device
        assert wanted == set(line["metrics"])
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name


def test_no_card_no_result(tiny_tree, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tiny_tree)
    rc = R.main(["--workload", cells()[0], "--seed", str(SEED), "--seconds", "1",
                 "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "is_available" in out.err


def test_same_seed_same_inputs_and_weights(tiny_tree):
    """Two runs of one seed judge the same served outputs."""
    a = R.run_cell(tiny_tree, "gen_feats_b512", SEED, 0.0, 0, device="cpu")
    b = R.run_cell(tiny_tree, "gen_feats_b512", SEED, 0.0, 0, device="cpu")
    assert a["record"]["readings"] == b["record"]["readings"]
