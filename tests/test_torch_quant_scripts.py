"""The port's quantization-quality scripts (``vaura_tpu_torch/scripts/
int8_margin_check.py``, ``quant_quality_fad.py``) end to end at ``--tiny``
on the CPU, and their pieces against the JAX scripts': the JSON keys they
print, the arms, the proxy configurations and the overfit batch. The JAX
scripts themselves are not run here (minutes of jit on this CPU)."""

import ast
import dataclasses
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaura_tpu.models.sampler import SamplerConfig as JSamplerConfig
from vaura_tpu_torch.models.sampler import PORT_ONLY_FIELDS
from vaura_tpu_torch.scripts import int8_margin_check, quant_quality_fad
from vaura_tpu_torch.scripts.quant_proxy import proxy_config, proxy_device

REPO = Path(__file__).resolve().parents[1]
TINY = ["--tiny", "--platform", "cpu", "--steps", "3", "--batch", "2",
        "--gen-batch", "2", "--tokens", "16"]


def _json_keys(script: str) -> dict:
    """The keys of the dict literals inside the JAX script's final
    ``json.dumps(...)``: ``{"top": [...], "<key>": [...]}`` for the nested
    literals."""
    tree = ast.parse((REPO / "scripts" / script).read_text())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", None) == "dumps"]
    lit = calls[-1].args[0]
    out = {"top": [k.value for k in lit.keys]}
    for k, v in zip(lit.keys, lit.values):
        if isinstance(v, ast.Dict):
            out[k.value] = [kk.value for kk in v.keys]
    return out


def _jax_arms() -> list:
    """The quantized arms the JAX FAD script loops over."""
    tree = ast.parse((REPO / "scripts" / "quant_quality_fad.py").read_text())
    loops = [n for n in ast.walk(tree) if isinstance(n, ast.For)
             and isinstance(n.iter, ast.Tuple)]
    return [e.value for e in loops[-1].iter.elts]


def _finite(x) -> bool:
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    return not isinstance(x, float) or math.isfinite(x)


def test_int8_margin_check_tiny_on_the_cpu():
    got = int8_margin_check.main(TINY + ["--cache-bits", "4", "--int8-dots"])
    assert list(got) == _json_keys("int8_margin_check.py")["top"]
    assert got["cache_bits"] == 4 and got["int8_dots"] is True
    assert got["tokens"] == 16 and _finite(got)
    assert got["overfit_loss"] < math.log(1024)  # the loss fell
    for k in ("teacher_forced_argmax_agreement",
              "greedy_token_agreement_cfg1", "greedy_token_agreement_cfg6"):
        assert 0.0 <= got[k] <= 1.0


def test_quant_quality_fad_tiny_on_the_cpu():
    got = quant_quality_fad.main(TINY + ["--clips", "2"])
    keys = _json_keys("quant_quality_fad.py")
    assert list(got) == keys["top"]
    assert list(got["sampling"]) == keys["sampling"]
    assert list(got["arms"]) == _jax_arms() == list(quant_quality_fad.ARMS)
    for arm in got["arms"].values():
        assert list(arm) == ["fad", "kld_melband", "token_agreement"]
    assert got["scale"] == "tiny" and got["clips"] == 2 and _finite(got)
    assert got["overfit_loss"] < math.log(1024)


@pytest.mark.parametrize("scale", ["tiny", "mid", "flagship"])
def test_proxy_configs_match_the_jax_scripts(scale):
    want = JSamplerConfig(remat=True)
    if scale == "tiny":
        want = dataclasses.replace(want, num_layers=2, d_model=192, nhead=4,
                                   block_size_audio=64)
    elif scale == "mid":
        want = dataclasses.replace(want, num_layers=6, d_model=512, nhead=8)
    got = proxy_config(scale == "tiny", scale == "mid")
    for f in dataclasses.fields(got):
        if f.name in PORT_ONLY_FIELDS:  # the JAX package has no such field
            assert getattr(got, f.name) == PORT_ONLY_FIELDS[f.name], f.name
        elif not f.name.endswith("dtype"):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert jnp.dtype(want.param_dtype) == jnp.float32
    assert got.param_dtype == torch.float32


def test_the_overfit_batch_is_the_jax_scripts(monkeypatch):
    """Codes and features from ``default_rng(0)`` in the JAX scripts'
    order; and no silent CPU run without ``--platform``."""
    from vaura_tpu_torch.scripts import quant_proxy

    cfg = dataclasses.replace(proxy_config(True, False), num_layers=1)
    _, _, run = quant_proxy.overfit(cfg, torch.device("cpu"), steps=0,
                                    batch=2, lr=3e-4, tokens=5)
    rngb = np.random.default_rng(0)
    np.testing.assert_array_equal(run["codes"].numpy(),
                                  rngb.integers(0, 1024, (2, 9, 5)))
    np.testing.assert_array_equal(
        run["vis"].numpy(),
        rngb.standard_normal((2, 32, 768)).astype(np.float32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        proxy_device(None)
    with pytest.raises(ValueError):
        proxy_device("tpu")


@pytest.mark.parametrize("deterministic", [False, True])
def test_overfit_repeat_reports_the_runs_spread(deterministic):
    """``overfit_repeat`` runs the proxies' recipe twice in one process:
    on the CPU both runs take the same steps, so they end at one loss, the
    spread is 0 and no step parts them; the deterministic switch is
    restored afterwards."""
    from vaura_tpu_torch.scripts import overfit_repeat

    argv = ["--tiny", "--platform", "cpu", "--runs", "2", "--steps", "2",
            "--batch", "2", "--tokens", "16"]
    out = overfit_repeat.main(argv + (["--deterministic"] if deterministic
                                      else []))
    assert out["deterministic"] is deterministic and out["runs"] == 2
    assert len(out["losses"]) == 2 and len(out["losses"][0]) == 2
    assert out["losses"][0][-1] < out["losses"][0][0]
    assert out["spread"] == 0.0 and out["first_step_apart"] is None
    assert out["final_losses"][0] == out["final_losses"][1]
    assert not torch.are_deterministic_algorithms_enabled()
