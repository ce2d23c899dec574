"""The port's codes precompute tool
(``vaura_tpu_torch/scripts/precompute_codes.py``) against the repo's
``scripts/precompute_codes.py`` on ``configs/experiments/dummy.yaml``.

Both tools run on the validation split (batch 2, 4 clips). The dummy dataset
draws no crops, so it has no ``video_len`` and neither tool writes a
manifest; both datasets are given one here, so the manifests are written and
compared. The JAX tool's system initialises only the codec it runs (its
``init_params`` patched: the whole system's init compiles for ~50 s here);
the port's ``encode_split`` over those codec weights, converted, must give
the JAX tool's codes exactly on the frames whose top-two margin exceeds 1e-4
at every RVQ stage, and those must be at least 90% of all
(``tests/test_torch_dac_encode.py``'s rule)."""

import itertools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import np_tree

from vaura_tpu_torch.convert import from_jax_params

REPO = Path(__file__).resolve().parents[1]
DUMMY = REPO / "configs/experiments/dummy.yaml"
ARGV = [str(DUMMY), "--split", "validation", "--batch", "2", "--limit", "4"]


def _codes(root):
    return {p.name: np.load(p) for p in sorted(root.glob("*.codes.npy"))}


def test_precompute_codes_matches_jax(tmp_path, monkeypatch):
    from scripts.precompute_codes import main as j_main

    from vaura_tpu.data import dummy as j_dummy
    from vaura_tpu.models.vaura import VauraSystem as JSystem
    from vaura_tpu_torch.data import dummy as t_dummy
    from vaura_tpu_torch.scripts import precompute_codes as pc

    for module in (j_dummy, t_dummy):
        monkeypatch.setattr(module.DummyDataset, "video_len", 2.56,
                            raising=False)

    n, dirs = pc.main([*ARGV, "--platform", "cpu", "--out",
                       str(tmp_path / "port")])
    port = _codes(tmp_path / "port")
    assert n == 4 and dirs == {tmp_path / "port"}
    assert list(port) == [f"{i}.codes.npy" for i in range(4)]
    for codes in port.values():
        # the tiny codec: 3 codebooks of 16, 48 frames of 2.56 s at 150 Hz
        assert codes.dtype == np.int16 and codes.shape == (3, 48)
        assert codes.min() >= 0 and codes.max() < 16

    kept = {}

    def init_codec(self, rng, *a, **kw):
        wav = jnp.zeros((1, 1, self.dac_config.hop_length * 4))
        kept["dac"] = jax.jit(lambda r: self.dac.init(r, wav))(rng)["params"]
        return {"dac": kept["dac"]}

    monkeypatch.setattr(JSystem, "init_params", init_codec)
    monkeypatch.setattr(sys, "argv", ["precompute_codes.py", *ARGV, "--out",
                                      str(tmp_path / "jax")])
    j_main()
    want = _codes(tmp_path / "jax")
    assert list(want) == list(port)
    manifests = [json.loads((tmp_path / d / "codes_meta.validation.json")
                            .read_text()) for d in ("port", "jax")]
    assert manifests[0] == manifests[1] == {
        "seed": 0, "video_len": 2.56, "split": "validation",
        "deterministic_train_crops": False}

    # the port's encode over the JAX tool's codec weights
    from vaura_tpu_torch.data import get_datamodule_from_type
    from vaura_tpu_torch.main import get_config
    from vaura_tpu_torch.models.factory import build_system

    cfg = get_config([f"config={DUMMY}"])
    system = build_system(cfg["model"], device="cpu")
    system.load_state_dicts(
        {"dac": from_jax_params({"dac": np_tree(kept["dac"])})["dac"]})
    dl_cfg = {**cfg["dataloader"], "batch_size": 2}
    datamodule = get_datamodule_from_type(dl_cfg["dataset_type"], dl_cfg)
    datamodule.setup("validation")
    loader = list(itertools.islice(datamodule.val_dataloader(), 2))
    out = tmp_path / "converted"
    out.mkdir()
    assert pc.encode_split(system, loader, out, limit=4) == (4, {out})
    got = _codes(out)
    assert list(got) == list(want)
    sure, same = [], []
    with torch.no_grad():
        for batch in loader:
            z = system.dac.encode_latent(torch.from_numpy(batch["audio"]))
            _, margins = system.dac.quantizer.encode(z, return_margins=True)
            sure.append((margins > 1e-4).all(dim=1).numpy())  # [B, T]
            for fp in batch["meta"]["filepath"]:
                name = f"{Path(fp).stem}.codes.npy"
                same.append((got[name] == want[name]).all(axis=0))
    sure, same = np.concatenate(sure), np.stack(same)
    assert sure.mean() >= 0.9
    assert same[sure].all()


def test_without_cuda_the_tool_raises(tmp_path, monkeypatch):
    from vaura_tpu_torch.scripts import precompute_codes as pc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pc.main([*ARGV, "--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
