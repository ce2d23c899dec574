"""Serving from exported graphs (``vaura_tpu_torch/utils/aot.py``, the
counterpart of ``vaura_tpu/utils/aot.py``) on the CPU, at the tiny system of
``tests/test_aot.py`` (2 layers, d=48, 3 codebooks, float32) with the JAX
package's weights carried by ``from_jax_params``:

* export, then load, against the port's eager ``generate`` with the same
  seed: codes bit-equal and audio within 1e-6, greedy with the unquantized
  cache and sampled (top-k, CFG) with the int8 cache (``quantize=cache``)
  and with int8 weights (``quantize=true``) over the int4 cache under int8 x
  int8 products; the artifact holds no tensor of the state;
* greedy aot codes equal to the JAX package's jitted ``generate``;
* the server: ``aot_export`` then ``aot_load`` give the eager server's
  codes; each mismatch and exclusion raises ``ValueError`` with JAX's words;
  an artifact of another device type is refused;
* a fresh process loads the artifact and answers without importing
  ``vaura_tpu_torch.models``.
"""

import io
import json
import subprocess
import sys
import zipfile
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (
    CPU,
    J_DAC,
    J_SAMPLER,
    np_tree,
    port_dac_config,
    port_sampler_config,
    randomize_sampler_heads,
)

from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.models.vaura import VauraSystem as TSystem
from vaura_tpu_torch.utils.aot import (
    export_generate,
    load_generate,
    serving_state,
)

REPO = Path(__file__).resolve().parents[1]
B, TV, N_TOKENS, SEED = 2, 8, 20, 7
SAMPLING = dict(use_sampling=True, temp=1.0, top_k=8, cfg_scale=3.0)
GREEDY = dict(use_sampling=False, cfg_scale=3.0)
MODES = {"unquantized": ({}, GREEDY),
         "quantize=cache": ({"quantize_cache": True}, SAMPLING),
         "quantize=true,int4,int8_dots": (
             {"quantize_weights": True, "quantize_cache": True,
              "cache_bits": 4, "int8_dots": True}, SAMPLING)}


@pytest.fixture(scope="module")
def tiny():
    """``(JAX system, its parameters, the numpy tree)`` of the tiny system
    without an encoder (features in): the sampler as JAX initialises it,
    ``lm_head`` filled with seeded values so that a greedy choice is no tie;
    the codec's leaves seeded numpy values of ``jax.eval_shape``'s shapes
    (Snake's alphas in [0.5, 2]), which spares compiling its ``init``."""
    from vaura_tpu.models.vaura import VauraSystem as JSystem

    jsys = JSystem(sampler_config=J_SAMPLER, dac_config=J_DAC,
                   encoder_config=None, use_visual_conditioning=True)
    r_dac, r_sam = jax.random.split(jax.random.PRNGKey(0))
    codes = jnp.zeros((1, J_DAC.n_codebooks, 2), jnp.int32)
    shapes = jax.eval_shape(lambda r: jsys.dac.init(
        r, codes, method=jsys.dac.decode), r_dac)["params"]
    rng = np.random.default_rng(1)
    dac = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (rng.uniform(0.5, 2.0, leaf.shape)
                            if path[-1].key == "alpha" else
                            0.1 * rng.standard_normal(leaf.shape)
                            ).astype(np.float32), shapes)
    params = {
        "dac": dac,
        "sampler": jax.jit(lambda r: jsys.sampler.init(
            {"params": r, "dropout": r, "cfg_dropout": r},
            jnp.zeros((1, J_SAMPLER.num_codebooks, 16), jnp.int32),
            jnp.zeros((1, 8, J_SAMPLER.cond_in_dim)), False))(r_sam)["params"],
    }
    tree = np_tree(params)
    tree["sampler"] = randomize_sampler_heads(tree["sampler"], 100)
    return jsys, jax.tree_util.tree_map(jnp.asarray, tree), tree


def port_system(tree, **sampler_extra) -> TSystem:
    """The port's tiny system on ``tree``; a mode's sampler settings
    applied as the server applies them (``_replace_sampler``: int8 weights
    quantized from the loaded ones)."""
    from vaura_tpu_torch.scripts.generate import _replace_sampler

    tsys = TSystem(port_sampler_config(), port_dac_config(), None,
                   device=CPU)
    tsys.load_state_dicts(from_jax_params(tree))
    tsys.requires_grad_(False)
    if sampler_extra:
        _replace_sampler(tsys, **sampler_extra)
    return tsys


def _feats(seed=0) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B, TV, J_SAMPLER.cond_in_dim)).astype(np.float32))


@pytest.fixture(scope="module")
def artifacts(tiny, tmp_path_factory):
    """One exported artifact per mode the server serves: greedy with the
    unquantized cache (also held to JAX), sampled with the int8 cache
    (``quantize=cache``), and sampled with int8 weights (``quantize=true``)
    over the int4 cache under int8 x int8 products (the JAX package's 8
    chunks as the probabilities' groups)."""
    root = tmp_path_factory.mktemp("aot")
    out = {}
    for name, (extra, sampling) in MODES.items():
        tsys = port_system(tiny[2], **extra)
        path = root / f"{name.replace('=', '_')}.pt2"
        meta = export_generate(tsys, batch=B, tv=TV, max_new_tokens=N_TOKENS,
                               path=path, sampling=sampling)
        out[name] = (tsys, path, meta, sampling)
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_export_load_equals_eager_generate(artifacts, mode):
    tsys, path, meta, sampling = artifacts[mode]
    assert meta == json.loads(Path(f"{path}.json").read_text())
    assert meta["batch"] == B and meta["tv"] == TV and meta["cond_dim"] == 24
    assert meta["device"] == "cpu" and meta["sample_rate"] == 44100
    assert meta["sampling"] == {k: str(v) for k, v in sampling.items()}
    fn, meta2 = load_generate(path, CPU)
    assert meta2 == meta
    state = serving_state(tsys)
    audio, codes = fn(state, _feats(), SEED)
    want = tsys.generate(vis_feats=_feats(), seed=SEED,
                         max_new_tokens=N_TOKENS, tokens_per_frame=7,
                         **sampling)
    assert codes.shape == (B, 3, N_TOKENS)
    assert torch.equal(codes, want["codes"])
    torch.testing.assert_close(audio, want["audio"], rtol=0, atol=1e-6)
    if sampling["use_sampling"]:
        # another seed draws other tokens: the noise comes in at each step
        assert not torch.equal(fn(state, _feats(), SEED + 1)[1], codes)
    # no tensor of the state is in the artifact: only the graphs and the
    # constants they make (the pattern's tables, the validity mask)
    state_bytes = sum(t.numel() * t.element_size() for t in state.values())
    const_bytes = 0
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            if not name.endswith(".pt2"):
                continue
            inner = zipfile.ZipFile(io.BytesIO(zf.read(name)))
            for info in inner.infolist():
                assert "/weights/model_weights_config" in info.filename or \
                    "/weights/" not in info.filename, info.filename
                if "/constants/tensor" in info.filename:
                    const_bytes += info.file_size
    assert const_bytes < 0.01 * state_bytes


def test_greedy_aot_codes_equal_jax_jitted_generate(tiny, artifacts):
    jsys, jparams, _ = tiny
    tsys, path, _, _ = artifacts["unquantized"]
    feats = _feats(3)

    def direct(p, f):
        return jsys.generate(p, None, jax.random.PRNGKey(0), vis_feats=f,
                             max_new_tokens=N_TOKENS, tokens_per_frame=7,
                             decode_to_audio=False, decode_buckets=1,
                             **GREEDY)["codes"]

    want = np.asarray(jax.jit(direct)(jparams, jnp.asarray(feats.numpy())))
    fn, _ = load_generate(path, CPU)
    _, codes = fn(serving_state(tsys), feats, 0)
    np.testing.assert_array_equal(codes.numpy(), want)


def _serve_cfg(**overrides):
    from vaura_tpu_torch.config import assemble_config

    cfg = dict(assemble_config(
        [f"config={REPO / 'configs/experiments/dummy.yaml'}",
         "trainer.platform=cpu"],
        defaults_path=REPO / "configs" / "vaura_defaults.yaml",
        base_dir=REPO))
    cfg.update({"batch": 1, "duration": 0.15, "top_k": 8, "max_wait_ms": 10,
                **overrides})
    return cfg


def test_serve_aot_roundtrip_and_refusals(tmp_path, monkeypatch):
    """``aot_export`` writes the artifact after the warm-up; a second
    service with ``aot_load`` answers from it with the eager path's codes
    (both seed each batch alike). JAX's ``ValueError``s: a shape or sampling
    mismatch, ``batch_buckets`` and a serving mesh with AOT, and here an
    artifact traced for another device type."""
    from vaura_tpu_torch.scripts import serve
    from vaura_tpu_torch.scripts.serve import GenerationService

    art = tmp_path / "serve.pt2"
    svc = GenerationService(_serve_cfg(aot_export=str(art)))
    svc.start()
    feats = np.random.default_rng(2).standard_normal(
        (4, svc.cond_dim)).astype(np.float32)
    codes_eager = svc.submit(feats, want="codes")
    svc.close(timeout=10)
    assert art.exists()

    svc2 = GenerationService(_serve_cfg(aot_load=str(art)))
    svc2.start()
    codes_aot = svc2.submit(feats, want="codes")
    svc2.close(timeout=10)
    np.testing.assert_array_equal(codes_eager, codes_aot)

    with pytest.raises(ValueError, match="batch=1 does not match"):
        GenerationService(_serve_cfg(batch=3, aot_load=str(art)))
    with pytest.raises(ValueError, match="sampling .* does not match"):
        GenerationService(_serve_cfg(top_k=4, aot_load=str(art)))
    with pytest.raises(ValueError, match="batch_buckets and aot_export"):
        GenerationService(_serve_cfg(batch=2, batch_buckets="1",
                                     aot_export=str(art)))
    mesh = SimpleNamespace(mesh_dim_names=("data", "fsdp", "model"),
                           mesh=SimpleNamespace(shape=(2, 1, 1)))
    with monkeypatch.context() as m:
        m.setattr(serve, "_serving_mesh", lambda *a: mesh)
        with pytest.raises(ValueError, match="mesh serving are mutually"):
            GenerationService(_serve_cfg(aot_load=str(art)))
    meta_path = Path(f"{art}.json")
    meta = json.loads(meta_path.read_text())
    meta_path.write_text(json.dumps({**meta, "device": "cuda"}))
    with pytest.raises(ValueError, match="does not load on 'cpu'"):
        load_generate(art, CPU)


def test_artifact_loads_without_the_model_code(artifacts, tmp_path):
    """A fresh process loads the artifact and the saved state and answers
    one batch: the eager codes, and ``vaura_tpu_torch.models`` (and JAX)
    never imported."""
    tsys, path, _, sampling = artifacts["quantize=cache"]
    torch.save(serving_state(tsys), tmp_path / "state.pt")
    torch.save(_feats(), tmp_path / "feats.pt")
    code = f"""
import sys, torch
from vaura_tpu_torch.utils.aot import load_generate
fn, meta = load_generate({str(path)!r}, "cpu")
state = torch.load({str(tmp_path / 'state.pt')!r}, weights_only=True)
feats = torch.load({str(tmp_path / 'feats.pt')!r}, weights_only=True)
audio, codes = fn(state, feats, {SEED})
bad = [m for m in sys.modules if m.startswith("vaura_tpu_torch.models")
       or m.split(".")[0] in ("jax", "vaura_tpu")]
assert not bad, bad
torch.save(codes, {str(tmp_path / 'codes.pt')!r})
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    want = tsys.generate(vis_feats=_feats(), seed=SEED,
                         max_new_tokens=N_TOKENS, tokens_per_frame=7,
                         decode_to_audio=False, **sampling)["codes"]
    assert torch.equal(torch.load(tmp_path / "codes.pt"), want)
