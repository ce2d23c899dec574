"""The port's placement rules (``vaura_tpu_torch/parallel``) against the JAX
package's, in one process.

  * ``spec_for`` is JAX's on every JAX parameter path of the tiny and the
    flagship trees (``jax.eval_shape``: no compilation);
  * ``port_spec`` maps each of the port's parameters to its JAX path
    (``convert.py``'s names) and transposes JAX's spec to the ``[out, in]``
    layout; the leaves placed otherwise than JAX's spec says are exactly
    the ones ``partitioning.py`` lists, asserted by name;
  * ``mesh_shape`` against JAX's ``make_mesh`` shapes
    (``tests/test_sharding.py::test_mesh_shapes``);
  * the head-aligned ``wqkv`` rows of each model rank at model 2 and 4
    equal JAX's kernel columns of that rank's heads (exact: a selection);
  * ``batch_rows`` and ``shard_batch``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from torch_port_util import (
    init_jax_system,
    port_dac_config,
    port_encoder_config,
    port_sampler_config,
)

from vaura_tpu.models.motionformer import MotionFormer as JMF
from vaura_tpu.models.motionformer import MotionFormerConfig as JEncConfig
from vaura_tpu.models.sampler import Sampler as JSampler
from vaura_tpu.models.sampler import SamplerConfig as JSamplerConfig
from vaura_tpu.parallel.mesh import make_mesh as j_make_mesh
from vaura_tpu.parallel.partitioning import spec_for as j_spec_for
from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.models.motionformer import MotionFormerConfig
from vaura_tpu_torch.models.sampler import SamplerConfig
from vaura_tpu_torch.models.vaura import VauraSystem
from vaura_tpu_torch.parallel import mesh as tmesh
from vaura_tpu_torch.parallel import partitioning as tp


def _flagship_jax_paths():
    """``{path: ndim}`` of the flagship sampler's and encoder's JAX trees."""
    scfg, ecfg = JSamplerConfig(), JEncConfig()
    s = jax.eval_shape(
        lambda r: JSampler(scfg).init(
            {"params": r, "dropout": r, "cfg_dropout": r},
            jnp.zeros((1, scfg.num_codebooks, 16), jnp.int32),
            jnp.zeros((1, 8, scfg.cond_in_dim)), False)["params"],
        jax.random.PRNGKey(0))
    e = jax.eval_shape(
        lambda r: JMF(ecfg).init(r, jnp.zeros((1, 1, 3, 16, 224, 224)))[
            "params"], jax.random.PRNGKey(0))
    flat = flatten_dict({"sampler": s, "encoder": e})
    return {"/".join(k): len(v.shape) for k, v in flat.items()}


@pytest.fixture(scope="module")
def trees():
    _, tiny = init_jax_system(0)
    tiny_paths = {"/".join(k): np.ndim(v)
                  for k, v in flatten_dict(tiny).items()}
    port_tiny = VauraSystem(port_sampler_config(), port_dac_config(),
                            port_encoder_config(), device="cpu")
    port_flagship = VauraSystem(SamplerConfig(), port_dac_config(),
                                MotionFormerConfig(), device="meta")
    return {"tiny": (tiny_paths, tiny, port_tiny),
            "flagship": (_flagship_jax_paths(), None, port_flagship)}


@pytest.mark.parametrize("which", ["tiny", "flagship"])
def test_spec_for_is_jaxs_on_every_path(trees, which):
    paths = trees[which][0]
    assert len(paths) > 40
    for path, ndim in paths.items():
        assert tp.spec_for(path, ndim) == tuple(j_spec_for(path, ndim)), path


@pytest.mark.parametrize("which", ["tiny", "flagship"])
def test_port_spec_is_jaxs_in_the_port_layout(trees, which):
    paths, _, system = trees[which]
    specs = tp.param_specs(system)
    checked = 0
    for name, spec in specs.items():
        if name.startswith("dac."):  # the codec is replicated, in JAX too
            assert spec == (), name
            continue
        ndim = system.get_parameter(name).ndim
        path, perm, stacked = tp.jax_path(name, ndim)
        assert paths[path] == ndim + stacked, name
        j = tuple(j_spec_for(path, ndim + stacked))
        if not j:
            assert spec == (), name
        else:
            assert spec == tuple(j[stacked:][perm[d]] for d in range(ndim)), name
        checked += 1
    assert checked > 30


def test_two_axis_specs_are_transposed():
    assert tp.spec_for("sampler/layers/attention/wqkv/kernel", 3) == (
        None, "fsdp", "model")
    assert tp.port_spec("sampler.layers.0.attention.wqkv.weight", 2) == (
        "model", "fsdp")
    assert tp.port_spec("sampler.layers.3.feed_forward.w2.weight", 2) == (
        "fsdp", "model")
    assert tp.port_spec("sampler.lm_head.weight", 2) == ("model", "fsdp")
    # the conv kernel [t, h, w, Cin, Cout] -> [Cout, Cin, t, h, w]
    assert tp.port_spec("encoder.patch_embed_3d.weight", 5) == (
        "model", None, None, None, None)
    assert tp.fsdp_dim("sampler.layers.0.attention.wqkv.weight", 2) == 1
    assert tp.fsdp_dim("sampler.layers.0.attention.wo.weight", 2) == 0
    assert tp.fsdp_dim("sampler.norm.weight", 1) == 0


def test_placement_differences_are_the_listed_leaves(trees):
    """Every leaf whose model-axis placement differs from JAX's spec is
    named by ``MODEL_DIFFERENCES`` (or is the head-aligned ``wqkv``), and
    each listed pattern names some leaf."""
    _, _, system = trees["flagship"]
    differs = set()
    for name, spec in tp.param_specs(system).items():
        ndim = system.get_parameter(name).ndim
        jax_dim = spec.index("model") if "model" in spec else None
        if tp.model_dim(name, ndim) != jax_dim:
            differs.add(name)
    listed = {n for n in differs
              if any(re.search(p, n) for p in tp.MODEL_DIFFERENCES)}
    assert differs == listed
    for name in ("sampler.tok_embeddings.proj_v", "sampler.tok_embeddings.proj_g",
                 "sampler.tok_embeddings.proj_b",
                 "sampler.cls_embeddings.fc1.weight",
                 "sampler.cls_embeddings.fc2.weight",
                 "encoder.patch_embed_3d.weight",
                 "encoder.blocks.0.attn.qkv.weight",
                 "encoder.blocks.11.mlp.fc2.weight"):
        assert name in differs, name
    for pattern in tp.MODEL_DIFFERENCES:
        assert any(re.search(pattern, n) for n in differs), pattern
    wqkv = "sampler.layers.0.attention.wqkv.weight"
    assert re.search(tp.HEAD_ALIGNED, wqkv) and wqkv not in differs
    # what the model axis splits as JAX does
    assert tp.model_dim("sampler.layers.0.attention.wo.weight", 2) == 1
    assert tp.model_dim("sampler.layers.0.feed_forward.w1.weight", 2) == 0
    assert tp.model_dim("sampler.lm_head.weight", 2) == 0
    assert tp.model_dim("sampler.norm.weight", 1) is None
    # the int8 scales of the column-split layers go with their rows
    assert tp.model_dim("sampler.layers.0.attention.wqkv.scale", 1) == 0
    assert tp.model_dim("sampler.layers.0.attention.wo.scale", 1) is None


@pytest.mark.parametrize("data,fsdp,model", [(2, 2, 2), (-1, 4, 1), (-1, 1, 8),
                                             (4, 1, 2)])
def test_mesh_shape_is_jaxs(data, fsdp, model):
    j = j_make_mesh(data=data, fsdp=fsdp, model=model)
    assert tmesh.mesh_shape(8, data, fsdp, model) == tuple(
        j.shape[a] for a in tmesh.MESH_AXES)


def test_mesh_shape_rejects_what_jax_rejects():
    for args in ((-1, 3, 1), (2, 2, 1), (3, 1, 1)):
        with pytest.raises(AssertionError):
            j_make_mesh(*args)
        with pytest.raises(AssertionError):
            tmesh.mesh_shape(8, *args)


@pytest.mark.parametrize("model", [2, 4])
def test_head_aligned_wqkv_rows_are_jaxs_head_columns(model):
    _, tree = init_jax_system(0)
    cfg = port_sampler_config()
    H, Hkv, hd = cfg.nhead, cfg.n_kv_heads, cfg.head_dim
    kernel = np.asarray(tree["sampler"]["layers"]["attention"]["wqkv"][
        "kernel"])[1]  # layer 1: [in, D + 2 kv_dim]
    weight = from_jax_params(tree)["sampler"]["layers.1.attention.wqkv.weight"]
    name = "sampler.layers.1.attention.wqkv.weight"
    h, hk = H // model, Hkv // model
    parts = []
    for r in range(model):
        cols = np.concatenate([
            np.arange(r * h * hd, (r + 1) * h * hd),
            H * hd + np.arange(r * hk * hd, (r + 1) * hk * hd),
            (H + Hkv) * hd + np.arange(r * hk * hd, (r + 1) * hk * hd)])
        part = tp.tp_slice(name, weight, cfg, model, r)
        np.testing.assert_array_equal(part.numpy(), kernel[:, cols].T)
        parts.append(part)
    assert torch.equal(tp.tp_join(name, parts, cfg), weight)


def test_head_alignment_needs_heads_divisible_by_model():
    cfg = SamplerConfig(num_layers=1, d_model=64, nhead=4, n_kv_head=2)
    w = torch.randn(64 + 2 * 2 * 16, 64)
    name = "sampler.layers.0.attention.wqkv.weight"
    rows = [tp.tp_slice(name, w, cfg, 2, r) for r in range(2)]
    # GQA: rank r's two q heads share its one kv head
    assert [p.shape[0] for p in rows] == [2 * 16 + 2 * 16] * 2
    assert torch.equal(tp.tp_join(name, rows, cfg), w)
    with pytest.raises(ValueError, match="must divide"):
        tp.tp_slice(name, w, cfg, 4, 0)


def test_tp_slices_join_back_for_every_sampler_leaf():
    _, tree = init_jax_system(0)
    cfg = port_sampler_config()
    for k, v in from_jax_params(tree)["sampler"].items():
        name = f"sampler.{k}"
        parts = [tp.tp_slice(name, v, cfg, 2, r) for r in range(2)]
        assert torch.equal(tp.tp_join(name, parts, cfg), v), name


class _FakeMesh:
    """The two calls ``batch_rows`` makes of a ``DeviceMesh``."""

    def __init__(self, shape, coord):
        self.shape, self.coord = shape, coord

    def get_coordinate(self):
        return list(self.coord)

    def size(self, dim):
        return self.shape[dim]


def test_batch_rows_over_data_and_fsdp():
    seen = {}
    for d in range(2):
        for f in range(2):
            for m in range(2):
                mesh = _FakeMesh((2, 2, 2), (d, f, m))
                rows = tmesh.batch_rows(mesh, 8)
                seen.setdefault((d, f), rows)
                assert seen[(d, f)] == rows  # model ranks share rows
    assert sorted((s.start, s.stop) for s in seen.values()) == [
        (0, 2), (2, 4), (4, 6), (6, 8)]
    assert tmesh.batch_rows(_FakeMesh((2, 2, 2), (1, 0, 1)), 8) == slice(4, 6)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.batch_rows(_FakeMesh((2, 2, 2), (0, 0, 0)), 6)
    batch = {"frames": np.arange(8)[:, None], "meta": {
        "filepath": [f"{i}.mp4" for i in range(8)], "sr": 44100},
        "audio": torch.arange(8)}
    got = tmesh.shard_batch(_FakeMesh((2, 2, 2), (1, 1, 0)), batch)
    assert got["frames"].ravel().tolist() == [6, 7]
    assert got["audio"].tolist() == [6, 7]
    assert got["meta"] == {"filepath": ["6.mp4", "7.mp4"], "sr": 44100}
