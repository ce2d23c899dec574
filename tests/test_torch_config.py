"""The port's config assembly against ``vaura_tpu.config``: its YAML reader
against PyYAML on every file under ``configs/`` and on the corners of YAML
1.1's scalar resolution, ``assemble_config`` against the JAX package's on
the repo's configs and CLI dotlists, the registry's aliases, and
``build_system``'s configurations against the JAX ``build_system``'s."""

import copy
import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import yaml

from vaura_tpu.config import assemble_config as j_assemble
from vaura_tpu.config import load_config as j_load_config
from vaura_tpu_torch.config import assemble_config as t_assemble
from vaura_tpu_torch.config import load_config as t_load_config
from vaura_tpu_torch.config.yaml_subset import YamlSubsetError, dump, safe_load
from vaura_tpu_torch.models.sampler import PORT_ONLY_FIELDS

REPO = Path(__file__).resolve().parents[1]
DEFAULTS = REPO / "configs" / "vaura_defaults.yaml"
CONFIG_FILES = sorted(p.relative_to(REPO).as_posix()
                      for p in (REPO / "configs").rglob("*.yaml"))


def _same(a, b) -> bool:
    """Equality that also holds for NaN and keeps bool apart from int."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    return a == b


@pytest.mark.parametrize("path", CONFIG_FILES)
def test_yaml_reader_matches_pyyaml_on_every_config(path):
    text = (REPO / path).read_text()
    assert _same(safe_load(text, path), yaml.safe_load(text))


SNIPPETS = [
    # YAML 1.1 scalars: 1e-3 has no dot and stays a string
    "a: 1e-3\nb: 1.0e-3\nc: 200_000\nd: 0x1f\ne: 017\nf: 0b101\ng: -0\n",
    "a: yes\nb: No\nc: on\nd: OFF\ne: ~\nf:\ng: null\nh: True\n",
    "a: .inf\nb: -.Inf\nc: .nan\nd: 1:30\ne: 1:30.5\nf: +12\ng: -.5\nh: 3.\n",
    "a: 'it''s # not a comment'\nb: \"tab\\tq\\\"\\u00e9\"\nc: ???\n",
    "a: b # comment\nc: d#not-comment\n# whole line\n\nd: ${from_file:./x.yaml}\n",
    "x:\n- a\n- b: 1\n  c: [1, {d: 2}]\n-\n  - z\ny: {}\nz: []\n",
    "- - 1\n  - 2\n- 3\n",
    "a:\n  b:\n    c: 1\n  d: [0.5, 0.5,\n      0.5]\ne: {size: [224, 224], p: 0.5}\n",
    "key: value with spaces  \nurl: http://host:8080/x\n'q': 1\n\"r\": 2\n",
    "list:\n- target: x.Y\n  params: {size: 256}\n- target: x.Z\nafter: 1\n",
    "1: int key\ntrue: bool key\n",
    '{\n  "a": [1, 2.5, null, true, "x: y", "#z"],\n  "b": {"c": "d"}\n}\n',
    "",
    "# only a comment\n",
    "plain scalar\n",
]


@pytest.mark.parametrize("text", SNIPPETS)
def test_yaml_reader_matches_pyyaml_on_the_subset(text):
    assert _same(safe_load(text), yaml.safe_load(text))


@pytest.mark.parametrize("text", [
    "a: &anchor 1\nb: *anchor\n",
    "a: !!str 1\n",
    "a: |\n  block\n",
    "a: >\n  folded\n",
    "--- \na: 1\n",
    "a: 1\n---\nb: 2\n",
    "%YAML 1.1\na: 1\n",
    "? complex\n: key\n",
    "a: multi\n  line plain\n",
    "a: 'multi\n  line quoted'\n",
    "a:\n\tb: 1\n",
    "a: 2001-12-14\n",
    "<<: {a: 1}\n",
    "a: [1, b: 2]\n",
    "a: [1, 2\n",
    "a: b: c\n",
    "a: ]x\n",
])
def test_yaml_reader_raises_outside_the_subset(text):
    with pytest.raises(YamlSubsetError):
        safe_load(text)


def test_dump_is_read_back_by_both_readers():
    cfg = j_assemble([f"config={REPO / 'configs/experiments/dummy.yaml'}"],
                     defaults_path=DEFAULTS, base_dir=REPO)
    cfg["tuple"] = (1, 2)
    cfg["text"] = "é: # ' \" \\ {[,"
    cfg["floats"] = [1e-06, 1e20, 0.5, 3.0, -2.5e-10, 1e-3]
    text = dump(cfg)
    want = dict(cfg, tuple=[1, 2])
    assert _same(yaml.safe_load(text), want)
    assert _same(safe_load(text), want)
    with pytest.raises(ValueError):
        dump({"x": float("nan")})
    with pytest.raises(TypeError):
        dump({1: "int key"})


ASSEMBLE_CASES = [
    [f"config={p}"] for p in CONFIG_FILES
    if p.startswith(("configs/generate_", "configs/experiments/"))
] + [
    ["config=configs/generate_vgg.yaml", "dataloader.dataset_type=dummy",
     "max_batches=1", "dataloader.batch_size=2", "quantize=true",
     "output_dir=/tmp/x", "top_k=8", "cfg_scale=3.0"],
    ["config=configs/generate_vgg_sparse.yaml", "long_mode=stream_kv",
     "dataloader.video_length=5.12", "dataloader.num_clips=8",
     "trainer.platform=cpu", "seed=1e-3"],
    ["config=configs/experiments/dummy.yaml", "action=generate",
     "duration=0.15", "model.sampler_config.params.num_layers=1",
     "dataloader.frame_shape=[16, 16]", "overridden_hparams={a: 1}"],
    ["config=configs/experiments/dummy.yaml", "trainer.fast_dev_run=true",
     "model.flatten_vis_feats=true"],
]


@pytest.mark.parametrize("argv", ASSEMBLE_CASES, ids=lambda a: " ".join(a))
def test_assemble_config_matches_jax(argv, monkeypatch):
    monkeypatch.chdir(REPO)
    want = j_assemble(argv, defaults_path=DEFAULTS, base_dir=REPO)
    got = t_assemble(argv, defaults_path=DEFAULTS, base_dir=REPO)
    assert _same(got, want)


def test_load_config_matches_jax():
    assert _same(t_load_config(DEFAULTS, REPO), j_load_config(DEFAULTS, REPO))


def _targets(node):
    if isinstance(node, dict):
        if isinstance(node.get("target"), str):
            yield node["target"]
        for v in node.values():
            yield from _targets(v)
    elif isinstance(node, list):
        for v in node:
            yield from _targets(v)


def test_every_target_of_the_configs_resolves_to_the_port():
    from vaura_tpu_torch.config import get_obj_from_target
    from vaura_tpu_torch.config import registry

    registry.ensure_aliases()
    targets = {t for p in CONFIG_FILES for t in _targets(
        t_load_config(REPO / p, REPO))}
    assert len(targets) > 10
    for t in sorted(targets):
        obj = get_obj_from_target(t)
        assert obj.__module__.startswith("vaura_tpu_torch."), (t, obj)


def test_reference_targets_resolve_to_the_port():
    from vaura_tpu_torch.config import get_obj_from_target, registry
    from vaura_tpu_torch.data import transforms
    from vaura_tpu_torch.models import bridges, motionformer, sampler

    registry.ensure_aliases()
    for target, want in (
        ("models.modules.sampler.llama.Transformer", sampler.SamplerSpec),
        ("models.modules.feature_extractors.avclip.motionformer.MotionFormer",
         motionformer.MotionFormerSpec),
        ("torch.nn.Identity", bridges.IdentityBridge),
        ("models.modules.misc.bridges.ConvBridge2D", bridges.ConvBridge2D),
        ("torchvision.transforms.v2.Resize", transforms.Resize),
        ("models.data.transforms.audio_transforms.AudioTrim",
         transforms.AudioTrim),
    ):
        assert get_obj_from_target(target) is want


def test_unaliased_jax_target_raises_and_imports_nothing():
    code = (
        "import sys\n"
        "from vaura_tpu_torch.config import instantiate_from_config\n"
        "try:\n"
        "    instantiate_from_config({'target': 'vaura_tpu.ops.fad.Nope'})\n"
        "except ImportError as e:\n"
        "    assert 'JAX package' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('no ImportError')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('vaura_tpu', 'jax', 'flax', 'yaml')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_specs_reject_what_the_port_lacks():
    from vaura_tpu_torch.config import instantiate_from_config
    from vaura_tpu_torch.models.dac.model import DacSpec
    from vaura_tpu_torch.models.motionformer import MotionFormerSpec
    from vaura_tpu_torch.models.sampler import SamplerSpec
    from vaura_tpu_torch.ops import patterns

    # the JAX-only knobs that change nothing here are dropped
    cfg = SamplerSpec(num_layers=2, use_pallas_decode=True, scan_unroll=2,
                      initializer_range=0.01, dim_feedforward=7)
    assert cfg.num_layers == 2
    # the last sampler modes build, equal to the JAX package's spec in
    # every field the two share
    from vaura_tpu.models.sampler import SamplerSpec as JSamplerSpec

    for kw in ({"cache_bits": 4}, {"int8_dots": True},
               {"dac_factored_embeddings": False},
               {"quantize_cache": True, "cache_bits": 4, "int8_dots": True}):
        got, want = _fields(SamplerSpec(**kw)), _fields(JSamplerSpec(**kw))
        assert all(got[k] == v for k, v in kw.items()), kw
        for name, value in got.items():
            if name in PORT_ONLY_FIELDS:  # the Llama block's defaults
                assert value == PORT_ONLY_FIELDS[name], (kw, name)
            elif not name.endswith("dtype"):
                assert want[name] == value, (kw, name)
    with pytest.raises(ValueError):
        SamplerSpec(cache_bits=2)
    assert SamplerSpec(remat=True, remat_policy="dots").remat_policy == "dots"
    with pytest.raises(TypeError):
        SamplerSpec(no_such_key=1)
    MotionFormerSpec(fused_divided_attention=True, approx_attn_type="nystrom")
    # every encoder variant of the JAX package builds
    for kw in ({"attn_layer": "joint"}, {"agg_time_module": "AveragePooling"},
               {"add_global_repr": True}, {"quantize": True},
               {"factorize_space_time": False}):
        cfg = MotionFormerSpec(**kw)
        assert all(getattr(cfg, k) == v for k, v in kw.items()), kw
    with pytest.raises(TypeError):
        DacSpec(no_such_key=1)
    assert DacSpec(44100, encoder_rates=[2, 4]).config.encoder_rates == (2, 4)
    for name in ("UnrolledPatternProvider", "VALLEPattern", "MusicLMPattern"):
        got = instantiate_from_config(
            {"target": f"vaura_tpu.ops.patterns.{name}",
             "params": {"n_q": 3}})
        assert type(got) is getattr(patterns, name)


def _dtype_name(d) -> str:
    return str(d).rsplit(".", 1)[-1].replace("'>", "")


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("path,precision", [
    ("configs/vaura_defaults.yaml", None),
    ("configs/experiments/dummy.yaml", None),
    ("configs/experiments/dummy.yaml", "f32"),
])
def test_build_system_matches_jax(path, precision):
    from vaura_tpu.models.factory import build_system as j_build
    from vaura_tpu_torch.models.factory import build_system as t_build

    cfg = t_load_config(REPO / path, REPO)
    js = j_build(copy.deepcopy(cfg["model"]), precision)
    ts = t_build(copy.deepcopy(cfg["model"]), precision, device="cpu")
    pairs = ((js.sampler_config, ts.sampler_config),
             (js.encoder_config, ts.encoder.cfg), (js.dac_config, ts.dac.cfg))
    for jc, tc in pairs:
        jf, tf = _fields(jc), _fields(tc)
        for name, value in tf.items():
            if tc is ts.sampler_config and name in PORT_ONLY_FIELDS:
                # the DeepSeek-V3 keys, which the JAX package lacks: at the
                # defaults that keep the Llama block
                assert value == PORT_ONLY_FIELDS[name], name
                continue
            assert name in jf, (type(tc).__name__, name)
            if name.endswith("dtype"):
                assert _dtype_name(jnp.dtype(jf[name])) == _dtype_name(value)
            else:
                assert jf[name] == value, (type(tc).__name__, name)
    jp, tp = js.pattern_provider, ts.pattern_provider
    assert type(jp).__name__ == type(tp).__name__
    assert jp.get_pattern(20).layout == tp.get_pattern(20).layout


@pytest.mark.parametrize("n_q,steps", [(3, 7), (9, 20)])
def test_parallel_pattern_matches_jax(n_q, steps):
    from vaura_tpu.ops.patterns import ParallelPatternProvider as J
    from vaura_tpu_torch.config import instantiate_from_config

    t = instantiate_from_config(
        t_load_config(REPO / "configs/modules/codebook_patterns/parallel_9cbs.yaml",
                      REPO) | {"params": {"n_q": n_q}})
    assert type(t).__name__ == "ParallelPatternProvider"
    assert t.get_pattern(steps).layout == J(n_q).get_pattern(steps).layout
