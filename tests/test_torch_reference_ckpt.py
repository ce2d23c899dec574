"""The port's reference-checkpoint path against ``vaura_tpu``'s: the
converters (a Lightning ``.ckpt`` at the tiny ``dummy.yaml`` widths, and the
published DAC 44 kHz and AVCLIP stage-I key schemas of
``tests/fixtures/*.keys.json`` at full scale) must give exactly, in float32,
what the JAX converters followed by ``from_jax_params`` give; the experiment
resolution must pick the same checkpoint (not the decoy with the worse
``val_loss``) and the same hparams."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from torch_reference_util import (
    BEST,
    DECOY,
    EXPERIMENT_NAME,
    REF_HPARAMS,
    write_reference_experiment,
)

from vaura_tpu.models import convert as J
from vaura_tpu.utils import reference_ckpt as JR
from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.models import convert as T
from vaura_tpu_torch.utils import reference_ckpt as TR

FIXTURES = Path(__file__).resolve().parent / "fixtures"


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    return write_reference_experiment(tmp_path_factory.mktemp("ref_exp"))


def assert_same_state_dicts(got, want):
    assert got.keys() == want.keys(), (sorted(set(got) ^ set(want))[:8])
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def test_convert_vaura_checkpoint_matches_jax(experiment):
    path = experiment / "checkpoints" / BEST
    got = T.convert_vaura_checkpoint(str(path))
    want = from_jax_params(J.convert_vaura_checkpoint(str(path)))
    assert set(got) == set(want) == {"sampler", "dac", "encoder"}
    for name in want:
        assert_same_state_dicts(got[name], want[name])


def test_converted_checkpoint_loads_into_the_system_of_its_hparams(experiment):
    from vaura_tpu_torch.models.factory import build_system

    model_cfg, sds, _ = TR.load_reference_experiment(experiment)
    system = build_system(model_cfg, device="cpu")
    system.load_state_dicts(sds)
    assert torch.equal(system.sampler.lm_head.weight, sds["sampler"]["lm_head.weight"])


def test_load_reference_experiment_matches_jax(experiment):
    j_cfg, _, j_ckpt = JR.load_reference_experiment(experiment)
    t_cfg, _, t_ckpt = TR.load_reference_experiment(experiment)
    assert t_ckpt == j_ckpt == experiment / "checkpoints" / BEST
    assert t_cfg == j_cfg
    assert t_cfg["sampler_config"] == REF_HPARAMS["sampler_config"]
    assert t_cfg["feature_extractor_config"]["params"]["ckpt_path"] is None
    # the decoy's worse val_loss loses; a file path is taken as it is
    assert TR.resolve_ckpt(experiment / "checkpoints" / DECOY).name == DECOY
    assert (TR.best_val_loss_ckpt(experiment)
            == JR.best_val_loss_ckpt(experiment))
    hp = TR.resolve_hparams_path(t_ckpt)
    assert hp == JR.resolve_hparams_path(j_ckpt)
    assert hp == experiment / EXPERIMENT_NAME / "hparams.yaml"


def test_is_reference_checkpoint_matches_jax(experiment, tmp_path):
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    (orbax / "_METADATA").write_text("{}")
    for p in (experiment, experiment / "checkpoints" / BEST, orbax,
              tmp_path / "missing", experiment / EXPERIMENT_NAME / "hparams.yaml"):
        assert TR.is_reference_checkpoint(p) == JR.is_reference_checkpoint(p)


def test_override_hparams_writes_json_that_yaml_reads(experiment, tmp_path):
    """Backup/restore semantics of the JAX package's ``override_hparams``;
    the port writes the patched file as JSON text."""
    import shutil

    exp = tmp_path / "exp"
    shutil.copytree(experiment / EXPERIMENT_NAME, exp)
    p1 = TR.override_hparams(exp / "hparams.yaml", {"learning_rate": 1.0})
    assert (exp / "hparams.original.yaml").exists()
    assert yaml.safe_load(p1.read_text())["learning_rate"] == 1.0
    p2 = TR.override_hparams(exp / "hparams.original.yaml",
                             {"weight_decay": 2.0})
    got = yaml.safe_load(p2.read_text())
    assert got["weight_decay"] == 2.0 and got["learning_rate"] == 1e-3
    assert got == dict(REF_HPARAMS, weight_decay=2.0)


def _synth_sd(manifest):
    rng = np.random.default_rng(0)
    return {k: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * np.float32(0.02))
            for k, shape in manifest["keys"].items()}


def test_published_dac_schema_matches_jax():
    manifest = json.loads((FIXTURES / "dac_44khz_8kbps.keys.json").read_text())
    sd = _synth_sd(manifest)
    want = from_jax_params({"dac": J.convert_dac_state_dict(sd)})["dac"]
    got = T.convert_dac_state_dict(sd)
    del sd
    assert_same_state_dicts(got, want)
    from vaura_tpu_torch.models.dac.model import Dac, config_for_sample_rate

    # every tensor of the 44.1 kHz codec, at its shape
    Dac(config_for_sample_rate(44100), "meta").load_state_dict(got, assign=True)


def test_published_avclip_schema_matches_jax():
    manifest = json.loads(
        (FIXTURES / "avclip_stage1_vggsound.keys.json").read_text())
    sd = _synth_sd(manifest)
    stripped = T.strip_avclip_prefix(sd)
    assert stripped.keys() == J.strip_avclip_prefix(sd).keys()
    del sd
    want = from_jax_params(
        {"encoder": J.convert_motionformer_state_dict(stripped)})["encoder"]
    got = T.convert_motionformer_state_dict(stripped)
    assert_same_state_dicts(got, want)
    from vaura_tpu_torch.models.motionformer import MotionFormer, MotionFormerConfig

    # every tensor of the flagship encoder, at its shape
    MotionFormer(MotionFormerConfig(), "meta").load_state_dict(got, assign=True)


def _reference_encoder_sd(layout, aggs, seed=0, D=8, depth=2, hw=4, t=2):
    """A reference-named Motionformer state dict of random values: blocks of
    ``layout`` (the key layouts of ``vit_helper.py``), the joint embedding
    for the joint blocks, and the CLS aggregation layers ``aggs`` (the
    global one with its ``pos_emb``)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(name, *shape):
        sd[name] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def linear(name, o, i):
        put(f"{name}.weight", o, i)
        put(f"{name}.bias", o)

    def norm(name):
        put(f"{name}.weight", D)
        put(f"{name}.bias", D)

    put("patch_embed_3d.proj.weight", D, 3, 2, 4, 4)
    put("patch_embed_3d.proj.bias", D)
    put("cls_token", 1, 1, D)
    put("pos_embed", 1, hw + 1, D)
    if layout == "joint":
        put("st_embed", 1, t * hw + 1, D)
    else:
        put("temp_embed", 1, t, D)
    attn = {"trajectory": (("attn.qkv", 3), ("attn.proj_q", 1),
                           ("attn.proj_kv", 2), ("attn.proj", 1)),
            "divided": (("timeattn.qkv", 3), ("timeattn.proj", 1),
                        ("attn.qkv", 3), ("attn.proj", 1)),
            "joint": (("attn.qkv", 3), ("attn.proj", 1))}[layout]
    for i in range(depth):
        p = f"blocks.{i}"
        for n in ("norm1", "norm2") + (("norm3",) if layout == "divided"
                                        else ()):
            norm(f"{p}.{n}")
        for name, mult in attn:
            linear(f"{p}.{name}", mult * D, D)
        linear(f"{p}.mlp.fc1", 4 * D, D)
        linear(f"{p}.mlp.fc2", D, 4 * D)
    norm("norm")
    for agg in aggs:
        put(f"{agg}.cls_token", 1, 1, D)
        if agg == "global_attn_agg":
            put(f"{agg}.pos_emb", 1, 17, D)
        put(f"{agg}.self_attn.in_proj_weight", 3 * D, D)
        put(f"{agg}.self_attn.in_proj_bias", 3 * D)
        linear(f"{agg}.self_attn.out_proj", D, D)
        linear(f"{agg}.linear1", 4 * D, D)
        linear(f"{agg}.linear2", D, 4 * D)
        norm(f"{agg}.norm1")
        norm(f"{agg}.norm2")
    return sd


_VARIANTS = (
    ("trajectory", ("spatial_attn_agg",), {"attn_layer": "trajectory"}),
    ("joint", ("spatial_attn_agg",),
     {"attn_layer": "joint", "pos_embed_type": "joint"}),
    ("divided", ("spatial_attn_agg", "temp_attn_agg", "global_attn_agg"),
     {"agg_time_module": "TransformerEncoderLayer", "add_global_repr": True}),
    ("trajectory", ("temp_attn_agg", "global_attn_agg"),
     {"attn_layer": "trajectory", "agg_space_module": "AveragePooling",
      "agg_time_module": "TransformerEncoderLayer", "add_global_repr": True}),
)


def test_unported_encoder_variants_raise():
    """The encoder variants that this converter once refused (trajectory
    and joint blocks, the temporal and global aggregation layers) now
    convert as the JAX converter + ``from_jax_params`` do, into the names of
    the port's encoder of that configuration."""
    from vaura_tpu_torch.models.motionformer import MotionFormer, MotionFormerConfig

    for layout, aggs, cfg_kw in _VARIANTS:
        sd = _reference_encoder_sd(layout, aggs)
        got = T.convert_motionformer_state_dict(sd)
        want = from_jax_params(
            {"encoder": J.convert_motionformer_state_dict(sd)})["encoder"]
        assert_same_state_dicts(got, want)
        cfg = MotionFormerConfig(img_size=8, patch_size=4, embed_dim=8,
                                 depth=2, num_heads=2, temporal_resolution=2,
                                 **cfg_kw)
        MotionFormer(cfg, "meta").load_state_dict(got, assign=True)


def test_maybe_load_pretrained(experiment, tmp_path):
    """A torch checkpoint of the codec named by the config's ``ckpt_path``
    loads into the system, and so does a directory of the port's checkpoint
    format; a directory without ``state.pt`` (an orbax tree), or with names
    that lack the ``dac.`` prefix, raises."""
    from vaura_tpu_torch.models.factory import build_system, maybe_load_pretrained

    full = torch.load(experiment / "checkpoints" / BEST, weights_only=False)
    prefix = "audio_encoder.model."
    dac_sd = {k[len(prefix):]: v for k, v in full["state_dict"].items()
              if k.startswith(prefix)}
    torch.save({"state_dict": dac_sd}, tmp_path / "dac.pth")
    cfg = json.loads(json.dumps(REF_HPARAMS))
    cfg["audio_encoder_config"]["params"]["ckpt_path"] = str(tmp_path / "dac.pth")
    system = build_system(cfg, device="cpu")
    maybe_load_pretrained(system, cfg)
    want = T.convert_dac_state_dict(dac_sd)
    assert torch.equal(system.dac.state_dict()["quantizer.codebooks"],
                       want["quantizer.codebooks"])
    fresh = build_system(cfg, device="cpu")
    (tmp_path / "dac_dir").mkdir()
    torch.save({"params": {f"dac.{k}": v for k, v in want.items()}},
               tmp_path / "dac_dir" / "state.pt")
    cfg["audio_encoder_config"]["params"]["ckpt_path"] = str(tmp_path / "dac_dir")
    maybe_load_pretrained(fresh, cfg)
    assert torch.equal(fresh.dac.state_dict()["quantizer.codebooks"],
                       want["quantizer.codebooks"])
    (tmp_path / "bare_dir").mkdir()  # names without the ``dac.`` prefix
    torch.save({"params": want}, tmp_path / "bare_dir" / "state.pt")
    cfg["audio_encoder_config"]["params"]["ckpt_path"] = str(tmp_path / "bare_dir")
    with pytest.raises(ValueError, match=r"dac\."):
        maybe_load_pretrained(system, cfg)
    cfg["audio_encoder_config"]["params"]["ckpt_path"] = str(tmp_path)
    with pytest.raises(ValueError, match="orbax"):
        maybe_load_pretrained(system, cfg)


def test_experiment_helpers_match_jax(tmp_path):
    """``save_hparams``/``load_hparams`` across the two packages (the port
    writes JSON text, the JAX package PyYAML's block style), and the
    best-checkpoint and hparams resolution of an experiment of the JAX
    package's own training."""
    from vaura_tpu.utils import experiment as JE
    from vaura_tpu_torch.utils import experiment as TE

    cfg = json.loads(json.dumps(REF_HPARAMS))
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    assert JE.load_hparams(TE.save_hparams(tmp_path / "t", cfg)) == cfg
    assert TE.load_hparams(JE.save_hparams(tmp_path / "j", cfg)) == cfg
    exp = tmp_path / "exp"
    for name in ("epoch=1-step=10-val_loss=2.125", "epoch=2-step=20-val_loss=0.750",
                 "last"):
        (exp / "checkpoints" / name).mkdir(parents=True)
    (exp / "run").mkdir()
    JE.save_hparams(exp / "run", cfg)
    assert TE.resolve_experiment_paths(exp) == JE.resolve_experiment_paths(exp)
    best = TE.resolve_best_checkpoint(exp / "checkpoints")
    assert best == JE.resolve_best_checkpoint(exp / "checkpoints")
    assert best.name == "epoch=2-step=20-val_loss=0.750"
