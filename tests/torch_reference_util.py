"""A synthetic reference (Lightning) experiment for the tests of the port's
config-driven generate action and checkpoint converters.

The model is the tiny one of ``configs/experiments/dummy.yaml``, described in
``hparams.yaml`` under the reference's own target strings
(``models.modules.sampler.llama.Transformer`` and so on). Its weights are
seeded numpy values at the shapes of the JAX package's parameter tree
(``jax.eval_shape``, nothing compiled), written under the reference's state
dict names: the inverse of ``vaura_tpu/models/convert.py``, weight norm as
``weight_v`` with ``weight_g = ||weight_v||``.

    exp/checkpoints/epoch=3-step=30-val_loss=1.250.ckpt   the best
    exp/checkpoints/epoch=1-step=10-val_loss=2.500.ckpt   a decoy, other weights
    exp/dummy-smoke/hparams.yaml                          (PyYAML block style)
"""

from __future__ import annotations

import copy
from pathlib import Path

import numpy as np
import torch
import yaml

REPO = Path(__file__).resolve().parents[1]

_DUMMY = yaml.safe_load((REPO / "configs/experiments/dummy.yaml").read_text())
_MODEL = _DUMMY["model"]
REF_HPARAMS = {
    "learning_rate": 1e-3,
    "weight_decay": 0.0,
    "betas": [0.9, 0.95],
    "use_visual_conditioning": True,
    "freeze_feature_extractor": True,
    "flatten_vis_feats": False,
    "sampler_config": {
        "target": "models.modules.sampler.llama.Transformer",
        "params": {k: v for k, v in _MODEL["sampler_config"]["params"].items()
                   if k != "codebook_dim"},  # synced from the codec
    },
    "audio_encoder_config": {
        "target": "models.modules.dac.model.DacModelWrapper",
        "params": dict(_MODEL["audio_encoder_config"]["params"]),
    },
    "feature_extractor_config": {
        "target": ("models.modules.feature_extractors.avclip.motionformer."
                   "MotionFormer"),
        "params": dict(_MODEL["feature_extractor_config"]["params"],
                       ckpt_path=None, agg_time_module="torch.nn.Identity"),
    },
    "visual_bridge_config": {"target": "torch.nn.Identity"},
    "pattern_provider_config": {
        "target": "models.modules.misc.codebook_patterns.DelayedPatternProvider",
        "params": {"n_q": _MODEL["sampler_config"]["params"]["num_codebooks"]},
    },
}
BEST = "epoch=3-step=30-val_loss=1.250.ckpt"
DECOY = "epoch=1-step=10-val_loss=2.500.ckpt"
EXPERIMENT_NAME = "dummy-smoke"


def jax_param_shapes():
    """The shapes of the JAX system's parameter tree for ``REF_HPARAMS``."""
    import jax

    from vaura_tpu.models.factory import build_system

    system = build_system(copy.deepcopy(REF_HPARAMS))
    return jax.eval_shape(system.init_params, jax.random.PRNGKey(0))


_EMBEDDINGS = ("emb", "cls_token", "pos_embed", "temp_embed",
               "uncond_embedding", "empty_video_emb")


def synthetic_tree(shapes, seed: int):
    """Seeded values for every leaf of ``shapes``: matmul and conv kernels
    ``N(0, 1/fan_in)``, biases ``N(0, 0.05)``, norm scales ``1 + N(0, 0.1)``,
    Snake alphas in ``[0.5, 2]``, embeddings ``N(0, 0.5)``, codebooks
    ``N(0, 1)``."""
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        n = lambda s: rng.standard_normal(shape) * s
        if name == "alpha":
            v = rng.uniform(0.5, 2.0, shape)
        elif name in ("bias", "proj_b", "in_proj_b", "out_proj_b"):
            v = n(0.05)
        elif name in ("scale", "weight", "proj_g"):
            v = 1.0 + n(0.1)
        elif name in _EMBEDDINGS:
            v = n(0.5)
        elif name == "codebooks":
            v = n(1.0)
        elif name in ("in_proj_w", "out_proj_w"):
            v = n(shape[1] ** -0.5)
        elif name == "proj_v":
            v = n(shape[-1] ** -0.5)
        else:  # kernels: flax layout [..., in, out]
            v = n(float(np.prod(shape[:-1])) ** -0.5)
        return v.astype(np.float32)

    def walk(node):
        return {k: walk(v) if hasattr(v, "items") else leaf(k, tuple(v.shape))
                for k, v in node.items()}

    return walk(shapes)


# --------------------------------------------------------------------------
# the inverse of vaura_tpu/models/convert.py
def _wn(W: np.ndarray, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight_v"] = W
    out[f"{prefix}.weight_g"] = np.sqrt(
        (W ** 2).sum(axis=tuple(range(1, W.ndim)), keepdims=True))


def _conv1d(p, prefix, out):
    _wn(p["conv"]["kernel"].transpose(2, 1, 0), prefix, out)
    out[f"{prefix}.bias"] = p["conv"]["bias"]


def _snake(p, prefix, out):
    out[f"{prefix}.alpha"] = p["alpha"].reshape(1, -1, 1)


def _res_unit(p, prefix, out):
    _snake(p["snake1"], f"{prefix}.block.0", out)
    _conv1d(p["conv1"], f"{prefix}.block.1", out)
    _snake(p["snake2"], f"{prefix}.block.2", out)
    _conv1d(p["conv2"], f"{prefix}.block.3", out)


def reference_dac(p) -> dict:
    out = {}
    e, d, q = p["encoder"], p["decoder"], p["quantizer"]
    n_enc = sum(k.startswith("block") for k in e)
    n_dec = sum(k.startswith("block") for k in d)
    _conv1d(e["conv_in"], "encoder.block.0", out)
    for i in range(n_enc):
        b, pre = e[f"block{i}"], f"encoder.block.{i + 1}.block"
        for r in range(3):
            _res_unit(b[f"res{r + 1}"], f"{pre}.{r}", out)
        _snake(b["snake"], f"{pre}.3", out)
        _conv1d(b["down"], f"{pre}.4", out)
    _snake(e["snake_out"], f"encoder.block.{n_enc + 1}", out)
    _conv1d(e["conv_out"], f"encoder.block.{n_enc + 2}", out)
    _conv1d(d["conv_in"], "decoder.model.0", out)
    for i in range(n_dec):
        b, pre = d[f"block{i}"], f"decoder.model.{i + 1}.block"
        _snake(b["snake"], f"{pre}.0", out)
        _wn(b["up"]["kernel"].transpose(1, 2, 0), f"{pre}.1", out)
        out[f"{pre}.1.bias"] = b["up"]["bias"]
        for r in range(3):
            _res_unit(b[f"res{r + 1}"], f"{pre}.{r + 2}", out)
    _snake(d["snake_out"], f"decoder.model.{n_dec + 1}", out)
    _conv1d(d["conv_out"], f"decoder.model.{n_dec + 2}", out)
    for k in range(q["codebooks"].shape[0]):
        pre = f"quantizer.quantizers.{k}"
        out[f"{pre}.codebook.weight"] = q["codebooks"][k]
        _wn(q["in_proj_w"][k].T[:, :, None], f"{pre}.in_proj", out)
        out[f"{pre}.in_proj.bias"] = q["in_proj_b"][k]
        _wn(q["out_proj_w"][k].T[:, :, None], f"{pre}.out_proj", out)
        out[f"{pre}.out_proj.bias"] = q["out_proj_b"][k]
    return out


def _linear(p, prefix, out):
    out[f"{prefix}.weight"] = p["kernel"].T
    if "bias" in p:
        out[f"{prefix}.bias"] = p["bias"]


def _ln(p, prefix, out):
    out[f"{prefix}.weight"] = p["scale"]
    out[f"{prefix}.bias"] = p["bias"]


def reference_encoder(p) -> dict:
    """Divided blocks (``timeattn``) and the spatial aggregation layer."""
    out = {
        "patch_embed_3d.proj.weight":
            p["patch_embed_3d"]["kernel"].transpose(4, 3, 0, 1, 2),
        "patch_embed_3d.proj.bias": p["patch_embed_3d"]["bias"],
    }
    for name in ("cls_token", "pos_embed", "temp_embed"):
        out[name] = p[name]
    b = p["blocks"]
    for i in range(b["norm1"]["scale"].shape[0]):
        at = lambda t: {k: v[i] for k, v in t.items()}
        pre = f"blocks.{i}"
        for norm in ("norm1", "norm2", "norm3"):
            _ln(at(b[norm]), f"{pre}.{norm}", out)
        for att in ("attn", "timeattn"):
            _linear(at(b[att]["qkv"]), f"{pre}.{att}.qkv", out)
            _linear(at(b[att]["proj"]), f"{pre}.{att}.proj", out)
        _linear(at(b["mlp"]["fc1"]), f"{pre}.mlp.fc1", out)
        _linear(at(b["mlp"]["fc2"]), f"{pre}.mlp.fc2", out)
    _ln(p["norm"], "norm", out)
    a, pre = p["spatial_attn_agg"], "spatial_attn_agg"
    out[f"{pre}.cls_token"] = a["cls_token"]
    out[f"{pre}.self_attn.in_proj_weight"] = a["in_proj"]["kernel"].T
    out[f"{pre}.self_attn.in_proj_bias"] = a["in_proj"]["bias"]
    _linear(a["out_proj"], f"{pre}.self_attn.out_proj", out)
    _linear(a["linear1"], f"{pre}.linear1", out)
    _linear(a["linear2"], f"{pre}.linear2", out)
    _ln(a["norm1"], f"{pre}.norm1", out)
    _ln(a["norm2"], f"{pre}.norm2", out)
    return out


def reference_sampler(p) -> dict:
    out = {}
    t = p["tok_embeddings"]
    K = t["proj_v"].shape[0]
    V1 = t["emb"].shape[0] // K
    for k in range(K):
        pre = f"tok_embeddings.{k}"
        out[f"{pre}.emb.weight"] = t["emb"][k * V1:(k + 1) * V1]
        out[f"{pre}.out_proj.weight_v"] = t["proj_v"][k][:, :, None]
        out[f"{pre}.out_proj.weight_g"] = t["proj_g"][k][:, :, None]
        out[f"{pre}.out_proj.bias"] = t["proj_b"][k]
    c = p["cls_embeddings"]
    out["cls_embeddings.projection.fc1.weight"] = c["fc1"]["kernel"].T
    out["cls_embeddings.projection.fc2.weight"] = c["fc2"]["kernel"].T
    out["cls_embeddings.uncond_embedding"] = c["uncond_embedding"]
    out["empty_video_emb"] = p["empty_video_emb"]
    layers = p["layers"]
    for i in range(layers["attention_norm"]["weight"].shape[0]):
        pre = f"layers.{i}"
        for group, names in (("attention", ("wqkv", "wo")),
                             ("feed_forward", ("w1", "w2", "w3"))):
            for n in names:
                out[f"{pre}.{group}.{n}.weight"] = layers[group][n]["kernel"][i].T
        for norm in ("attention_norm", "ffn_norm"):
            out[f"{pre}.{norm}.weight"] = layers[norm]["weight"][i]
    out["norm.weight"] = p["norm"]["weight"]
    head = p["lm_head"]["kernel"]
    V = head.shape[1] // K
    for k in range(K):
        out[f"lm_heads.{k}.weight"] = head[:, k * V:(k + 1) * V].T
    return out


def reference_state_dict(tree) -> dict:
    """The Lightning ``state_dict`` of ``tree`` (torch tensors)."""
    sd = {}
    for prefix, part in (("sampler.", reference_sampler(tree["sampler"])),
                         ("audio_encoder.model.", reference_dac(tree["dac"])),
                         ("visual_feature_extractor.",
                          reference_encoder(tree["encoder"]))):
        for k, v in part.items():
            sd[prefix + k] = torch.from_numpy(
                np.ascontiguousarray(v, dtype=np.float32))
    return sd


def write_reference_experiment(root: Path, seed: int = 0) -> Path:
    """The experiment directory of the module docstring, its best
    checkpoint from ``seed``; returns its root."""
    shapes = jax_param_shapes()
    ckpt_dir = root / "checkpoints"
    ckpt_dir.mkdir(parents=True)
    for name, s in ((BEST, seed), (DECOY, seed + 1)):
        torch.save({"state_dict": reference_state_dict(synthetic_tree(shapes, s)),
                    "epoch": 0}, ckpt_dir / name)
    hp_dir = root / EXPERIMENT_NAME
    hp_dir.mkdir()
    (hp_dir / "hparams.yaml").write_text(yaml.safe_dump(REF_HPARAMS,
                                                        sort_keys=False))
    return root
