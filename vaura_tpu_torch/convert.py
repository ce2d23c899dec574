"""Carry ``vaura_tpu`` parameters into the port.

``from_jax_params`` takes the ``VauraSystem.init_params`` tree of the JAX
package (or a restored checkpoint) as nested dicts of numpy arrays and
returns the port's state dicts ``{"sampler", "encoder", "dac", "bridge"}``
(the subtrees present) for ``VauraSystem.load_state_dicts``.

Layouts:
  * flax ``Dense`` kernel ``[in, out]`` -> ``nn.Linear`` weight ``[out, in]``;
  * the ``nn.scan``-stacked leading ``[L, ...]`` axis of the sampler's
    ``layers`` and the encoder's ``blocks`` -> one entry per layer;
  * Conv3d ``[t, h, w, Cin, Cout]`` -> ``[Cout, Cin, t, h, w]``;
  * DAC Conv1d ``[W, Cin, Cout]`` -> ``[Cout, Cin, W]``;
  * DAC ConvTranspose1d ``[W, in, out]`` (the gradient-kernel layout run
    through ``lax.conv_transpose(transpose_kernel=True)``; the JAX package's
    converter maps torch ``[in, out, W]`` to it with ``transpose(2, 0, 1)``,
    ``vaura_tpu/models/convert.py:64``) -> ``[in, out, W]`` by the inverse
    ``transpose(1, 2, 0)``.
Weight norm is already folded on the JAX side. The int8 weights of a
``quantize_sampler_params`` or ``quantize_encoder_params`` tree
(``kernel_q [in, out]`` int8, ``scale [out]``) become ``kernel_q [out, in]``
int8 and ``scale`` buffers, for a sampler built with
``quantize_weights=True`` or an encoder built with ``quantize=True``. LoRA
adapters
(``lora_sampler``: stacked ``a [L, in, r]``, ``b [L, r, out]``) become one
transposed pair per layer.

Every mapping is linear (a transpose, a slice or a copy), so a JAX GRADIENT
tree or an UPDATED parameter tree goes through ``from_jax_params`` just as
the parameters do: the tests compare the port's gradients and optimizer
steps with the JAX package's that way.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

Tree = Mapping[str, Any]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C", copy=True))


def _dense(p: Tree, out: Dict[str, torch.Tensor], prefix: str,
           index=None) -> None:
    if "kernel_q" in p:  # int8 weights of ``quantize_*_params``
        q, sc = np.asarray(p["kernel_q"]), np.asarray(p["scale"])
        q, sc = (q, sc) if index is None else (q[index], sc[index])
        out[f"{prefix}.kernel_q"] = torch.from_numpy(
            np.ascontiguousarray(q.T).astype(np.int8))
        out[f"{prefix}.scale"] = _t(sc)
    else:
        k = np.asarray(p["kernel"])
        k = k if index is None else k[index]
        out[f"{prefix}.weight"] = _t(k.T)
    if "bias" in p:
        b = np.asarray(p["bias"])
        out[f"{prefix}.bias"] = _t(b if index is None else b[index])


def _ln(p: Tree, out: Dict[str, torch.Tensor], prefix: str, index=None) -> None:
    for name in ("scale", "bias"):
        a = np.asarray(p[name])
        out[f"{prefix}.{name}"] = _t(a if index is None else a[index])


def sampler_state_dict(p: Tree) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for name, a in p["tok_embeddings"].items():
        sd[f"tok_embeddings.{name}"] = _t(a)
    ce = p["cls_embeddings"]
    _dense(ce["fc1"], sd, "cls_embeddings.fc1")
    _dense(ce["fc2"], sd, "cls_embeddings.fc2")
    sd["cls_embeddings.uncond_embedding"] = _t(ce["uncond_embedding"])
    sd["empty_video_emb"] = _t(p["empty_video_emb"])
    lp = p["layers"]
    n_layers = np.asarray(lp["attention_norm"]["weight"]).shape[0]
    for i in range(n_layers):
        pre = f"layers.{i}"
        _dense(lp["attention"]["wqkv"], sd, f"{pre}.attention.wqkv", i)
        _dense(lp["attention"]["wo"], sd, f"{pre}.attention.wo", i)
        for w in ("w1", "w2", "w3"):
            _dense(lp["feed_forward"][w], sd, f"{pre}.feed_forward.{w}", i)
        for norm in ("attention_norm", "ffn_norm"):
            sd[f"{pre}.{norm}.weight"] = _t(np.asarray(lp[norm]["weight"])[i])
    sd["norm.weight"] = _t(p["norm"]["weight"])
    _dense(p["lm_head"], sd, "lm_head")
    return sd


def _agg_layer(p: Tree, sd: Dict[str, torch.Tensor], prefix: str) -> None:
    sd[f"{prefix}.cls_token"] = _t(p["cls_token"])
    if "pos_emb" in p:
        sd[f"{prefix}.pos_emb"] = _t(p["pos_emb"])
    for norm in ("norm1", "norm2"):
        _ln(p[norm], sd, f"{prefix}.{norm}")
    for dense in ("in_proj", "out_proj", "linear1", "linear2"):
        _dense(p[dense], sd, f"{prefix}.{dense}")


# the dense layers of each block layout (the JAX tree's names are the
# port's): divided, trajectory, joint
_BLOCK_DENSES = {
    "divided": ("timeattn.qkv", "timeattn.proj", "attn.qkv", "attn.proj"),
    "trajectory": ("attn_qkv", "attn_proj_q", "attn_proj_kv", "attn_proj"),
    "joint": ("attn_qkv", "attn_proj"),
}


def encoder_state_dict(p: Tree) -> Dict[str, torch.Tensor]:
    """Every block layout, the embeddings of both kinds, the aggregation
    layers the tree holds; an int8 tree's ``kernel_q``/``scale`` too."""
    sd: Dict[str, torch.Tensor] = {}
    pe = p["patch_embed_3d"]
    sd["patch_embed_3d.weight"] = _t(np.asarray(pe["kernel"]).transpose(4, 3, 0, 1, 2))
    sd["patch_embed_3d.bias"] = _t(pe["bias"])
    for name in ("cls_token", "pos_embed", "temp_embed", "st_embed"):
        if name in p:
            sd[name] = _t(p[name])
    bp = p["blocks"]
    layout = ("divided" if "timeattn" in bp else
              "trajectory" if "attn_proj_q" in bp else "joint")
    norms = ("norm1", "norm2", "norm3") if layout == "divided" else (
        "norm1", "norm2")
    denses = _BLOCK_DENSES[layout] + ("mlp.fc1", "mlp.fc2")
    depth = np.asarray(bp["norm1"]["scale"]).shape[0]
    for i in range(depth):
        pre = f"blocks.{i}"
        for norm in norms:
            _ln(bp[norm], sd, f"{pre}.{norm}", i)
        for name in denses:
            node = bp
            for part in name.split("."):
                node = node[part]
            _dense(node, sd, f"{pre}.{name}", i)
    _ln(p["norm"], sd, "norm")
    for agg in ("spatial_attn_agg", "temp_attn_agg", "global_attn_agg"):
        if agg in p:
            _agg_layer(p[agg], sd, agg)
    return sd


def _conv1d(p: Tree, sd: Dict[str, torch.Tensor], prefix: str) -> None:
    c = p["conv"]
    sd[f"{prefix}.weight"] = _t(np.asarray(c["kernel"]).transpose(2, 1, 0))
    sd[f"{prefix}.bias"] = _t(c["bias"])


def _res_unit(p: Tree, sd: Dict[str, torch.Tensor], prefix: str) -> None:
    sd[f"{prefix}.snake1.alpha"] = _t(p["snake1"]["alpha"])
    _conv1d(p["conv1"], sd, f"{prefix}.conv1")
    sd[f"{prefix}.snake2.alpha"] = _t(p["snake2"]["alpha"])
    _conv1d(p["conv2"], sd, f"{prefix}.conv2")


def dac_state_dict(p: Tree) -> Dict[str, torch.Tensor]:
    """Quantizer, decoder and, where the tree has it, the encoder."""
    sd: Dict[str, torch.Tensor] = {}
    for name, a in p["quantizer"].items():
        sd[f"quantizer.{name}"] = _t(a)
    if "encoder" in p:
        e = p["encoder"]
        _conv1d(e["conv_in"], sd, "encoder.conv_in")
        i = 0
        while f"block{i}" in e:
            bp, pre = e[f"block{i}"], f"encoder.blocks.{i}"
            for r in ("res1", "res2", "res3"):
                _res_unit(bp[r], sd, f"{pre}.{r}")
            sd[f"{pre}.snake.alpha"] = _t(bp["snake"]["alpha"])
            _conv1d(bp["down"], sd, f"{pre}.down")
            i += 1
        sd["encoder.snake_out.alpha"] = _t(e["snake_out"]["alpha"])
        _conv1d(e["conv_out"], sd, "encoder.conv_out")
    d = p["decoder"]
    _conv1d(d["conv_in"], sd, "decoder.conv_in")
    i = 0
    while f"block{i}" in d:
        bp, pre = d[f"block{i}"], f"decoder.blocks.{i}"
        sd[f"{pre}.snake.alpha"] = _t(bp["snake"]["alpha"])
        sd[f"{pre}.up.weight"] = _t(np.asarray(bp["up"]["kernel"]).transpose(1, 2, 0))
        sd[f"{pre}.up.bias"] = _t(bp["up"]["bias"])
        for r in ("res1", "res2", "res3"):
            _res_unit(bp[r], sd, f"{pre}.{r}")
        i += 1
    sd["decoder.snake_out.alpha"] = _t(d["snake_out"]["alpha"])
    _conv1d(d["conv_out"], sd, "decoder.conv_out")
    return sd


def bridge_state_dict(p: Tree) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    _dense(p["fc1"], sd, "fc1")
    _dense(p["fc2"], sd, "fc2")
    return sd


def lora_state_dict(p: Tree) -> Dict[str, torch.Tensor]:
    """``init_lora``'s tree (``{path: {"lora_a" [(L,) in, r], "lora_b"
    [(L,) r, out]}}``) -> one ``lora_a [r, in]`` / ``lora_b [out, r]`` per
    adapted layer, at the layer's name (``layers.{i}.attention.wqkv``)."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(node: Tree, path: tuple) -> None:
        for k, v in node.items():
            if hasattr(v, "items"):
                walk(v, path + (k,))
                continue
            a = np.asarray(v)
            if path[0] == "layers":  # stacked: one pair per layer
                for i in range(a.shape[0]):
                    name = ".".join(("layers", str(i)) + path[1:] + (k,))
                    sd[name] = _t(a[i].T)
            else:
                sd[".".join(path + (k,))] = _t(a.T)

    walk(p, ())
    return sd


_CONVERTERS = {
    "sampler": sampler_state_dict,
    "encoder": encoder_state_dict,
    "dac": dac_state_dict,
    "bridge": bridge_state_dict,
    "lora_sampler": lora_state_dict,
}


def from_jax_params(tree: Tree) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's parameter tree (nested dicts of numpy arrays) ->
    the port's state dicts for each subtree present."""
    return {name: fn(tree[name]) for name, fn in _CONVERTERS.items()
            if name in tree}
