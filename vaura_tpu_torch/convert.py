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
``quantize_sampler_params`` tree (``kernel_q [in, out]`` int8, ``scale
[out]``) become ``kernel_q [out, in]`` int8 and ``scale`` buffers, for a
sampler built with ``quantize_weights=True``.

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
    if "kernel_q" in p:  # int8 weights of ``quantize_sampler_params``
        q, sc = np.asarray(p["kernel_q"]), np.asarray(p["scale"])
        q, sc = (q, sc) if index is None else (q[index], sc[index])
        out[f"{prefix}.kernel_q"] = torch.from_numpy(
            np.ascontiguousarray(q.T).astype(np.int8))
        out[f"{prefix}.scale"] = _t(sc)
        return
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


def encoder_state_dict(p: Tree) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    pe = p["patch_embed_3d"]
    sd["patch_embed_3d.weight"] = _t(np.asarray(pe["kernel"]).transpose(4, 3, 0, 1, 2))
    sd["patch_embed_3d.bias"] = _t(pe["bias"])
    for name in ("cls_token", "pos_embed", "temp_embed"):
        sd[name] = _t(p[name])
    bp = p["blocks"]
    depth = np.asarray(bp["norm1"]["scale"]).shape[0]
    for i in range(depth):
        pre = f"blocks.{i}"
        for norm in ("norm1", "norm2", "norm3"):
            _ln(bp[norm], sd, f"{pre}.{norm}", i)
        for att in ("timeattn", "attn"):
            _dense(bp[att]["qkv"], sd, f"{pre}.{att}.qkv", i)
            _dense(bp[att]["proj"], sd, f"{pre}.{att}.proj", i)
        _dense(bp["mlp"]["fc1"], sd, f"{pre}.mlp.fc1", i)
        _dense(bp["mlp"]["fc2"], sd, f"{pre}.mlp.fc2", i)
    _ln(p["norm"], sd, "norm")
    if "spatial_attn_agg" in p:
        ap = p["spatial_attn_agg"]
        sd["spatial_attn_agg.cls_token"] = _t(ap["cls_token"])
        for norm in ("norm1", "norm2"):
            _ln(ap[norm], sd, f"spatial_attn_agg.{norm}")
        for dense in ("in_proj", "out_proj", "linear1", "linear2"):
            _dense(ap[dense], sd, f"spatial_attn_agg.{dense}")
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


_CONVERTERS = {
    "sampler": sampler_state_dict,
    "encoder": encoder_state_dict,
    "dac": dac_state_dict,
    "bridge": bridge_state_dict,
}


def from_jax_params(tree: Tree) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's parameter tree (nested dicts of numpy arrays) ->
    the port's state dicts for each subtree present."""
    if "lora_sampler" in tree:
        raise NotImplementedError("LoRA adapters are not ported; merge them "
                                  "into the sampler first")
    return {name: fn(tree[name]) for name, fn in _CONVERTERS.items()
            if name in tree}
