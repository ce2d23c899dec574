"""Reference (torch) checkpoints -> the port's state dicts.

Counterpart of ``vaura_tpu/models/convert.py``. The reference ecosystem's
state dicts map by name, directly, onto the state dicts of the port's
modules (``VauraSystem.load_state_dicts``), with no flax tree in between:

  * ``convert_dac_state_dict`` — descript-audio-codec weights, weight norm
    folded (``W = g * v / ||v||``, as the JAX converter folds it);
  * ``strip_avclip_prefix`` + ``convert_motionformer_state_dict`` — the
    visual branch of a Synchformer stage-I (AVCLIP) checkpoint, or a
    Motionformer's, in any of its three block layouts with its aggregation
    layers;
  * ``convert_sampler_state_dict`` — the reference AR decoder
    (``llama.py``), its per-codebook heads fused into one ``lm_head``;
  * ``convert_vaura_checkpoint`` — a reference Lightning ``.ckpt`` into
    ``{sampler, dac, encoder}``.

Torch's layouts are the port's own (``Linear`` ``[out, in]``, ``Conv1d``
``[O, I, W]``, ``ConvTranspose1d`` ``[I, O, W]``), so every mapping is a
rename, a concatenation or the weight-norm fold, computed in numpy exactly
as the JAX converter computes it: the JAX converter followed by
``vaura_tpu_torch.convert.from_jax_params`` gives the same tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C", copy=True))


def _fold_wn(sd: Dict[str, Any], prefix: str) -> np.ndarray:
    """Fold weight-norm params at ``prefix`` into a single weight."""
    for v_key, g_key in (("weight_v", "weight_g"),
                         ("parametrizations.weight.original1",
                          "parametrizations.weight.original0")):
        if f"{prefix}.{v_key}" in sd:
            v = _np(sd[f"{prefix}.{v_key}"])
            g = _np(sd[f"{prefix}.{g_key}"])
            norm = np.sqrt((v**2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
            return g * v / (norm + 1e-12)
    return _np(sd[f"{prefix}.weight"])


def _max_index(sd: Dict[str, Any], prefix: str) -> int:
    """1 + highest integer following ``prefix`` in the key set (0 if none)."""
    best = -1
    plen = len(prefix)
    for k in sd:
        if k.startswith(prefix):
            head = k[plen:].split(".", 1)[0]
            if head.isdigit():
                best = max(best, int(head))
    return best + 1


# ------------------------------------------------------------------ #
# DAC
# ------------------------------------------------------------------ #
def _conv1d(sd, src: str, out: StateDict, dst: str) -> None:
    out[f"{dst}.weight"] = _t(_fold_wn(sd, src))
    out[f"{dst}.bias"] = _t(_np(sd[f"{src}.bias"]))


def _snake(sd, src: str, out: StateDict, dst: str) -> None:
    out[f"{dst}.alpha"] = _t(_np(sd[f"{src}.alpha"]).reshape(-1))


def _res_unit(sd, src: str, out: StateDict, dst: str) -> None:
    # DAC ResidualUnit: block.0 Snake, block.1 WNConv1d(k7), block.2 Snake,
    # block.3 WNConv1d(k1)
    _snake(sd, f"{src}.block.0", out, f"{dst}.snake1")
    _conv1d(sd, f"{src}.block.1", out, f"{dst}.conv1")
    _snake(sd, f"{src}.block.2", out, f"{dst}.snake2")
    _conv1d(sd, f"{src}.block.3", out, f"{dst}.conv2")


def convert_dac_state_dict(sd: Dict[str, Any],
                           n_enc_blocks: Optional[int] = None,
                           n_dec_blocks: Optional[int] = None,
                           n_codebooks: Optional[int] = None) -> StateDict:
    """descript-audio-codec state dict -> the port's ``Dac`` state dict.
    Block/codebook counts default to what the key set encodes
    (``encoder.block.N`` spans conv_in + blocks + snake + conv_out)."""
    sd = {k.replace("model.", "", 1) if k.startswith("model.") else k: v
          for k, v in sd.items()}
    if n_enc_blocks is None:
        n_enc_blocks = _max_index(sd, "encoder.block.") - 3
    if n_dec_blocks is None:
        n_dec_blocks = _max_index(sd, "decoder.model.") - 3
    if n_codebooks is None:
        n_codebooks = _max_index(sd, "quantizer.quantizers.")
    out: StateDict = {}
    _conv1d(sd, "encoder.block.0", out, "encoder.conv_in")
    for i in range(n_enc_blocks):
        src, dst = f"encoder.block.{i + 1}.block", f"encoder.blocks.{i}"
        for r in range(3):
            _res_unit(sd, f"{src}.{r}", out, f"{dst}.res{r + 1}")
        _snake(sd, f"{src}.3", out, f"{dst}.snake")
        _conv1d(sd, f"{src}.4", out, f"{dst}.down")
    _snake(sd, f"encoder.block.{n_enc_blocks + 1}", out, "encoder.snake_out")
    _conv1d(sd, f"encoder.block.{n_enc_blocks + 2}", out, "encoder.conv_out")

    _conv1d(sd, "decoder.model.0", out, "decoder.conv_in")
    for i in range(n_dec_blocks):
        src, dst = f"decoder.model.{i + 1}.block", f"decoder.blocks.{i}"
        _snake(sd, f"{src}.0", out, f"{dst}.snake")
        W = _fold_wn(sd, f"{src}.1")  # ConvTranspose1d [I, O, W]
        out[f"{dst}.up.weight"] = _t(W)
        out[f"{dst}.up.bias"] = _t(_np(sd.get(
            f"{src}.1.bias", np.zeros(W.shape[1], np.float32))))
        for r in range(3):
            _res_unit(sd, f"{src}.{r + 2}", out, f"{dst}.res{r + 1}")
    _snake(sd, f"decoder.model.{n_dec_blocks + 1}", out, "decoder.snake_out")
    _conv1d(sd, f"decoder.model.{n_dec_blocks + 2}", out, "decoder.conv_out")

    quant = {"codebooks": [], "in_proj_w": [], "in_proj_b": [],
             "out_proj_w": [], "out_proj_b": []}
    for k in range(n_codebooks):
        p = f"quantizer.quantizers.{k}"
        quant["codebooks"].append(_np(sd[f"{p}.codebook.weight"]))  # [V, cd]
        quant["in_proj_w"].append(_fold_wn(sd, f"{p}.in_proj")[:, :, 0].T)
        quant["in_proj_b"].append(_np(sd[f"{p}.in_proj.bias"]))
        quant["out_proj_w"].append(_fold_wn(sd, f"{p}.out_proj")[:, :, 0].T)
        quant["out_proj_b"].append(_np(sd[f"{p}.out_proj.bias"]))
    for name, arrays in quant.items():
        out[f"quantizer.{name}"] = _t(np.stack(arrays))
    return out


# ------------------------------------------------------------------ #
# MotionFormer
# ------------------------------------------------------------------ #
def _copy(sd, src: str, out: StateDict, dst: str, bias: bool = True) -> None:
    out[f"{dst}.weight"] = _t(_np(sd[f"{src}.weight"]))
    if bias and f"{src}.bias" in sd:
        out[f"{dst}.bias"] = _t(_np(sd[f"{src}.bias"]))


def _layernorm(sd, src: str, out: StateDict, dst: str) -> None:
    out[f"{dst}.scale"] = _t(_np(sd[f"{src}.weight"]))
    out[f"{dst}.bias"] = _t(_np(sd[f"{src}.bias"]))


def strip_avclip_prefix(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only the visual branch of a Synchformer stage-I (AVCLIP) ckpt
    (reference ``motionformer.py:217-241``)."""
    out = {}
    for k, v in sd.items():
        if k.startswith(("module.v_encoder.", "v_encoder.")):
            out[k.replace("module.", "").replace("v_encoder.", "")] = v
    return out if out else sd


def _agg_layer(sd, src: str, out: StateDict) -> None:
    """A CLS aggregation layer (reference ``BaseEncoderLayer``,
    ``motionformer.py:367-462``): the spatial, temporal and global ones
    share one layout, the global one with ``pos_emb``."""
    out[f"{src}.cls_token"] = _t(_np(sd[f"{src}.cls_token"]))
    if f"{src}.pos_emb" in sd:
        out[f"{src}.pos_emb"] = _t(_np(sd[f"{src}.pos_emb"]))
    out[f"{src}.in_proj.weight"] = _t(_np(sd[f"{src}.self_attn.in_proj_weight"]))
    out[f"{src}.in_proj.bias"] = _t(_np(sd[f"{src}.self_attn.in_proj_bias"]))
    _copy(sd, f"{src}.self_attn.out_proj", out, f"{src}.out_proj")
    _copy(sd, f"{src}.linear1", out, f"{src}.linear1")
    _copy(sd, f"{src}.linear2", out, f"{src}.linear2")
    _layernorm(sd, f"{src}.norm1", out, f"{src}.norm1")
    _layernorm(sd, f"{src}.norm2", out, f"{src}.norm2")


# (reference name, port name) of each block layout's attention layers:
# trajectory (``vit_helper.py:174``: ``attn.proj_q``/``proj_kv``), divided
# (``:392``: a separate ``timeattn``), joint (neither)
_BLOCK_LAYERS = {
    "trajectory": (("attn.qkv", "attn_qkv"), ("attn.proj_q", "attn_proj_q"),
                   ("attn.proj_kv", "attn_proj_kv"), ("attn.proj", "attn_proj")),
    "divided": (("timeattn.qkv", "timeattn.qkv"),
                ("timeattn.proj", "timeattn.proj"), ("attn.qkv", "attn.qkv"),
                ("attn.proj", "attn.proj")),
    "joint": (("attn.qkv", "attn_qkv"), ("attn.proj", "attn_proj")),
}


def convert_motionformer_state_dict(
    sd: Dict[str, Any], depth: Optional[int] = None
) -> StateDict:
    """Motionformer/Synchformer visual encoder -> the port's
    ``MotionFormer`` state dict: the block layout read off the key set
    (trajectory, divided or joint), separate or joint positional
    embeddings, and the spatial, temporal and global aggregation layers the
    checkpoint holds. ``depth`` defaults to the block count the key set
    encodes."""
    if depth is None:
        depth = _max_index(sd, "blocks.")
    layout = ("trajectory" if "blocks.0.attn.proj_q.weight" in sd else
              "divided" if "blocks.0.timeattn.qkv.weight" in sd else "joint")
    out: StateDict = {}
    _copy(sd, "patch_embed_3d.proj", out, "patch_embed_3d")
    for name in ("cls_token", "pos_embed", "temp_embed", "st_embed"):
        if name in sd:
            out[name] = _t(_np(sd[name]))
    norms = ("norm1", "norm2", "norm3") if layout == "divided" else (
        "norm1", "norm2")
    layers = _BLOCK_LAYERS[layout] + (("mlp.fc1", "mlp.fc1"),
                                      ("mlp.fc2", "mlp.fc2"))
    for i in range(depth):
        p = f"blocks.{i}"
        for norm in norms:
            _layernorm(sd, f"{p}.{norm}", out, f"{p}.{norm}")
        for src, dst in layers:
            _copy(sd, f"{p}.{src}", out, f"{p}.{dst}")
    _layernorm(sd, "norm", out, "norm")
    for agg in ("spatial_attn_agg", "temp_attn_agg", "global_attn_agg"):
        if f"{agg}.cls_token" in sd:
            _agg_layer(sd, agg, out)
    return out


# ------------------------------------------------------------------ #
# AR sampler
# ------------------------------------------------------------------ #
def convert_sampler_state_dict(
    sd: Dict[str, Any], num_layers: int = 24, num_codebooks: int = 9,
) -> StateDict:
    """Reference ``Transformer`` (llama.py) weights -> the port's
    ``Sampler`` state dict (one ``lm_head`` for all codebooks, the factored
    DAC embeddings of all codebooks in one table)."""
    out: StateDict = {}
    embs, pv, pg, pb = [], [], [], []
    for k in range(num_codebooks):
        p = f"tok_embeddings.{k}"
        embs.append(_np(sd[f"{p}.emb.weight"]))  # [V+1, cd]
        if f"{p}.out_proj.weight_v" in sd or f"{p}.out_proj.weight" in sd:
            v = (
                _np(sd[f"{p}.out_proj.weight_v"])
                if f"{p}.out_proj.weight_v" in sd
                else _np(sd[f"{p}.out_proj.weight"])
            )  # [D, cd, 1]
            g = (
                _np(sd[f"{p}.out_proj.weight_g"]).reshape(-1, 1, 1)
                if f"{p}.out_proj.weight_g" in sd
                else np.sqrt((v**2).sum(axis=(1, 2), keepdims=True))
            )
            pv.append(v[:, :, 0])
            pg.append(g[:, :, 0])
            pb.append(_np(sd[f"{p}.out_proj.bias"]))
    out["tok_embeddings.emb"] = _t(np.concatenate(embs, axis=0))
    out["tok_embeddings.proj_v"] = _t(np.stack(pv))
    out["tok_embeddings.proj_g"] = _t(np.stack(pg))
    out["tok_embeddings.proj_b"] = _t(np.stack(pb))
    _copy(sd, "cls_embeddings.projection.fc1", out, "cls_embeddings.fc1",
          bias=False)
    _copy(sd, "cls_embeddings.projection.fc2", out, "cls_embeddings.fc2",
          bias=False)
    out["cls_embeddings.uncond_embedding"] = _t(
        _np(sd["cls_embeddings.uncond_embedding"]))
    out["empty_video_emb"] = _t(_np(sd["empty_video_emb"]).reshape(-1))
    for i in range(num_layers):
        p = f"layers.{i}"
        for name in ("attention.wqkv", "attention.wo", "feed_forward.w1",
                     "feed_forward.w2", "feed_forward.w3", "attention_norm",
                     "ffn_norm"):
            _copy(sd, f"{p}.{name}", out, f"{p}.{name}", bias=False)
    _copy(sd, "norm", out, "norm", bias=False)
    out["lm_head.weight"] = _t(np.concatenate(
        [_np(sd[f"lm_heads.{k}.weight"]) for k in range(num_codebooks)],
        axis=0))  # [K * vocab, d_model]
    return out


# ------------------------------------------------------------------ #
# full V-AURA Lightning checkpoint
# ------------------------------------------------------------------ #
def infer_sampler_dims(sd: Dict[str, Any]) -> Dict[str, int]:
    """Read layer/codebook counts off a reference ``Transformer`` state
    dict so converter callers don't have to know them up front."""
    return {
        "num_layers": _max_index(sd, "layers."),
        "num_codebooks": _max_index(sd, "lm_heads."),
    }


def convert_vaura_checkpoint(
    ckpt_path: str,
    num_layers: Optional[int] = None,
    num_codebooks: Optional[int] = None,
    encoder_depth: Optional[int] = None,
) -> Dict[str, StateDict]:
    """Reference ``VAURAModel`` Lightning .ckpt -> the port's ``{sampler,
    dac, encoder}`` state dicts (the subtrees the checkpoint holds: the
    reference serializes its frozen submodules into the ckpt,
    ``vaura_model.py:61``). Layer/codebook/depth counts default to what the
    state dict itself encodes. The file is a pickle (``weights_only=False``,
    as a Lightning checkpoint needs): load only checkpoints you trust."""
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)

    def sub(prefix: str) -> Dict[str, Any]:
        plen = len(prefix)
        return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix)}

    out: Dict[str, StateDict] = {}
    sampler_sd = sub("sampler.")
    if sampler_sd:
        dims = infer_sampler_dims(sampler_sd)
        out["sampler"] = convert_sampler_state_dict(
            sampler_sd,
            num_layers=num_layers or dims["num_layers"],
            num_codebooks=num_codebooks or dims["num_codebooks"],
        )
        num_codebooks = num_codebooks or dims["num_codebooks"]
    dac_sd = sub("audio_encoder.model.")
    if dac_sd:
        out["dac"] = convert_dac_state_dict(dac_sd, n_codebooks=num_codebooks)
    enc_sd = sub("visual_feature_extractor.")
    if enc_sd:
        out["encoder"] = convert_motionformer_state_dict(
            enc_sd, depth=encoder_depth)
    return out
