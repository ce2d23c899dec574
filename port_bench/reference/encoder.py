"""Plain float32 reference of V-AURA's visual encoder: Segment-AVCLIP's
MotionFormer (``avclip_vggsound.yaml``), a divided space-time ViT-B/16 over
16-frame 224 x 224 segments, then a per-frame CLS aggregation layer over
the spatial locations.

frames ``[B, S, 3, 16, 224, 224]`` -> features ``[B, S * 8, 768]``:

* a 2 x 16 x 16 tubelet embedding (a strided 3D conv), a CLS token, the
  spatial position table tiled over the 8 time rows plus a temporal table;
* each block: time attention (the CLS query over every token; each token
  over the tokens of its spatial location across time, plus the CLS key),
  then space attention (each token over its frame's tokens plus the CLS
  key), then the MLP, each pre-norm with a residual;
* LayerNorm of the tokens, then per frame a pre-norm transformer encoder
  layer with its own CLS token over the 196 locations, whose CLS output is
  the frame's feature.

Inference only (no dropout, no stochastic depth), float32 throughout.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Spec = Tuple[str, Tuple[int, ...], str]


def widths(cfg: dict) -> dict:
    D = cfg.get("embed_dim", 768)
    g = cfg.get("img_size", 224) // cfg.get("patch_size", 16)
    return {"D": D, "H": cfg.get("num_heads", 12), "depth": cfg.get("depth", 12),
            "mlp": cfg.get("mlp_ratio", 4) * D, "p": cfg.get("patch_size", 16),
            "z": cfg.get("z_block_size", 2), "hw": g * g,
            "t": cfg.get("temporal_resolution", 8),
            "eps": cfg.get("norm_eps", 1e-6), "C": cfg.get("in_chans", 3)}


def _ln_specs(p: str, D: int) -> List[Spec]:
    return [(p + ".scale", (D,), "ones"), (p + ".bias", (D,), "zeros")]


def _dense_specs(p: str, i: int, o: int) -> List[Spec]:
    return [(p + ".weight", (o, i), "fan_in"), (p + ".bias", (o,), "zeros")]


def param_specs(cfg: dict) -> List[Spec]:
    """Every parameter as ``(name, shape, init)`` (see
    ``reference.sampler.param_specs``)."""
    w = widths(cfg)
    D, M = w["D"], w["mlp"]
    specs: List[Spec] = [
        ("patch_embed_3d.weight", (D, w["C"], w["z"], w["p"], w["p"]), "fan_in"),
        ("patch_embed_3d.bias", (D,), "zeros"),
        ("cls_token", (1, 1, D), "emb"),
        ("pos_embed", (1, w["hw"] + 1, D), "emb"),
        ("temp_embed", (1, w["t"], D), "emb"),
    ]
    for i in range(w["depth"]):
        b = f"blocks.{i}."
        specs += _ln_specs(b + "norm3", D)
        specs += _dense_specs(b + "timeattn.qkv", D, 3 * D)
        specs += _dense_specs(b + "timeattn.proj", D, D)
        specs += _ln_specs(b + "norm1", D)
        specs += _dense_specs(b + "attn.qkv", D, 3 * D)
        specs += _dense_specs(b + "attn.proj", D, D)
        specs += _ln_specs(b + "norm2", D)
        specs += _dense_specs(b + "mlp.fc1", D, M)
        specs += _dense_specs(b + "mlp.fc2", M, D)
    specs += _ln_specs("norm", D)
    a = "spatial_attn_agg."
    specs += [(a + "cls_token", (1, 1, D), "emb")]
    specs += _ln_specs(a + "norm1", D)
    specs += _dense_specs(a + "in_proj", D, 3 * D)
    specs += _dense_specs(a + "out_proj", D, D)
    specs += _ln_specs(a + "norm2", D)
    specs += _dense_specs(a + "linear1", D, M)
    specs += _dense_specs(a + "linear2", M, D)
    return specs


def _ln(sd, p, x, eps):
    return F.layer_norm(x, x.shape[-1:], sd[p + ".scale"].float(),
                        sd[p + ".bias"].float(), eps)


def _dense(sd, p, x):
    return F.linear(x, sd[p + ".weight"].float(), sd[p + ".bias"].float())


def _divided(sd, p, x, H, f, n, axis):
    """One divided-attention axis over ``x [B, 1 + f*n, D]`` (CLS first,
    tokens frame-major)."""
    B, N, D = x.shape
    hd = D // H
    q, k, v = _dense(sd, p + ".qkv", x).reshape(B, N, 3, H, hd).unbind(2)
    q = q * hd ** -0.5
    cls = torch.einsum("bhn,bnhd->bhd",
                       torch.einsum("bhd,bnhd->bhn", q[:, 0], k).softmax(-1), v)
    grid = lambda t: t[:, 1:].reshape(B, f, n, H, hd)
    qg, kg, vg = grid(q), grid(k), grid(v)
    if axis == "time":  # groups are locations, members the f frames
        qg, kg, vg = (t.transpose(1, 2) for t in (qg, kg, vg))
    # [B, G, L, H, hd] with the CLS key and value appended to every group
    G, L = qg.shape[1], qg.shape[2]
    kc = torch.cat([k[:, 0][:, None, None].expand(B, G, 1, H, hd), kg], 2)
    vc = torch.cat([v[:, 0][:, None, None].expand(B, G, 1, H, hd), vg], 2)
    att = torch.einsum("bglhd,bgmhd->bghlm", qg, kc).softmax(-1)
    out = torch.einsum("bghlm,bgmhd->bglhd", att, vc)
    if axis == "time":
        out = out.transpose(1, 2)
    out = torch.cat([cls.reshape(B, 1, D), out.reshape(B, f * n, D)], 1)
    return _dense(sd, p + ".proj", out)


def _aggregate(sd, p, x, H, eps):
    """The CLS output of a pre-norm encoder layer over ``x [R, N, D]``."""
    R, N, D = x.shape
    hd = D // H
    x = torch.cat([sd[p + ".cls_token"].float().expand(R, 1, D), x], 1)
    q, k, v = _dense(sd, p + ".in_proj", _ln(sd, p + ".norm1", x, eps)).chunk(3, -1)
    heads = lambda t: t.reshape(R, N + 1, H, hd).transpose(1, 2)
    att = torch.softmax(heads(q) * hd ** -0.5 @ heads(k).transpose(-1, -2), -1)
    o = (att @ heads(v)).transpose(1, 2).reshape(R, N + 1, D)
    x = x + _dense(sd, p + ".out_proj", o)
    h = _dense(sd, p + ".linear2", F.gelu(_dense(sd, p + ".linear1",
                                                 _ln(sd, p + ".norm2", x, eps))))
    return (x + h)[:, 0]


def features(sd: Dict[str, torch.Tensor], cfg: dict, frames: torch.Tensor
             ) -> torch.Tensor:
    """Frames ``[B, S, C, T, H, W]`` -> features ``[B, S * t, D]``."""
    w = widths(cfg)
    B, S, C, T, Hh, Ww = frames.shape
    D, H, hw, eps = w["D"], w["H"], w["hw"], w["eps"]
    t = T // w["z"]
    x = F.conv3d(frames.reshape(B * S, C, T, Hh, Ww).float(),
                 sd["patch_embed_3d.weight"].float(),
                 sd["patch_embed_3d.bias"].float(),
                 stride=(w["z"], w["p"], w["p"]))
    x = x.flatten(2).transpose(1, 2)  # [BS, t*hw, D], frame-major
    pos = sd["pos_embed"].float()
    tok_pos = pos[:, 1:].repeat(1, t, 1) + sd["temp_embed"].float().repeat_interleave(hw, 1)
    x = torch.cat([sd["cls_token"].float().expand(B * S, 1, D) + pos[:, :1],
                   x + tok_pos], 1)
    for i in range(w["depth"]):
        b = f"blocks.{i}."
        x = x + _divided(sd, b + "timeattn", _ln(sd, b + "norm3", x, eps), H, t,
                         hw, "time")
        x = x + _divided(sd, b + "attn", _ln(sd, b + "norm1", x, eps), H, t, hw,
                         "space")
        h = _dense(sd, b + "mlp.fc2", F.gelu(_dense(sd, b + "mlp.fc1",
                                                    _ln(sd, b + "norm2", x, eps))))
        x = x + h
    x = _ln(sd, "norm", x[:, 1:], eps).reshape(B * S * t, hw, D)
    x = _aggregate(sd, "spatial_attn_agg", x, H, eps)
    return x.reshape(B, S * t, D)
