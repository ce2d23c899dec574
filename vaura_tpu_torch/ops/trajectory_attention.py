"""The spatial step of trajectory attention, exact and approximated.

Counterpart of ``vaura_tpu/ops/trajectory_attention.py`` (no kernel there:
batched products and softmaxes). Every function maps ``q, k, v [BH, N, d]``
(batch and heads folded by the caller; ``N = F * P`` tokens of ``F`` frames
of ``P`` locations, frame-major) to ``[BH, N, F, d]``: for every query
token, one attention-weighted "trajectory point" per frame. Softmaxes run
in float32; probabilities are cast to the value dtype before the value
product, as the JAX package does.

Randomness is explicit. ``orthoformer`` takes the first landmark of each
row (``first [BH]``) or a ``torch.Generator`` that draws it;
``performer_spatial_attn`` takes its random features (``proj [m, d]``) or a
generator that draws them (``orthogonal_gaussian``). The JAX package draws
both from ``PRNGKey(0)``; ``jax.random`` cannot be reproduced here, so the
draws differ while the functions are the same (the tests inject JAX's
draws).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "trajectory_spatial_full",
    "nystrom_spatial_attn",
    "orthoformer",
    "performer_spatial_attn",
    "first_landmarks",
    "orthogonal_gaussian",
]


def _softmax32(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.softmax(x.float(), dim=dim)


def trajectory_spatial_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            num_frames: int) -> torch.Tensor:
    """Every query against every key (scaled here), softmax within each
    frame's keys, one value sum per frame."""
    BH, N, d = q.shape
    F, P = num_frames, N // num_frames
    scores = torch.einsum("bnd,bmd->bnm", q.float(), k.float()) * d ** -0.5
    probs = _softmax32(scores.reshape(BH, N, F, P))
    return torch.einsum("bnfp,bfpd->bnfd", probs.to(v.dtype),
                        v.reshape(BH, F, P, d))


def _newton_schulz_pinv(K: torch.Tensor, n_iter: int = 6) -> torch.Tensor:
    """Quartic Newton-Schulz iteration for the pseudo-inverse of row-
    stochastic matrices ``[..., L, L]``, in float32."""
    K = K.float()
    eye = torch.eye(K.shape[-1], dtype=torch.float32, device=K.device)
    V = K.transpose(-1, -2) / K.sum(dim=-2).amax(dim=-1)[..., None, None]
    for _ in range(n_iter):
        KV = K @ V
        V = 0.25 * V @ (13.0 * eye - KV @ (15.0 * eye - KV @ (7.0 * eye - KV)))
    return V


def _segment_means(x: torch.Tensor, landmarks: int) -> torch.Tensor:
    """Mean of ``landmarks`` contiguous segments of ``[BH, N, d]``; when
    ``N % landmarks`` the first ``num_k`` segments hold ``N // landmarks``
    tokens and the rest one more."""
    BH, N, d = x.shape
    L = landmarks
    if N % L == 0:
        return x.reshape(BH, L, N // L, d).mean(dim=-2)
    segs = N // L
    num_k = (segs + 1) * L - N
    first = x[:, :num_k * segs].reshape(BH, num_k, segs, d).mean(dim=-2)
    last = x[:, num_k * segs:].reshape(BH, L - num_k, segs + 1, d).mean(dim=-2)
    return torch.cat([first, last], dim=-2)


def nystrom_spatial_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         landmarks: int = 64, num_frames: int = 8,
                         inv_iters: int = 6,
                         use_spatial_landmarks: bool = True) -> torch.Tensor:
    """Nystrom factorisation of the space-time scores through segment-mean
    landmarks (of tokens grouped by spatial location when
    ``use_spatial_landmarks``), softmax over the spatial axis only."""
    BH, N, d = k.shape
    F, P = num_frames, N // num_frames
    q = q * d ** -0.5
    if use_spatial_landmarks:
        q2 = q.reshape(BH, F, P, d).transpose(1, 2).reshape(BH, N, d)
        k2 = k.reshape(BH, F, P, d).transpose(1, 2).reshape(BH, N, d)
    else:
        q2, k2 = q, k
    q_land = _segment_means(q2, landmarks).detach()
    k_land = _segment_means(k2, landmarks).detach()
    kernel_1 = _softmax32(torch.einsum("bnd,bld->bnl", q, k_land))
    kernel_2 = _softmax32(torch.einsum("bld,bmd->blm", q_land, k_land))
    kernel_3 = _softmax32(
        torch.einsum("bld,bnd->bln", q_land, k).reshape(BH, landmarks, F, P))
    attn = kernel_1 @ _newton_schulz_pinv(kernel_2, inv_iters)
    lv = torch.einsum("blfp,bfpd->blfd", kernel_3.to(v.dtype),
                      v.reshape(BH, F, P, d))
    return torch.einsum("bnl,blfd->bnfd", attn.to(v.dtype), lv)


def first_landmarks(BH: int, N: int, generator: torch.Generator,
                    device=None) -> torch.Tensor:
    """One uniform index in ``[0, N)`` a row, drawn from ``generator`` on its
    device and moved to ``device``."""
    idx = torch.randint(0, N, (BH,), generator=generator,
                        device=generator.device)
    return idx.to(device)


def _landmark_indices(q: torch.Tensor, num_landmarks: int,
                      first: torch.Tensor) -> torch.Tensor:
    """Greedy choice of ``num_landmarks`` near-orthogonal queries a row: from
    ``first``, add each time the candidate whose largest |cosine| to the
    chosen ones is least (ties to the lowest index). Returns their indices
    ``[BH, num_landmarks]``."""
    BH, N, d = q.shape
    qn = q.float()
    qn = qn / qn.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    last = first.to(device=q.device, dtype=torch.long)[:, None]  # [BH, 1]
    # the largest |cosine| of every candidate to the chosen ones; a chosen
    # one holds +inf, so it is never chosen again
    max_cos = torch.zeros(BH, N, dtype=torch.float32, device=q.device)
    max_cos.scatter_(1, last, float("inf"))
    sel = [last]
    for _ in range(1, num_landmarks):
        chosen = qn.gather(1, last[..., None].expand(BH, 1, d))  # [BH, 1, d]
        cos = torch.bmm(qn, chosen.transpose(1, 2))[..., 0].abs()
        max_cos = torch.maximum(max_cos, cos)
        last = max_cos.argmin(dim=-1, keepdim=True)
        max_cos.scatter_(1, last, float("inf"))
        sel.append(last)
    return torch.cat(sel, dim=1)


def _orthogonal_landmarks(q: torch.Tensor, num_landmarks: int,
                          first: torch.Tensor) -> torch.Tensor:
    """The queries ``_landmark_indices`` chooses, as they are, ``[BH,
    num_landmarks, d]``."""
    sel = _landmark_indices(q, num_landmarks, first)
    return torch.gather(q, 1, sel[..., None].expand(*sel.shape, q.shape[-1]))


def orthoformer(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                num_landmarks: int = 64, num_frames: int = 8,
                first: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Queries and keys attend through shared near-orthogonal landmark
    queries. ``first [BH]`` is each row's first landmark, else drawn from
    ``generator`` (one of them is needed)."""
    BH, N, d = k.shape
    F, P = num_frames, N // num_frames
    if first is None:
        if generator is None:
            raise ValueError("orthoformer needs `first` or a `generator`")
        first = first_landmarks(BH, N, generator, q.device)
    scale = d ** -0.25
    q, k = q * scale, k * scale
    lm = _orthogonal_landmarks(q, num_landmarks, first).detach()
    kernel_1 = _softmax32(torch.einsum("bnd,bld->bnl", q, lm))
    kernel_2 = _softmax32(
        torch.einsum("bld,bnd->bln", lm, k).reshape(BH, num_landmarks, F, P))
    lv = torch.einsum("blfp,bfpd->blfd", kernel_2.to(v.dtype),
                      v.reshape(BH, F, P, d))
    return torch.einsum("bnl,blfd->bnfd", kernel_1.to(v.dtype), lv)


def orthogonal_gaussian(m: int, d: int, generator: torch.Generator,
                        device=None) -> torch.Tensor:
    """``[m, d]`` random features: blocks of orthogonal rows (QR of Gaussian
    ``[d, d]`` matrices) scaled by chi-distributed norms, drawn from
    ``generator`` on its device and moved to ``device``."""
    gdev = generator.device
    normal = lambda *s: torch.randn(*s, generator=generator, device=gdev)
    blocks = []
    n_full, rem = divmod(m, d)
    for _ in range(n_full):
        blocks.append(torch.linalg.qr(normal(d, d))[0].T)
    if rem:
        blocks.append(torch.linalg.qr(normal(d, d))[0].T[:rem])
    norms = normal(m, d).pow(2).sum(dim=-1).sqrt()
    return (torch.cat(blocks) * norms[:, None]).to(device)


def _softmax_kernel(x: torch.Tensor, proj: torch.Tensor, is_query: bool,
                    eps: float = 1e-6) -> torch.Tensor:
    """Positive random features of the softmax kernel, ``exp(W x / d^(1/4)
    - |x|^2 / (2 sqrt d) - stabiliser) / sqrt(m)`` in float32; the
    stabiliser is a query's own maximum, or the maximum over all keys of a
    row."""
    m, d = proj.shape
    xf = x.float()
    wx = torch.einsum("bnd,md->bnm", xf * d ** -0.25, proj.float())
    z = wx - xf.pow(2).sum(dim=-1, keepdim=True) / (2.0 * d ** 0.5)
    stab = (z.amax(dim=-1, keepdim=True) if is_query
            else z.amax(dim=(-1, -2), keepdim=True))
    return m ** -0.5 * (torch.exp(z - stab) + eps)


def performer_spatial_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_frames: int = 8, num_features: int = 256,
                           proj: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """Linear attention through positive random features, normalised per
    frame. ``proj [num_features, d]`` are the features, else drawn from
    ``generator`` (one of them is needed)."""
    BH, N, d = k.shape
    F, P = num_frames, N // num_frames
    if proj is None:
        if generator is None:
            raise ValueError("performer_spatial_attn needs `proj` or a "
                             "`generator`")
        proj = orthogonal_gaussian(num_features, d, generator, q.device)
    q_p = _softmax_kernel(q, proj, is_query=True)
    k_p = _softmax_kernel(k, proj, is_query=False).reshape(BH, F, P, -1)
    vf = v.reshape(BH, F, P, d).float()
    kv = torch.einsum("bfpm,bfpd->bfmd", k_p, vf)
    num = torch.einsum("bnm,bfmd->bnfd", q_p, kv)
    den = torch.einsum("bnm,bfm->bnf", q_p, k_p.sum(dim=2))
    return (num / den[..., None]).to(v.dtype)
