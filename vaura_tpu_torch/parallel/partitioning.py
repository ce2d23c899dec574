"""Parameter placement over the ``(data, fsdp, model)`` mesh.

``_RULES`` and ``spec_for`` are the JAX package's
(``vaura_tpu/parallel/partitioning.py``), over the same "/"-joined JAX
parameter paths, returning each spec as a tuple (``P()`` is ``()``):
megatron layout, column-split up-projections (wqkv, w1/w3), row-split
down-projections (wo, w2), so each block needs one all-reduce per sublayer;
the contracting or output feature axes map onto ``fsdp`` (ZeRO style).

``port_spec`` and ``param_specs`` carry the specs to the port's parameter
names (``convert.py``'s mapping, read backwards): a dense weight is ``[out,
in]`` here and ``[in, out]`` in JAX, so every two-axis spec is transposed
(JAX ``wqkv/kernel`` ``("fsdp", "model")`` is the port's ``("model",
"fsdp")``), the encoder's patch convolution is ``[Cout, Cin, t, h, w]``
against ``[t, h, w, Cin, Cout]``, and the leading ``layers`` / ``blocks``
axis of JAX's stacked trees is one module per layer.

``shard_module`` applies them (``place_modules``). The ``model`` axis
splits the sampler's dense layers eagerly (``parallel/tensor_parallel.py``);
``fsdp`` is FSDP2's ``fully_shard`` over the ``(data, fsdp)`` sub-mesh
(replicated over ``data``, sharded over ``fsdp``) on each decoder block,
each encoder block, the sampler, the encoder and the bridge; the DAC and
LoRA adapters stay replicated, as in JAX. A system placed for generation
alone at ``fsdp`` 1 is not wrapped at all (JAX's specs leave every leaf
whole there). Where the placement differs from JAX's spec,
``MODEL_DIFFERENCES``, ``HEAD_ALIGNED``, ``SPLIT_SCALES`` and ``fsdp_dim``
say so and why.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

Spec = Tuple[Optional[str], ...]

# (regex over "/"-joined param path, spec of the trailing dims); a leading
# scan ("layers") axis is padded with None automatically based on ndim
_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # --- sampler decoder blocks (stacked: leading layers axis) ---
    (r"layers/.*attention/wqkv/kernel", ("fsdp", "model")),
    (r"layers/.*attention/wo/kernel", ("model", "fsdp")),
    (r"layers/.*feed_forward/w1/kernel", ("fsdp", "model")),
    (r"layers/.*feed_forward/w3/kernel", ("fsdp", "model")),
    (r"layers/.*feed_forward/w2/kernel", ("model", "fsdp")),
    (r"layers/.*norm/weight", (None,)),
    # --- embeddings & heads ---
    (r"lm_head/kernel", ("fsdp", "model")),
    (r"tok_embeddings/emb", (None, None)),
    (r"tok_embeddings/proj_v", (None, "model", None)),
    (r"tok_embeddings/proj_g", (None, "model", None)),
    (r"tok_embeddings/proj_b", (None, "model")),
    (r"cls_embeddings/.*/kernel", (None, "model")),
    # --- visual encoder (ViT) blocks + CLS aggregation layers ---
    (r"(blocks|attn_agg)/.*(qkv|fc1|in_proj|linear1)/kernel", ("fsdp", "model")),
    # trajectory attention temporal-step projections (column-split)
    (r"blocks/.*attn_proj_(q|kv)/kernel", ("fsdp", "model")),
    (r"(blocks|attn_agg)/.*(proj|fc2|out_proj|linear2)/kernel", ("model", "fsdp")),
    (r"patch_embed_3d/kernel", (None, None, None, None, "model")),
    # --- DAC codec: small convs, replicate ---
    (r"(dac|encoder_dac)/.*", ()),
)

# the port's leaves held whole on every rank of the model axis where JAX's
# spec splits them over it (name regex -> reason)
MODEL_DIFFERENCES: Dict[str, str] = {
    r"^sampler\.tok_embeddings\.proj_[vgb]$":
        "the DAC-factored token projections ([K, token_dim, cd], 0.03% of "
        "the flagship) feed the token embedding every rank needs whole; a "
        "split token_dim would cost an all-gather of the embedding a step",
    r"^sampler\.cls_embeddings\.fc[12]\.":
        "the conditioning MLP (two small denses) feeds the conditioning "
        "sequence every rank needs whole; split, it would cost an "
        "all-gather of the conditioning per call",
    r"^encoder\.":
        "the encoder (ViT-B, 86M) stays whole on every model rank and is "
        "sharded over fsdp only: its fused sublayer kernels end in a "
        "residual epilogue that a split projection would need an "
        "all-reduce inside",
}
# the wqkv rows a model rank holds: JAX splits the [in, D + 2 kv_dim]
# kernel's output axis in contiguous blocks (at model=2, H=16 the first
# shard holds all of q and half of k) and lets XLA reshard; eager local
# attention needs rank r to hold the q, k and v rows of its own heads
HEAD_ALIGNED = r"^sampler\.layers\.\d+\.attention\.wqkv\.(weight|kernel_q|scale)$"
# the int8 weights' per-output scales: JAX's spec leaves them whole (no
# rule matches ``scale``); a column-split layer splits them with its rows
SPLIT_SCALES = r"^sampler\.(layers\.\d+\.(attention\.wqkv|feed_forward\.w[13])|lm_head)\.scale$"


def adapted_weight(name: str) -> str:
    """The base weight a LoRA leaf adapts
    (``lora_sampler.layers.0.attention.wqkv.lora_a`` ->
    ``sampler.layers.0.attention.wqkv.weight``)."""
    if not name.startswith("lora_sampler."):
        raise ValueError(f"{name}: not a LoRA leaf")
    layer = name[len("lora_sampler."):].rsplit(".", 1)[0]
    return f"sampler.{layer}.weight"


def spec_for(path: str, ndim: int) -> Spec:
    """The JAX package's spec of the parameter at ``path`` (``ndim`` axes,
    JAX's layout) as a tuple."""
    for pattern, axes in _RULES:
        if re.search(pattern, path):
            if not axes:
                return ()
            axes = tuple(axes)
            if len(axes) < ndim:
                axes = (None,) * (ndim - len(axes)) + axes
            elif len(axes) > ndim:
                axes = axes[-ndim:]
            return axes
    return ()  # replicate by default


_DENSE_LEAVES = ("weight", "kernel_q")


def jax_path(name: str, ndim: int) -> Tuple[str, Tuple[int, ...], int]:
    """``(path, perm, stacked)``: the JAX path of the port's parameter
    ``name`` (``ndim`` axes), ``perm[d]`` the JAX axis (after the stacked
    one) of the port's axis ``d``, and ``stacked`` 1 where JAX stacks the
    leaf on a leading layer axis (``layers``, ``blocks``)."""
    parts = name.split(".")
    stacked = 0
    if len(parts) > 2 and parts[1] in ("layers", "blocks") and parts[2].isdigit():
        del parts[2]
        stacked = 1
    leaf = parts[-1]
    perm = tuple(range(ndim))
    if leaf in _DENSE_LEAVES and ndim == 2:
        perm = (1, 0)  # [out, in] <- [in, out]
        parts[-1] = "kernel" if leaf == "weight" else leaf
    elif leaf == "weight" and ndim == 5:  # Conv3d [Cout, Cin, t, h, w]
        perm = (4, 3, 0, 1, 2)
        parts[-1] = "kernel"
    return "/".join(parts), perm, stacked


def port_spec(name: str, ndim: int) -> Spec:
    """JAX's spec of the port's parameter ``name``, in the port's layout."""
    path, perm, stacked = jax_path(name, ndim)
    spec = spec_for(path, ndim + stacked)
    if not spec:
        return ()
    spec = spec[stacked:]
    return tuple(spec[perm[d]] for d in range(ndim))


def param_specs(module: torch.nn.Module) -> Dict[str, Spec]:
    """``port_spec`` of every parameter and buffer of ``module`` (a
    ``VauraSystem``) by its name."""
    named = dict(module.named_parameters())
    named.update((k, v) for k, v in module.named_buffers()
                 if k.rsplit(".", 1)[-1] in ("kernel_q", "scale"))
    return {k: port_spec(k, v.ndim) for k, v in named.items()}


def model_dim(name: str, ndim: int) -> Optional[int]:
    """The axis of the port's leaf ``name`` that the ``model`` axis splits
    under ``shard_module`` (None: held whole), JAX's spec with
    ``MODEL_DIFFERENCES`` and ``SPLIT_SCALES`` applied."""
    if re.search(SPLIT_SCALES, name):
        return 0
    if any(re.search(p, name) for p in MODEL_DIFFERENCES):
        return None
    spec = port_spec(name, ndim)
    return spec.index("model") if "model" in spec else None


def fsdp_dim(name: str, ndim: int) -> int:
    """The axis FSDP2 shards the port's parameter ``name`` on: the one
    JAX's spec names ``fsdp``, else 0. A difference from JAX: FSDP2 shards
    every parameter of a module it wraps, so the leaves JAX keeps whole
    over fsdp (norms, biases, embeddings, the encoder's tokens) are
    sharded on dim 0."""
    spec = port_spec(name, ndim)
    return spec.index("fsdp") if "fsdp" in spec else 0


# --------------------------------------------------------------------------
def _head_rows(cfg, size: int, rank: int) -> torch.Tensor:
    """The rows of the fused ``wqkv`` weight ``[D + 2 kv_dim, in]`` that
    model rank ``rank`` of ``size`` holds: the q, then k, then v rows of
    its own heads."""
    H, Hkv, hd = cfg.nhead, cfg.n_kv_heads, cfg.head_dim
    if H % size or Hkv % size:
        raise ValueError(f"model={size} must divide the sampler's heads "
                         f"(nhead {H}, n_kv_heads {Hkv})")
    h, hk = H // size, Hkv // size
    q = torch.arange(rank * h * hd, (rank + 1) * h * hd)
    k = H * hd + torch.arange(rank * hk * hd, (rank + 1) * hk * hd)
    v = (H + Hkv) * hd + torch.arange(rank * hk * hd, (rank + 1) * hk * hd)
    return torch.cat([q, k, v])


def tp_slice(name: str, full: torch.Tensor, cfg, size: int, rank: int
             ) -> torch.Tensor:
    """Model rank ``rank``'s part of the port's whole leaf ``full``."""
    if size == 1:
        return full
    if re.search(HEAD_ALIGNED, name):
        return full.index_select(0, _head_rows(cfg, size, rank).to(full.device))
    dim = model_dim(name, full.ndim)
    if dim is None:
        return full
    if full.shape[dim] % size:
        raise ValueError(f"{name}: axis {dim} ({full.shape[dim]}) not "
                         f"divisible by model={size}")
    return full.chunk(size, dim)[rank]


def tp_join(name: str, parts, cfg) -> torch.Tensor:
    """The whole leaf from every model rank's part (``tp_slice``'s
    inverse)."""
    size = len(parts)
    if size == 1:
        return parts[0]
    if re.search(HEAD_ALIGNED, name):
        full = parts[0].new_empty((sum(p.shape[0] for p in parts),)
                                  + tuple(parts[0].shape[1:]))
        for r, p in enumerate(parts):
            full.index_copy_(0, _head_rows(cfg, size, r).to(p.device), p)
        return full
    dim = model_dim(name, parts[0].ndim)
    return parts[0] if dim is None else torch.cat(parts, dim)


class MeshPlacement:
    """How ``shard_module`` placed a system: the mesh, this rank's groups
    (``model``, and the flattened ``(data, fsdp)`` batch group), and the
    conversions between a leaf's whole value and this rank's local one
    (``full`` gathers, ``local`` slices), which checkpoints use so that a
    file saved under any mesh is the one-process file."""

    def __init__(self, mesh, sampler_config, shards: bool = True):
        from vaura_tpu_torch.parallel.mesh import batch_index

        self.mesh = mesh
        self.cfg = sampler_config
        # whether FSDP2 shards the modules over (data, fsdp); a placement
        # for generation alone at fsdp 1 holds them whole (shard_module)
        self.shards = shards
        self.model_size = mesh.size(2)
        self.model_rank = mesh.get_local_rank("model")
        self.model_group = mesh.get_group("model")
        self.batch_rank, self.batch_size = batch_index(mesh)
        # one group a model coordinate over the ranks that hold different
        # rows: rank (d * F + f) * M + m
        M, world = self.model_size, mesh.size()
        self.batch_group, _ = dist.new_subgroups_by_enumeration(
            [list(range(m, world, M)) for m in range(M)])

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks that hold the batch's other rows
        (no gradient)."""
        x = x.detach().clone()
        dist.all_reduce(x, group=self.batch_group)
        return x

    def gather_rows(self, x: torch.Tensor, to: str = "all"):
        """The whole batch from every rank's rows of ``x`` (axis 0): on
        every rank (``to="all"``), or on rank 0 only (``"main"``; the other
        ranks get None)."""
        x = x.contiguous()
        if to == "all":
            parts = [torch.empty_like(x) for _ in range(self.batch_size)]
            dist.all_gather(parts, x, group=self.batch_group)
            return torch.cat(parts)
        if to != "main":
            raise ValueError(f"gather to {to!r}: 'all' or 'main'")
        if self.model_rank != 0:
            return None
        main = dist.get_rank() == 0
        parts = [torch.empty_like(x) for _ in range(self.batch_size)] \
            if main else None
        dist.gather(x, parts, dst=0, group=self.batch_group)
        return torch.cat(parts) if main else None

    def gather_list(self, rows: list) -> list:
        """The whole batch of a list of one entry a row (a batch's file
        names), on every rank, in ``gather_rows``' order."""
        parts = [None] * self.batch_size
        dist.all_gather_object(parts, rows, group=self.batch_group)
        return [x for part in parts for x in part]

    def model_part(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This model rank's part of the whole leaf ``full`` (``tp_slice``;
        a LoRA delta takes its base weight's cut)."""
        return tp_slice(name, full, self.cfg, self.model_size,
                        self.model_rank)

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole value of the leaf ``name`` from this rank's ``t`` (a
        collective: every rank calls it for the same names in the same
        order)."""
        from torch.distributed.tensor import DTensor

        t = t.detach()
        if isinstance(t, DTensor):
            t = t.full_tensor()
        if self.model_size == 1 or model_dim(name, t.ndim) is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.model_size)]
        dist.all_gather(parts, t.contiguous(), group=self.model_group)
        return tp_join(name, parts, self.cfg)

    def local(self, name: str, full: torch.Tensor, like: torch.Tensor
              ) -> torch.Tensor:
        """This rank's part of the whole leaf ``full``, shaped as ``like``
        (its local tensor, for an FSDP2 parameter)."""
        from torch.distributed.tensor import DTensor

        t = self.model_part(name, full)
        if isinstance(like, DTensor):
            for mdim, placement in enumerate(like.placements):
                if placement.is_shard():
                    n = like.device_mesh.size(mdim)
                    i = like.device_mesh.get_local_rank(mdim)
                    pieces = t.chunk(n, placement.dim)
                    t = pieces[i] if i < len(pieces) else t.narrow(
                        placement.dim, 0, 0)
        return t

    @torch.no_grad()
    def load_full_(self, dst: Dict[str, torch.Tensor],
                   src: Dict[str, torch.Tensor], what: str) -> None:
        """Copy whole leaves ``src`` into this rank's parts ``dst``, in
        place (the names must match; each whole leaf's shape must be the
        system's)."""
        missing, unexpected = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
        if missing or unexpected:
            raise ValueError(f"{what}: missing {missing[:5]}, unexpected "
                             f"{unexpected[:5]}")
        for k, t in dst.items():
            part = self.local(k, src[k], t)
            view = t.to_local() if hasattr(t, "to_local") else t
            if tuple(part.shape) != tuple(view.shape):
                raise ValueError(f"{what}.{k}: shape {tuple(src[k].shape)} "
                                 "does not fit this system")
            view.copy_(part)

    def global_norm(self, names, grads, replicated=frozenset()
                    ) -> torch.Tensor:
        """The L2 norm over every whole leaf of ``grads`` (this rank's local
        shards, by ``names``): the squares of the shards summed over fsdp,
        then those of the leaves the model axis splits over model (each
        leaf counted once; ranks that differ in ``data`` hold the same
        shards). The leaves named in ``replicated`` (LoRA adapters) are
        whole and alike on every rank, and are counted once as they are."""
        zero = torch.zeros((), device=grads[0].device)
        split, whole, rep = zero, zero, zero
        for n, g in zip(names, grads):
            q = g.float().pow(2).sum()
            if n in replicated:
                rep = rep + q
            elif model_dim(n, g.ndim) is not None:
                split = split + q
            else:
                whole = whole + q
        both = torch.stack([split, whole])
        dist.all_reduce(both, group=self.mesh.get_group("fsdp"))
        split, whole = both[0:1].clone(), both[1]
        if self.model_size > 1:
            dist.all_reduce(split, group=self.model_group)
        return (split[0] + whole + rep).sqrt()

    def sum_replicated_grads(self, names, grads) -> None:
        """Sum, in place, the gradients ``grads`` of the LoRA leaves
        ``names``, which every rank holds whole outside FSDP2 and whose
        gradient each rank has from its rows of the batch and, over
        ``model``, through its cut of the delta: over the batch's shards
        (plain sums: each rank's loss is its rows' share of the global
        loss), then over ``model`` for an adapter whose base weight the
        model axis splits (one held whole there has the same gradient on
        every model rank). One flat all-reduce a group."""
        if self.batch_size > 1:
            _sum_flat(grads, self.batch_group)
        if self.model_size > 1:
            _sum_flat([g for n, g in zip(names, grads)
                       if model_dim(adapted_weight(n), 2) is not None],
                      self.model_group)

    def full_tree(self, tree):
        """``full`` of every tensor of a ``TrainState.state_dict()``-like
        tree whose tensor leaves sit under their parameter names."""
        def walk(node, name=None):
            if isinstance(node, dict):
                return {k: walk(v, k if isinstance(v, torch.Tensor) else name)
                        for k, v in node.items()}
            if isinstance(node, torch.Tensor):
                return self.full(name, node)
            return node
        return walk(tree)


def _sum_flat(tensors, group) -> None:
    """All-reduce (sum) ``tensors`` over ``group`` in place, as one flat
    buffer."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def _fully_shard(module, placement: MeshPlacement, names: Dict[int, str],
                 methods=()):
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    from torch.distributed.tensor import Shard

    def shard_dim(p):
        return Shard(fsdp_dim(names[id(p)], p.ndim))

    fully_shard(module, mesh=placement.mesh["data", "fsdp"],
                shard_placement_fn=shard_dim)
    # a sum over the batch's shards, not a mean: each rank's loss is its
    # rows' share of the global loss (ops/losses.py), so the summed
    # gradients are the global batch's
    module.set_gradient_divide_factor(1.0)
    # plain sums on the wire (gloo has no pre-multiplied sum)
    module.set_force_sum_reduction_for_comms(True)
    for m in methods:
        register_fsdp_forward_method(module, m)


@torch.no_grad()
def _split_over_model(sampler, placement: MeshPlacement) -> None:
    """This model rank's rows or columns of the sampler's dense layers
    (``tp_slice``), in place; its attention layers' head counts become the
    local ones, and every layer gets the model axis's collectives."""
    from vaura_tpu_torch.models.sampler import Attention, FeedForward, PDense
    from vaura_tpu_torch.parallel.tensor_parallel import ModelParallel

    M, r = placement.model_size, placement.model_rank
    tp = ModelParallel(placement.model_group, M, r)
    for pre, mod in sampler.named_modules():
        if isinstance(mod, PDense):
            for leaf in ("weight", "kernel_q", "scale"):
                t = getattr(mod, leaf, None)
                if t is None:
                    continue
                name = f"sampler.{pre}.{leaf}"
                part = tp_slice(name, t.data, placement.cfg, M, r).contiguous()
                if isinstance(t, torch.nn.Parameter):
                    setattr(mod, leaf, torch.nn.Parameter(
                        part, requires_grad=t.requires_grad))
                else:
                    setattr(mod, leaf, part)
        if isinstance(mod, Attention):
            mod.n_heads //= M
            mod.n_kv //= M
        if isinstance(mod, (Attention, FeedForward)):
            mod.tp = tp
    sampler.tp = tp


def place_modules(placement: MeshPlacement, modules) -> None:
    """Place a system's top modules (``{"sampler": ..., "encoder": ...,
    "bridge": ...}``, each whole, the same on every rank) on the mesh, in
    place: the sampler's dense layers split over ``model``, then, when the
    placement shards (``placement.shards``), FSDP2 over ``(data, fsdp)`` on
    the sampler's blocks, the sampler, the encoder's blocks, the encoder and
    the bridge. Other modules (LoRA adapters) stay whole on every rank. A
    hot reload places its new modules with the placement of the served
    system."""
    sampler = modules.get("sampler")
    if sampler is not None and placement.model_size > 1:
        _split_over_model(sampler, placement)
    if not placement.shards:
        return
    names = {id(p): f"{top}.{n}" for top, m in modules.items()
             if m is not None for n, p in m.named_parameters()}
    if sampler is not None:
        for block in sampler.layers:
            _fully_shard(block, placement, names)
        _fully_shard(sampler, placement, names)
    encoder = modules.get("encoder")
    if encoder is not None:
        for block in encoder.blocks:
            _fully_shard(block, placement, names, ("forward_unfused",))
        _fully_shard(encoder, placement, names)
    if modules.get("bridge") is not None:
        _fully_shard(modules["bridge"], placement, names)


@torch.no_grad()
def shard_module(system, mesh, *, train: bool = True) -> MeshPlacement:
    """Place ``system`` (a ``VauraSystem`` holding its whole weights, the
    same on every rank: seeded, or loaded and converted) on ``mesh``, in
    place (``place_modules``): the sampler's dense layers take this model
    rank's rows or columns (``tp_slice``; the head counts of its attention
    become the local ones), then FSDP2 shards the sampler's blocks, the
    sampler, the encoder's blocks, the encoder and the bridge over ``(data,
    fsdp)``. Sets and returns ``system.placement``.

    ``train=False`` places a system that only generates: at ``fsdp`` 1 no
    module is sharded (every rank holds the whole weights, or over
    ``model`` its part, as JAX's ``param_shardings`` leaves every leaf whole
    at ``fsdp`` = ``model`` = 1). LoRA adapters stay whole on every rank,
    as JAX's specs leave them, and merge into this rank's part of each
    weight (``VauraSystem.lora_merged``): once a generation call into the
    gathered weights, or in training at each use into the block's
    all-gathered weight. Their gradients are summed over the mesh by
    ``MeshPlacement.sum_replicated_grads``."""
    if system.sampler_config.deepseek:
        raise NotImplementedError(
            "the DeepSeek-V3 block on a mesh: its experts and latent "
            "attention have no tensor-parallel or FSDP2 placement")
    placement = MeshPlacement(mesh, system.sampler_config,
                              shards=train or mesh.size(1) > 1)
    place_modules(placement, {"sampler": system.sampler,
                              "encoder": system.encoder,
                              "bridge": system.bridge})
    system.placement = placement
    return placement
