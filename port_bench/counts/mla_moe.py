"""Operations and bytes of a DeepSeek-V3 sampler's decode (latent attention,
routed experts) from shapes, counted as ``counts/__init__.py`` counts: 2
FLOPs a multiply-add, each input byte read once and each output written
once, elementwise work (norms, activations, the router's sigmoid and top-k)
not counted as FLOPs. A configuration is the ``sampler`` block of
``configs/vaura_moonlight16b.json``.

``rows`` is the decode's batch rows (both CFG streams), ``steps`` its
positions: position ``p`` (0 .. steps - 1) attends to the ``p`` cached
rows and its own.
"""

from __future__ import annotations

from port_bench.counts import sampler_widths


def widths(s: dict) -> dict:
    w = sampler_widths(s)
    w.update(R=s["kv_lora_rank"], dn=s["qk_nope_head_dim"],
             dr=s["qk_rope_head_dim"], dv=s["v_head_dim"],
             E=s["n_routed_experts"], k=s["num_experts_per_tok"],
             I=s["moe_intermediate_size"],
             shared=s["n_shared_experts"] * s["moe_intermediate_size"],
             dense=s["intermediate_size"], first=s["first_k_dense_replace"])
    w["moe_layers"] = w["L"] - w["first"]
    return w


def attention_params(s: dict) -> int:
    """A layer's attention weights a position runs through: ``wq``,
    ``wkv_a``, ``wkv_b`` (in the absorbed decode its key half moves the
    query into the latent space and its value half the output out of it:
    the same multiply-adds) and ``wo``."""
    w = widths(s)
    d, H = w["d"], w["H"]
    return (d * H * (w["dn"] + w["dr"]) + d * (w["R"] + w["dr"])
            + w["R"] * H * (w["dn"] + w["dv"]) + H * w["dv"] * d)


def active_params(s: dict) -> int:
    """Weights of the products one position runs through: every layer's
    attention, the dense layers' SwiGLU, in each routed layer the router,
    the ``k`` chosen experts and the shared ones, the LM head and the
    token projections."""
    w = widths(s)
    d = w["d"]
    moe = d * w["E"] + 3 * d * (w["k"] * w["I"] + w["shared"])
    return (w["L"] * attention_params(s) + w["first"] * 3 * d * w["dense"]
            + w["moe_layers"] * moe + d * w["K"] * w["V"]
            + w["K"] * w["cd"] * w["token_dim"])


def mla_decode_attention_flops(s: dict, rows: int, steps: int) -> float:
    """The latent attention's two products over a whole decode, every layer:
    at position ``p`` each head scores ``p + 1`` rows of ``R + dr`` values
    and averages ``p + 1`` latent rows of ``R``."""
    w = widths(s)
    keys = steps * (steps + 1) / 2
    return w["L"] * rows * w["H"] * 2 * (2 * w["R"] + w["dr"]) * keys


def mla_decode_attention_bytes(s: dict, rows: int, steps: int,
                               cache_bytes: int = 2) -> float:
    """The latent attention kernel's bytes over a whole decode, every layer:
    at position ``p`` each row reads its ``p`` cached ``[c; k_pe]`` rows
    (``cache_bytes`` a value), its heads' bf16 query ``[H, R + dr]`` and its
    new row, and writes the float32 output ``[H, R]``."""
    w = widths(s)
    W, H = w["R"] + w["dr"], w["H"]
    cached = steps * (steps - 1) / 2
    per_layer = rows * (cached * W * cache_bytes
                        + steps * (H * W * 2 + W * 2 + H * w["R"] * 4))
    return w["L"] * per_layer


def sampler_decode_flops(s: dict, rows: int, steps: int) -> float:
    """A decode over ``steps`` positions for ``rows`` rows: the active
    weights' products and the latent attention."""
    return (2 * active_params(s) * rows * steps
            + mla_decode_attention_flops(s, rows, steps))


def expert_flops(s: dict, rows: int, steps: int) -> float:
    """The routed experts' three products over a whole decode: each row's
    ``k`` chosen experts, in every routed layer."""
    w = widths(s)
    return w["moe_layers"] * steps * rows * w["k"] * 2 * 3 * w["d"] * w["I"]


def expert_bytes(s: dict, rows: int, steps: int) -> float:
    """The routed experts' products' bytes over a whole decode: every
    expert's bf16 weights once a step and routed layer (at ~96 rows an
    expert, every expert is chosen), and the routed rows in and out of each
    product (``w1`` and ``w3`` read ``[rows * k, d]`` and write ``[rows *
    k, I]``, ``w2`` the other way), bf16."""
    w = widths(s)
    d, I = w["d"], w["I"]
    weights = w["E"] * 3 * d * I * 2
    routed = rows * w["k"] * 3 * (d + I) * 2
    return w["moe_layers"] * steps * (weights + routed)
