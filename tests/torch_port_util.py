"""Shared helpers of the ``test_torch_*`` parity tests: tiny configurations
of both packages, parameter trees carried from JAX to the port, and a plain
decode loop that the port's one decode loop is held to.

JAX and PyTorch meet only through numpy arrays; every input is made with
numpy from a seed and handed to both."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vaura_tpu.models.dac.model import DacConfig as JDacConfig
from vaura_tpu.models.motionformer import MotionFormerConfig as JEncConfig
from vaura_tpu.models.sampler import SamplerConfig as JSamplerConfig
from vaura_tpu_torch.models.dac.model import DacConfig as TDacConfig
from vaura_tpu_torch.models.motionformer import MotionFormerConfig as TEncConfig
from vaura_tpu_torch.models.sampler import SamplerConfig as TSamplerConfig

CPU = "cpu"

# the tiny system of tests/test_system.py, float32 end to end
J_SAMPLER = JSamplerConfig(
    num_layers=2, d_model=48, d_codebook=16, num_codebooks=3, nhead=4,
    block_size_audio=64, block_size_video=16, dropout=0.0,
    class_dropout_prob=0.1, cond_in_dim=24, cond_token_num=8, codebook_dim=4,
    dtype=jnp.float32,
)
J_DAC = JDacConfig(
    encoder_dim=8, encoder_rates=(2, 4), decoder_dim=32, decoder_rates=(4, 2),
    latent_dim=32, n_codebooks=3, codebook_size=16, codebook_dim=4,
)
J_ENC = JEncConfig(
    img_size=16, patch_size=8, embed_dim=24, depth=2, num_heads=2,
    temporal_resolution=2, z_block_size=2, drop_path_rate=0.0,
    dtype=jnp.float32, fused_encoder_block=False,
)


def _port_config(jcfg, tcls, **extra):
    """The port's config with every field the two share, float32."""
    names = {f.name for f in dataclasses.fields(tcls)} - {"dtype", "param_dtype"}
    kw = {n: getattr(jcfg, n) for n in names if hasattr(jcfg, n)}
    kw.update(extra)
    return tcls(dtype=torch.float32, **kw)


def port_sampler_config(jcfg=J_SAMPLER, **extra) -> TSamplerConfig:
    return _port_config(jcfg, TSamplerConfig, **extra)


def port_dac_config(jcfg=J_DAC) -> TDacConfig:
    return _port_config(jcfg, TDacConfig)


def port_encoder_config(jcfg=J_ENC, **extra) -> TEncConfig:
    """The JAX configs here turn the Pallas paths off to stay fast on the
    CPU (``fused_encoder_block=False``: its einsum path computes the same
    function); the port keeps its own default: fused sublayers when not
    training. When training it always takes the grouped-attention op."""
    extra = {"fused_encoder_block": None, **extra}
    return _port_config(jcfg, TEncConfig, **extra)


def np_tree(tree):
    """A JAX parameter tree as nested dicts of float32 numpy arrays."""
    if hasattr(tree, "items"):
        return {k: np_tree(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def randomize_sampler_heads(sampler_tree, seed: int):
    """Fill the zero-initialised ``lm_head`` (every logit would be 0 and a
    greedy test would prove nothing) and ``empty_video_emb`` with seeded
    random values."""
    rng = np.random.default_rng(seed)
    out = dict(sampler_tree)
    k = out["lm_head"]["kernel"]
    out["lm_head"] = {"kernel": (rng.standard_normal(k.shape)
                                 / np.sqrt(k.shape[0])).astype(np.float32)}
    e = out["empty_video_emb"]
    out["empty_video_emb"] = rng.standard_normal(e.shape).astype(np.float32)
    return out


def init_jax_system(seed: int = 0, sampler_config=J_SAMPLER,
                    encoder_config=J_ENC, **system_kw):
    from vaura_tpu.models.vaura import VauraSystem

    sysm = VauraSystem(
        sampler_config=sampler_config, dac_config=J_DAC,
        encoder_config=encoder_config, **system_kw,
    )
    # each subtree on its own (init_params would also trace the unused DAC
    # encoder), jitted
    r_dac, r_enc, r_sam = jax.random.split(jax.random.PRNGKey(seed), 3)
    codes = jnp.zeros((1, J_DAC.n_codebooks, 2), jnp.int32)
    params = {
        "dac": jax.jit(lambda r: sysm.dac.init(
            r, codes, method=sysm.dac.decode))(r_dac)["params"],
        "sampler": jax.jit(lambda r: sysm.sampler.init(
            {"params": r, "dropout": r, "cfg_dropout": r},
            jnp.zeros((1, sampler_config.num_codebooks, 16), jnp.int32),
            jnp.zeros((1, 8, sampler_config.cond_in_dim)), False))(r_sam)["params"],
        "encoder": jax.jit(lambda r: sysm.encoder.init(
            r, jnp.zeros((1, 1, 3, 4, 16, 16))))(r_enc)["params"],
    }
    tree = np_tree(params)
    tree["sampler"] = randomize_sampler_heads(tree["sampler"], seed + 100)
    return sysm, tree


# --------------------------------------------------------------------------
# training: every stochastic rate at 0 (JAX's dropout streams cannot be
# reproduced), the encoder through the Pallas grouped attention in interpret
# mode, as tests/test_divided_attention_kernel.py runs it
J_SAMPLER_TRAIN = dataclasses.replace(J_SAMPLER, class_dropout_prob=0.0)
J_ENC_TRAIN = dataclasses.replace(J_ENC, fused_divided_attention=True)
AUDIO_SAMPLES = 10 * J_DAC.hop_length  # 10 codec frames


def init_jax_train_system(seed: int = 0, freeze_feature_extractor=False):
    """``init_jax_system`` for the training tests: the tiny training
    configuration, the DAC encoder initialised too, Snake alphas and the
    zero-initialised biases and ``temp_embed`` filled with seeded values so
    that no gradient is trivially zero. Returns ``(jax system, numpy
    parameter tree)``."""
    sysm, tree = init_jax_system(
        seed, J_SAMPLER_TRAIN, J_ENC_TRAIN,
        freeze_feature_extractor=freeze_feature_extractor)
    wav = jnp.zeros((1, 1, J_DAC.hop_length * 4))
    tree["dac"] = np_tree(jax.jit(lambda r: sysm.dac.init(r, wav))(
        jax.random.PRNGKey(seed + 7))["params"])
    rng = np.random.default_rng(seed + 200)

    def fill(node, path=()):
        for k, v in node.items():
            if hasattr(v, "items"):
                fill(v, path + (k,))
            elif k == "alpha":
                node[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            elif k in ("bias", "temp_embed") or k.endswith("_b"):
                node[k] = (0.05 * rng.standard_normal(v.shape)).astype(np.float32)

    fill(tree)
    return sysm, tree


def port_train_system(tree, freeze_feature_extractor=False, **sampler_extra):
    """The port's system of the tiny training configuration on the CPU,
    loaded with ``tree``."""
    from vaura_tpu_torch.convert import from_jax_params
    from vaura_tpu_torch.models.vaura import VauraSystem as TSystem

    tsys = TSystem(port_sampler_config(J_SAMPLER_TRAIN, **sampler_extra),
                   port_dac_config(), port_encoder_config(J_ENC_TRAIN),
                   freeze_feature_extractor=freeze_feature_extractor,
                   device=CPU)
    tsys.load_state_dicts(from_jax_params(tree))
    return tsys


def train_batch(seed: int = 0, batch: int = 2):
    """Seeded numpy ``{"frames" [B, 2, 3, 4, 16, 16], "audio" [B, 1, T]}``."""
    rng = np.random.default_rng(seed)
    return {
        "frames": rng.standard_normal((batch, 2, 3, 4, 16, 16)).astype(np.float32),
        "audio": (0.5 * rng.standard_normal((batch, 1, AUDIO_SAMPLES))
                  ).astype(np.float32),
    }


def jax_train_state(jsys, tree, learning_rate, **opt_kw):
    """``(TrainState, frozen subtrees)`` of the JAX package over ``tree``."""
    from vaura_tpu.train.state import TrainState, make_optimizer
    from vaura_tpu.train.steps import split_params

    params = jax.tree_util.tree_map(jnp.asarray, tree)
    trainable, frozen = split_params(jsys, params)
    tx = make_optimizer(learning_rate, **opt_kw)
    return TrainState.create(trainable, tx), frozen


def flat_state_dicts(state_dicts):
    """``{"sampler": {...}, ...}`` -> ``{"sampler.<name>": tensor}``, the
    names of ``VauraSystem.named_parameters()``."""
    return {f"{top}.{k}": v for top, sd in state_dicts.items()
            for k, v in sd.items()}


def assert_same(a, b, path="batch"):
    """Equal nested dicts of numpy arrays (same dtype) and plain values."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def reference_decode_loop(system, cache, gen_seq, cond_seq, valid_mask,
                          generator, steps, *, use_sampling, temp, top_k,
                          top_p, cfg_scale):
    """``gen_seq`` and ``cache`` filled in place over ``steps`` with host
    ``int`` positions and plain slicing, the oracle of the bookkeeping of
    ``VauraSystem._device_loop`` (``index_select`` reads, ``index_copy_``
    writes, the noise buffer): each step is ``Sampler.decode_step`` at
    ``s - 1``, the CFG blend, ``sample_tokens`` drawing its own noise from
    ``generator``, the special token where ``valid_mask [K, S]`` is false,
    and the tokens already in ``gen_seq`` (a prompt) kept where they are
    not UNKNOWN. Returns ``gen_seq``."""
    from vaura_tpu_torch.models.vaura import UNKNOWN_TOKEN
    from vaura_tpu_torch.ops.sampling import cfg_blend, sample_tokens

    valid = torch.as_tensor(valid_mask)
    B = gen_seq.shape[0]
    for s in steps:
        tok = gen_seq[:, :, s - 1:s]
        if cfg_scale > 1.0:
            tok = tok.repeat(2, 1, 1)
        logits = system.sampler.decode_step(tok, cond_seq[:, s - 1:s], cache,
                                            s - 1)
        if cfg_scale > 1.0:
            logits = cfg_blend(logits[:B], logits[B:], cfg_scale)
        new = sample_tokens(logits, generator=generator,
                            use_sampling=use_sampling, temp=temp, top_k=top_k,
                            top_p=top_p)
        new = torch.where(valid[:, s][None], new, system.special_token_id)
        cur = gen_seq[:, :, s]
        gen_seq[:, :, s] = torch.where(cur == UNKNOWN_TOKEN, new, cur)
    return gen_seq
