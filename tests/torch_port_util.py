"""Shared helpers of the ``test_torch_*`` parity tests: tiny configurations
of both packages and parameter trees carried from JAX to the port.

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
    names = {f.name for f in dataclasses.fields(tcls)} - {"dtype"}
    kw = {n: getattr(jcfg, n) for n in names if hasattr(jcfg, n)}
    kw.update(extra)
    return tcls(dtype=torch.float32, **kw)


def port_sampler_config(jcfg=J_SAMPLER) -> TSamplerConfig:
    return _port_config(jcfg, TSamplerConfig)


def port_dac_config(jcfg=J_DAC) -> TDacConfig:
    return _port_config(jcfg, TDacConfig)


def port_encoder_config(jcfg=J_ENC) -> TEncConfig:
    return _port_config(jcfg, TEncConfig)


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


def init_jax_system(seed: int = 0):
    from vaura_tpu.models.vaura import VauraSystem

    sysm = VauraSystem(
        sampler_config=J_SAMPLER, dac_config=J_DAC,
        encoder_config=J_ENC,
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
            jnp.zeros((1, J_SAMPLER.num_codebooks, 16), jnp.int32),
            jnp.zeros((1, 8, J_SAMPLER.cond_in_dim)), False))(r_sam)["params"],
        "encoder": jax.jit(lambda r: sysm.encoder.init(
            r, jnp.zeros((1, 1, 3, 4, 16, 16))))(r_enc)["params"],
    }
    tree = np_tree(params)
    tree["sampler"] = randomize_sampler_heads(tree["sampler"], seed + 100)
    return sysm, tree
