"""The composite V-AURA system.

Generation: frames -> MotionFormer features -> bridge -> conditioning
sequence (with the CFG null stream) -> delayed codebook pattern -> KV-cache
decode loop -> pattern revert -> DAC waveform.

Training (``train_forward``): audio -> DAC codes (frozen, no graph) ->
delayed pattern with the implicit BOS shift -> MotionFormer (``train=True``:
the unfused, differentiable blocks) -> bridge -> teacher-forced sampler ->
logits reverted to the codes' timesteps (NaN at the slots no step
predicts) -> masked per-codebook cross entropy.

Counterpart of ``vaura_tpu/models/vaura.py`` (``visual_features``,
``train_forward``, ``encode_audio``, ``load_dac_embeddings_into_sampler``,
``prepare_generation``, ``build_cond_seq_for_generation``, the generation
step, ``generate_tokens``, ``generate``, ``decode_audio``). JAX runs the
decode loop as a compiled ``lax.scan``; here it is a Python loop over steps
whose position is a host integer, so nothing waits for the device inside
it. The loop keeps ONE preallocated cache ``[L, 2B, S, H_kv, hd]``: the
decode-attention kernel reads only positions ``< pos``, which is what
``decode_buckets`` achieved with chunk buffers on the TPU.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vaura_tpu_torch.models.bridges import IdentityBridge
from vaura_tpu_torch.models.dac.model import Dac, DacConfig
from vaura_tpu_torch.models.motionformer import MotionFormer, MotionFormerConfig
from vaura_tpu_torch.models.sampler import (
    Sampler,
    SamplerConfig,
    default_tokens_per_frame,
)
from vaura_tpu_torch.ops.losses import masked_codebook_cross_entropy
from vaura_tpu_torch.ops.patterns import DelayedPatternProvider
from vaura_tpu_torch.ops.sampling import cfg_blend, sample_tokens
from vaura_tpu_torch.utils import DeviceLike, StageClock, resolve_device

UNKNOWN_TOKEN = -1


def _largest_divisor(n: int, cap: int) -> int:
    return next(c for c in range(min(cap, n), 0, -1) if n % c == 0)


class VauraSystem(nn.Module):
    """Sampler, codec, visual encoder, bridge and codebook pattern on one
    device. Weights come from ``load_state_dicts`` (for example the output
    of ``vaura_tpu_torch.convert.from_jax_params``) or a seeded
    initialisation."""

    def __init__(
        self,
        sampler_config: SamplerConfig,
        dac_config: DacConfig,
        encoder_config: Optional[MotionFormerConfig] = None,
        pattern_provider: Optional[DelayedPatternProvider] = None,
        bridge: Optional[nn.Module] = None,
        use_visual_conditioning: bool = True,
        freeze_feature_extractor: bool = False,
        device: DeviceLike = None,
    ):
        super().__init__()
        self.device = resolve_device(device)
        self.freeze_feature_extractor = freeze_feature_extractor
        self.sampler_config = sampler_config
        self.sampler = Sampler(sampler_config, self.device)
        self.dac = Dac(dac_config, self.device)
        self.encoder = (
            MotionFormer(encoder_config, self.device)
            if use_visual_conditioning and encoder_config is not None else None
        )
        if isinstance(bridge, IdentityBridge):
            bridge = None
        self.bridge = None if bridge is None else bridge.to(self.device)
        self.pattern_provider = pattern_provider or DelayedPatternProvider(
            sampler_config.num_codebooks)
        self.pattern_name = type(self.pattern_provider).__name__

    @property
    def num_codebooks(self) -> int:
        return self.sampler_config.num_codebooks

    @property
    def special_token_id(self) -> int:
        return self.sampler_config.special_token_id

    def load_state_dicts(self, state_dicts: Dict[str, Dict[str, torch.Tensor]]):
        """Load ``{"sampler", "dac", "encoder", "bridge"}`` state dicts (the
        keys present) into the matching submodules."""
        for name, sd in state_dicts.items():
            module = getattr(self, name)
            if module is None:
                raise ValueError(f"state dict for {name!r}, which this system "
                                 "does not have")
            module.load_state_dict(sd)
        return self

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def load_dac_embeddings_into_sampler(self) -> bool:
        """Initialise the sampler's factored token embeddings from the DAC
        quantizer: each codebook table (plus a seeded random special row)
        and the folded out-projection as ``v`` with gain ``||v||``. Returns
        False, and changes nothing, when the geometries differ."""
        cfg, dcfg = self.sampler_config, self.dac.cfg
        K, V, cd = cfg.num_codebooks, cfg.d_codebook, cfg.codebook_dim
        if (dcfg.codebook_dim != cd or dcfg.codebook_size != V
                or dcfg.n_codebooks < K
                or dcfg.resolved_latent_dim != cfg.token_dim):
            logging.getLogger(__name__).warning(
                "sampler embedding geometry (%d x %d -> %d) does not match "
                "the DAC quantizer (%d x %d -> %d); keeping the embeddings",
                V, cd, cfg.token_dim, dcfg.codebook_size, dcfg.codebook_dim,
                dcfg.resolved_latent_dim)
            return False
        q, tok = self.dac.quantizer, self.sampler.tok_embeddings
        special = np.random.default_rng(0).standard_normal(
            (K, 1, cd)).astype(np.float32) * 0.02
        emb = torch.cat([q.codebooks[:K].float(),
                         torch.as_tensor(special, device=self.device)], dim=1)
        tok.emb.copy_(emb.reshape(K * (V + 1), cd))
        W = q.out_proj_w[:K].transpose(1, 2)  # [K, D, cd]
        tok.proj_v.copy_(W)
        tok.proj_g.copy_(W.norm(dim=-1, keepdim=True) + 1e-12)
        tok.proj_b.copy_(q.out_proj_b[:K])
        return True

    # ------------------------------------------------------------------ #
    def visual_features(self, frames: torch.Tensor, *, train: bool = False,
                        generator: Optional[torch.Generator] = None,
                        chunk_size: Optional[int] = None) -> torch.Tensor:
        """Frames ``[B, S, C, T, H, W]`` -> features ``[B, S*t, D]`` through
        the encoder and the bridge. ``train`` runs the encoder's
        differentiable blocks with dropout and stochastic depth drawn from
        ``generator``. With ``freeze_feature_extractor`` the encoder records
        no graph (the features are a constant to what follows).
        ``chunk_size`` runs the encoder over sequential batch slices (the
        largest divisor of B not above it; inference only). Without an
        encoder, ``frames`` is taken as ``[B, Tv, D]`` features."""
        if train and chunk_size:
            raise ValueError("chunk_size is for inference: a training step "
                             "runs the encoder over the whole batch")
        if self.encoder is None:
            if frames.ndim != 3:
                raise ValueError("no visual encoder configured: pass "
                                 "[B, Tv, D] features")
            feats = frames.to(self.device)
        else:
            frames = frames.to(self.device)
            B = frames.shape[0]
            ctx = (torch.no_grad() if self.freeze_feature_extractor
                   else contextlib.nullcontext())
            with ctx:
                if chunk_size and B > chunk_size:
                    c = _largest_divisor(B, chunk_size)
                    feats = torch.cat([self.encoder(frames[i:i + c])
                                       for i in range(0, B, c)])
                else:
                    feats = self.encoder(frames, train, generator)
            B, S, t, D = feats.shape
            feats = feats.reshape(B, S * t, D)
        if self.bridge is not None:
            feats = self.bridge(feats)
        return feats

    # ------------------------------------------------------------------ #
    def encode_audio(self, audio: torch.Tensor) -> torch.Tensor:
        """Waveform ``[B, 1, T]`` -> codes ``[B, K, T / hop]`` (no graph)."""
        return self.dac.encode(audio.to(self.device))

    def train_forward(
        self,
        frames: Optional[torch.Tensor],
        audio: Optional[torch.Tensor],          # [B, 1, Ta_samples]
        generator: Optional[torch.Generator] = None,
        train: bool = True,
        vis_feats: Optional[torch.Tensor] = None,
        codes: Optional[torch.Tensor] = None,   # [B, K, Ta] int
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Teacher-forced loss. Returns ``(loss, aux)`` with ``aux =
        {loss_per_codebook, logits, targets, mask}``.

        Clip-partitioned audio ``[B, n_clips, 1, Ta_clip]`` is folded into
        the batch axis with the matching per-clip frames. ``codes``
        bypasses the DAC encode (datasets with precomputed tokens). Every
        stochastic mask of ``train=True`` comes from ``generator``."""
        K = self.num_codebooks
        if codes is None:
            if audio.ndim == 4:
                B0, n_clips = audio.shape[:2]
                audio = audio.reshape(B0 * n_clips, *audio.shape[2:])
                if frames is not None and frames.shape[1] == n_clips:
                    frames = frames.reshape(B0 * n_clips, 1, *frames.shape[2:])
            codes = self.encode_audio(audio)
        codes = codes.to(self.device).long().detach()
        B, _, Ta = codes.shape

        if vis_feats is None:
            vis_feats = self.visual_features(
                frames, train=train and not self.freeze_feature_extractor,
                generator=generator)
        pattern = self.pattern_provider.get_pattern(Ta)
        # implicit BOS shift: the sequence is built over codes[:, :, :-1]
        seq, _, _ = pattern.build_pattern_sequence(codes[:, :K, :-1],
                                                   self.special_token_id)
        logits = self.sampler(seq, vis_feats.to(self.device), train,
                              generator=generator)  # [B, K, S, card]
        # align the logits with the codes' timesteps; NaN marks the slots
        # no sequence step predicts
        reverted, _, logits_mask = pattern.revert_pattern_logits(
            logits.permute(0, 3, 1, 2), float("nan"))
        reverted = reverted.permute(0, 2, 3, 1)  # [B, K, Ta, card]
        mask = torch.as_tensor(logits_mask, device=self.device)[None].expand(
            B, K, Ta)
        targets = codes[:, :K]
        loss, loss_per_cb = masked_codebook_cross_entropy(reverted, targets,
                                                          mask)
        return loss, {"loss_per_codebook": loss_per_cb, "logits": reverted,
                      "targets": targets, "mask": mask}

    @torch.no_grad()
    def decode_audio(self, codes: torch.Tensor,
                     chunk_size: Optional[int] = None) -> torch.Tensor:
        """Codes ``[B, K, T]`` -> waveform ``[B, 1, T * hop]``; ``chunk_size``
        decodes the batch in sequential slices."""
        B = codes.shape[0]
        if chunk_size and B > chunk_size:
            c = _largest_divisor(B, chunk_size)
            return torch.cat([self.dac.decode(codes[i:i + c])
                              for i in range(0, B, c)])
        return self.dac.decode(codes)

    # ------------------------------------------------------------------ #
    def prepare_generation(self, max_new_tokens: int):
        """Host tables of a generation of ``max_new_tokens`` timesteps:
        ``(pattern, valid_mask [K, S], S)``."""
        pattern = self.pattern_provider.get_pattern(max_new_tokens)
        _, mask = pattern._build_seq_tables(max_new_tokens)
        return pattern, mask, mask.shape[1]

    @torch.no_grad()
    def build_cond_seq_for_generation(self, vis_feats: torch.Tensor, S: int,
                                      tokens_per_frame: Optional[int] = None,
                                      cfg: bool = False) -> torch.Tensor:
        """Project visual features and lay them out per sequence position;
        with ``cfg`` the null-condition stream follows on the batch axis."""
        B, Tv, _ = vis_feats.shape
        if tokens_per_frame is None:
            tokens_per_frame = default_tokens_per_frame(
                S, Tv, self.num_codebooks, self.pattern_name)
        cond_emb = self.sampler.embed_cond(vis_feats)
        if cfg:
            cond_emb = torch.cat(
                [cond_emb, self.sampler.uncond_cond_emb(B, Tv)], dim=0)
        return self.sampler.build_cond_seq(cond_emb, S, tokens_per_frame)

    def generation_step(self, cache, gen_seq: torch.Tensor,
                        cond_seq: torch.Tensor, s: int,
                        valid_mask: torch.Tensor,
                        generator: Optional[torch.Generator], *,
                        use_sampling: bool, temp: float, top_k: int,
                        top_p: float, cfg_scale: float) -> None:
        """Step ``s``: feed the token at ``s-1``, advance the cache, blend
        CFG, sample, force the special token on invalid codebook slots and
        write ``gen_seq[:, :, s]`` where it is still UNKNOWN (prompt tokens
        win). Updates ``gen_seq`` and ``cache`` in place."""
        B = gen_seq.shape[0]
        use_cfg = cfg_scale > 1.0
        tok_in = gen_seq[:, :, s - 1:s]
        if use_cfg:
            tok_in = tok_in.repeat(2, 1, 1)
        logits = self.sampler.decode_step(tok_in, cond_seq[:, s - 1:s], cache,
                                          s - 1)
        if use_cfg:
            logits = cfg_blend(logits[:B], logits[B:], cfg_scale)
        next_tok = sample_tokens(logits, generator=generator,
                                 use_sampling=use_sampling, temp=temp,
                                 top_k=top_k, top_p=top_p)
        next_tok = torch.where(valid_mask[None, :, s], next_tok,
                               self.special_token_id)
        cur = gen_seq[:, :, s]
        gen_seq[:, :, s] = torch.where(cur == UNKNOWN_TOKEN, next_tok, cur)

    @torch.no_grad()
    def generate_tokens(
        self,
        cond_seq: torch.Tensor,        # [(2)B, S, cond_dim]
        gen_seq_init: torch.Tensor,    # [B, K, S] (UNKNOWN where to generate)
        generator: Optional[torch.Generator],
        *,
        S: int,
        valid_mask: np.ndarray,
        start_step: int = 1,
        use_sampling: bool = True,
        temp: float = 1.0,
        top_k: int = 256,
        top_p: float = 0.0,
        cfg_scale: float = 1.0,
        cache_dtype: Optional[torch.dtype] = None,
        decode_buckets: int = 1,
    ) -> torch.Tensor:
        """Run steps ``start_step .. S-1`` and return the completed
        ``[B, K, S]`` sequence.

        ``decode_buckets`` is accepted for call compatibility with the JAX
        package and has no effect: the decode-attention kernel reads only
        the cache positions below each step's position from the one
        preallocated cache, which is what the chunk buffers did there. The
        results differ from JAX's chunked cache only in how the float32
        sums are grouped."""
        del decode_buckets
        cache = self.sampler.init_cache(cond_seq.shape[0], S, dtype=cache_dtype)
        gen_seq = gen_seq_init.clone()
        vm = torch.as_tensor(valid_mask, device=gen_seq.device)
        for s in range(start_step, S):
            self.generation_step(
                cache, gen_seq, cond_seq, s, vm, generator,
                use_sampling=use_sampling, temp=temp, top_k=top_k, top_p=top_p,
                cfg_scale=cfg_scale)
        return gen_seq

    @torch.no_grad()
    def generate(
        self,
        frames: Optional[torch.Tensor] = None,
        *,
        generator: Optional[torch.Generator] = None,
        seed: int = 0,
        audio_prompt_codes: Optional[torch.Tensor] = None,  # [B, K, T0]
        max_new_tokens: int = 221,
        use_sampling: bool = True,
        temp: float = 1.0,
        top_k: int = 256,
        top_p: float = 0.0,
        cfg_scale: float = 1.0,
        tokens_per_frame: Optional[int] = None,
        vis_feats: Optional[torch.Tensor] = None,
        decode_to_audio: bool = True,
        dac_chunk_size: Optional[int] = None,
        encoder_chunk_size: Optional[int] = None,
        decode_buckets: int = 8,
        check: bool = False,
    ) -> Dict[str, object]:
        """Frames (or features) -> ``{"codes" [B, K, max_new_tokens],
        "audio" [B, 1, samples], "stage_ms"}``. Sampling draws from
        ``generator`` (a new one seeded with ``seed`` on the system's device
        when none is given). ``decode_buckets`` has no effect (see
        ``generate_tokens``). ``stage_ms`` holds the milliseconds of the
        encoder, decode loop and DAC stages."""
        K = self.num_codebooks
        dev = self.device
        clock = StageClock(dev)
        clock.mark("start")
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(seed)
        pattern, valid_mask, S = self.prepare_generation(max_new_tokens)

        if vis_feats is None and self.encoder is not None and frames is not None:
            vis_feats = self.visual_features(frames,
                                             chunk_size=encoder_chunk_size)
        if vis_feats is None:
            raise ValueError("generate needs frames or vis_feats")
        vis_feats = vis_feats.to(dev)
        clock.mark("encoder")
        B = vis_feats.shape[0]

        gen_codes = torch.full((B, K, max_new_tokens), UNKNOWN_TOKEN,
                               dtype=torch.long, device=dev)
        start_offset = 0
        if audio_prompt_codes is not None:
            start_offset = int(audio_prompt_codes.shape[-1])
            if start_offset >= max_new_tokens:
                raise ValueError("the prompt must be shorter than max_new_tokens")
            first = pattern.get_first_step_with_timesteps(start_offset)
            if first is not None and first > 16:
                raise NotImplementedError(
                    "prompts that reach past sequence step 16 need prefill, "
                    "which is not ported yet")
            gen_codes[:, :, :start_offset] = audio_prompt_codes.to(dev).long()
        gen_seq, _, _ = pattern.build_pattern_sequence(gen_codes,
                                                       self.special_token_id)
        use_cfg = cfg_scale > 1.0
        cond_seq = self.build_cond_seq_for_generation(vis_feats, S,
                                                      tokens_per_frame, cfg=use_cfg)
        gen_seq = self.generate_tokens(
            cond_seq, gen_seq, generator, S=S, valid_mask=valid_mask,
            use_sampling=use_sampling, temp=temp, top_k=top_k, top_p=top_p,
            cfg_scale=cfg_scale, decode_buckets=decode_buckets)

        if check:
            seq = gen_seq.cpu().numpy()
            assert not (seq == UNKNOWN_TOKEN).any(), "unfilled positions"
            assert (seq == np.where(valid_mask[None], seq,
                                    self.special_token_id)).all(), (
                "sequence/mask mismatch")
        out_codes, _, _ = pattern.revert_pattern_sequence(gen_seq, UNKNOWN_TOKEN)
        out_codes = out_codes[..., :max_new_tokens]
        clock.mark("decode_loop")
        result: Dict[str, object] = {"codes": out_codes}
        if decode_to_audio:
            result["audio"] = self.decode_audio(out_codes, chunk_size=dac_chunk_size)
            clock.mark("dac")
        result["stage_ms"] = clock.ms()
        return result
