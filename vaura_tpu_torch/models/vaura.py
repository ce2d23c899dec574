"""The composite V-AURA system.

Generation: frames -> MotionFormer features -> bridge -> conditioning
sequence (with the CFG null stream) -> codebook pattern (delayed by
default, or any provider of ``ops/patterns.py``) -> KV-cache decode loop ->
pattern revert -> DAC waveform.

Training (``train_forward``): audio -> DAC codes (frozen, no graph) ->
the pattern with the implicit BOS shift -> MotionFormer (``train=True``:
the unfused, differentiable blocks) -> bridge -> teacher-forced sampler ->
logits reverted to the codes' timesteps (NaN at the slots no step
predicts) -> masked per-codebook cross entropy.

Long horizons: ``generate_long`` (chunks of at most ``model_max_tokens``
that carry the last ``chunk - stride`` tokens as the next chunk's prompt,
ingested by ``Sampler.prefill``) and ``generate_long_kv`` (one continuous
decode over a rolling cache that keeps sink chunks and a trailing window of
chunks); ``generate_long_stream`` and ``generate_long_kv_stream`` yield
their codes and waveform in increments.

Counterpart of ``vaura_tpu/models/vaura.py`` (``visual_features``,
``train_forward``, ``encode_audio``, ``load_dac_embeddings_into_sampler``,
``prepare_generation``, ``build_cond_seq_for_generation``, the generation
step, ``generate_tokens``, ``generate_tokens_streaming``, ``generate``,
``generate_long``, ``long_chunk_schedule``, ``generate_long_kv``, the two
streaming generators, ``decode_audio``). JAX runs the decode loop as a
compiled ``lax.scan``; here every decode loop is ``_device_loop``, a Python
loop over one step whose position is a 0-d int64 tensor on the device
(position, noise and cache in buffers that live through the loop), so
nothing waits for the device inside it. On a card without a mesh
``generate_tokens`` records that step as a CUDA graph and replays it: one
graph launch a step for the ~1,200 kernel launches of the flagship's step;
elsewhere (the CPU, a mesh, short loops, the rolling cache) the same step
runs eagerly. The loop keeps ONE preallocated cache
``[L, 2B, S, H_kv, hd]`` (for the DeepSeek-V3 sampler the latent
``c``/``k_pe`` rows, and the routed experts' counters
``Sampler.expert_load`` / ``expert_choices``): the
decode-attention kernel reads only the rows below the current one, which is
what ``decode_buckets`` achieved with chunk buffers on the TPU. The rolling
cache of ``generate_long_kv`` is one buffer too (see
``_stream_kv_segments``). JAX's chunk buffers are more than a regrouping
under ``int8_dots``: there the attention probabilities are quantized per
chunk, so the chunks change the numbers, and the port hands JAX's chunk
boundaries to the kernel as the cache's ``chunk_starts`` (``chunk_bounds``,
the kept chunks' rows of the rolling cache).
Sampling draws from the caller's ``torch.Generator``, one generator for the
whole call where JAX splits its key per chunk.

Under a mesh (``parallel.shard_module`` sets ``placement``) every rank
calls the same entry point on its rows of the batch: training sums the
ranks' shares of the global loss (``ops/losses.py``); generation runs on
each rank's rows with the whole (or, over ``model``, this rank's) weights
gathered once for the call (``gathered_weights``), the CFG null stream
stacked after the batch was sharded, so each row's two halves stay on one
rank, draws of the whole batch's noise (``ops/sampling.py``), and the codes
and audio gathered to every rank or to rank 0 when the caller asks
(``gather``). Inside ``replicated`` every rank runs the same call on the
whole batch instead (a server's B=1 stream, the tracked training files).
LoRA adapters stay whole on every rank and merge into this rank's weights
(``lora_merged``): once a generation call into the gathered weights, at
each use of a layer in training into the block's weight FSDP2 gathered.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import logging
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vaura_tpu_torch.models.bridges import IdentityBridge
from vaura_tpu_torch.models.dac.model import Dac, DacConfig
from vaura_tpu_torch.models.motionformer import MotionFormer, MotionFormerConfig
from vaura_tpu_torch.models.sampler import (
    NO_EXPERT,
    Sampler,
    SamplerConfig,
    default_tokens_per_frame,
    use_adapters,
    use_weights,
)
from vaura_tpu_torch.ops import decode_attention as da
from vaura_tpu_torch.ops import decode_block as db
from vaura_tpu_torch.ops import divided_attention as ga
from vaura_tpu_torch.ops import encoder_fused as ef
from vaura_tpu_torch.ops import mla_decode_attention as mla
from vaura_tpu_torch.ops.dropout import batch_shard
from vaura_tpu_torch.ops.losses import masked_codebook_cross_entropy
from vaura_tpu_torch.ops.patterns import (
    CodebooksPatternProvider,
    DelayedPatternProvider,
)
from vaura_tpu_torch.ops.sampling import cfg_blend, draws_noise, sample_tokens
from vaura_tpu_torch.train.lora import (
    DEFAULT_TARGETS,
    adapted_layers,
    init_lora,
    merge_lora,
    merged_weight,
)
from vaura_tpu_torch.utils import DeviceLike, StageClock, resolve_device
from vaura_tpu_torch.utils.spans import span

UNKNOWN_TOKEN = -1

# decode steps since import, kept as ``ops/decode_attention.py`` keeps its
# launch counters: replayed from a CUDA graph of the step, or run eagerly
# (every step of a loop that records no graph, and a graph's warm-up)
replayed_steps = 0
eager_steps = 0

# the graph loop (``VauraSystem._device_loop``): eager steps on the capture
# stream before the recording (they make the step's lazy state, such as
# cuBLAS's workspace for that stream), and the fewest steps a loop must run
# for the recording to pay: on an H100 the flagship's recording took 25-48
# ms of host, an eager step 25 ms and a replay 0.015 ms, for 4-13 ms of
# device work a step at batch 2-512, so a replay saves 12-25 ms
# (``PERF.md`` §6, PR 21)
GRAPH_WARMUP_STEPS = 1
GRAPH_MIN_STEPS = 8

# the kernel wrappers' launch counters, by module; a replayed step adds what
# its recording launched
_LAUNCH_COUNTERS = (
    (da, ("launches", "device_pos_launches", "int8_launches", "int4_launches",
          "int8_dots_launches", "form_launches")),
    (ef, ("attention_launches", "mlp_launches")),
    (ga, ("launches",)),
    (mla, ("launches",)),
    (db, ("launches",)),
)
_capture_streams: Dict[torch.device, "torch.cuda.Stream"] = {}


def _launch_counts() -> Dict[tuple, int]:
    """``{(module, name, key): count}`` of ``_LAUNCH_COUNTERS`` (``key`` the
    entry of a counter that is a dict, else None)."""
    out = {}
    for mod, names in _LAUNCH_COUNTERS:
        for name in names:
            value = getattr(mod, name)
            if isinstance(value, dict):
                out.update(((mod, name, k), v) for k, v in value.items())
            else:
                out[(mod, name, None)] = value
    return out


def _add_launch_counts(counts: Dict[tuple, int]) -> None:
    for (mod, name, key), n in counts.items():
        if key is None:
            setattr(mod, name, getattr(mod, name) + n)
        else:
            getattr(mod, name)[key] += n


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream on which the graph loop warms up and records (a
    graph cannot be recorded on the default stream); one a device."""
    if device not in _capture_streams:
        _capture_streams[device] = torch.cuda.Stream(device)
    return _capture_streams[device]


def _largest_divisor(n: int, cap: int) -> int:
    return next(c for c in range(min(cap, n), 0, -1) if n % c == 0)


def chunk_bounds(S: int, decode_buckets: int, start_step: int = 1) -> list:
    """The cache rows at which the JAX package's bucketed decode splits its
    cache into chunk buffers (``vaura_tpu/models/vaura.py:515-525``): the
    step range ``[start_step, S)`` in ``decode_buckets`` segments whose ends
    are rounded up to multiples of 8; chunk ``j`` holds the rows segment
    ``j`` writes. Returns ``[0, ..., S]``, one more entry than chunks."""
    n_b = max(int(decode_buckets), 1)
    bounds = sorted({min(-(-((i + 1) * S) // n_b // 8) * 8, S)
                     for i in range(n_b)})
    eff = [hi for hi in bounds if hi > start_step]
    return [0] + [h - 1 for h in eff[:-1]] + [S]


def _within(context: str):
    """A decorator that runs an entry point (a function or a generator)
    inside the system's context manager named ``context``."""
    def wrap(fn):
        if inspect.isgeneratorfunction(fn):
            @functools.wraps(fn)
            def stream(self, *args, **kwargs):
                with getattr(self, context)():
                    yield from fn(self, *args, **kwargs)
            return stream

        @functools.wraps(fn)
        def call(self, *args, **kwargs):
            with getattr(self, context)():
                return fn(self, *args, **kwargs)
        return call
    return wrap


# the LoRA merge where the JAX package resolves its parameters
# (``_resolve_params``), and a mesh's weights gathered once a generation;
# a generation gathers first, so its merge reads this rank's whole (local)
# weights and not an FSDP2 shard of them
_merges_lora = _within("lora_merged")
_gathers_weights = _within("gathered_weights")
_draws_by_rows = _within("row_draws")


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
        pattern_provider: Optional[CodebooksPatternProvider] = None,
        bridge: Optional[nn.Module] = None,
        use_visual_conditioning: bool = True,
        freeze_feature_extractor: bool = False,
        device: DeviceLike = None,
        lora_rank: int = 0,
        lora_targets: Optional[Tuple[str, ...]] = None,
        lora_alpha: Optional[float] = None,
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
        # LoRA (train/lora.py): rank 0 disables; the adapters are a module
        # beside the sampler, merged into its weights at each entry call
        self.lora_rank, self.lora_alpha = int(lora_rank), lora_alpha
        self.lora_sampler = None
        if self.lora_rank > 0 and sampler_config.deepseek:
            raise NotImplementedError(
                "LoRA on the DeepSeek-V3 block: its adapters target the "
                "Llama block's layers")
        if self.lora_rank > 0:
            self.lora_sampler = init_lora(
                self.sampler, self.lora_rank,
                tuple(lora_targets or DEFAULT_TARGETS))
        # the mesh placement (parallel.shard_module); None on one device
        self.placement = None
        self._weights_gathered = False
        # every rank runs the same call on the whole batch (``replicated``)
        self._replicated = False
        # record each decode row's chosen experts (``expert_choices``)
        self.record_routes = False

    @contextlib.contextmanager
    def gathered_weights(self):
        """Under a mesh, gather the FSDP2-sharded modules' weights (this
        model rank's part of each) once, until the block ends: generation
        calls the sampler's decode methods hundreds of times, and a gather
        per call would cost a collective per layer and step. Nothing on one
        device, or inside an enclosing block."""
        if self.placement is None or self._weights_gathered:
            yield
            return
        from torch.distributed.fsdp import FSDPModule

        mods = [m for m in self.modules() if isinstance(m, FSDPModule)]
        for m in mods:
            m.unshard()
        self._weights_gathered = True
        try:
            yield
        finally:
            self._weights_gathered = False
            for m in mods:
                m.reshard()

    @contextlib.contextmanager
    def replicated(self):
        """Under a mesh, the entry calls inside the block are replicated:
        every rank passes the same whole batch (a server's B=1 stream, the
        tracked files of a training batch), takes part in the collectives
        of the placed weights, draws the one-process noise and masks, and
        gets the whole result; no loss or result is summed or gathered over
        the batch's shards (JAX's ``replicated`` placement,
        ``vaura_tpu/parallel/mesh.py``). Nothing on one device."""
        prev, self._replicated = self._replicated, True
        try:
            yield
        finally:
            self._replicated = prev

    def _shards_rows(self) -> bool:
        """Whether this rank holds its rows of the batch (a mesh, outside
        ``replicated``)."""
        return self.placement is not None and not self._replicated

    def row_draws(self):
        """Under a mesh, the masks of a training forward drawn for the whole
        batch, of which this rank keeps its rows
        (``ops/dropout.py::batch_shard``); nothing on one device."""
        pl = self.placement
        return batch_shard((pl.batch_rank, pl.batch_size)
                           if self._shards_rows() else None)

    def _sample_rows(self, batch: int):
        """``(first row, rows)`` of this rank's ``batch`` rows in the whole
        batch under a mesh, for the draws of ``ops.sampling``; None on one
        device."""
        pl = self.placement
        return ((pl.batch_rank * batch, pl.batch_size * batch)
                if self._shards_rows() else None)

    def _gather_result(self, result: Dict[str, object],
                       gather: Optional[str]) -> Dict[str, object]:
        """Under a mesh, ``result``'s codes and audio of the whole batch on
        every rank (``gather="all"``) or on rank 0 (``"main"``; the other
        ranks get None); this rank's rows when ``gather`` is None. A
        replicated call's result is whole on every rank already."""
        if gather is None or not self._shards_rows():
            return result
        for key in ("codes", "audio"):
            if key in result:
                result[key] = self.placement.gather_rows(result[key], gather)
        return result

    def batch_total(self, x: torch.Tensor) -> torch.Tensor:
        """A loss of this rank's rows summed over the batch's shards: the
        whole batch's loss (``x`` itself on one device)."""
        return self.placement.batch_sum(x) if self._shards_rows() else x

    @property
    def num_codebooks(self) -> int:
        return self.sampler_config.num_codebooks

    @property
    def special_token_id(self) -> int:
        return self.sampler_config.special_token_id

    @contextlib.contextmanager
    def lora_merged(self):
        """Run the sampler with the LoRA adapters merged into its weights
        until the block ends, ``W + (alpha / r) * lora_b @ lora_a``
        (``train/lora.py::merged_weight``). A call that records no graph and
        holds its weights whole (one device, or gathered under a mesh: a
        generation) merges once, not at each use: each adapted ``PDense``
        gets its merged weight (``use_weights``). A call that records a
        graph, or whose weights are FSDP2 shards (training and validation
        under a mesh), installs each layer's merge as its ``adapter``
        (``use_adapters``), which the layer runs at each use on the weight
        its module holds then: under FSDP2 the block's gathered weight, so
        no rank holds the whole sampler gathered, and a remat block merges
        again in the backward rerun. Gradients reach the adapters through
        either. Without adapters, and inside an enclosing block (its layers
        already hold merged weights or adapters), it does nothing. The
        nesting is read from the layers, not kept on the system, so a copy
        of the system taken inside a block (a hot reload's view) merges on
        its own next call. Under a mesh the adapters are whole on every
        rank and the weights this rank's (over ``model`` its rows or
        columns): each delta takes its weight's cut
        (``MeshPlacement.model_part``)."""
        if self.lora_sampler is None:
            yield
            return
        layers = adapted_layers(self.sampler, self.lora_sampler)
        if any(m.merged is not None or m.adapter is not None
               for m, _ in layers.values()):
            yield
            return
        pl = self.placement
        cut = (None if pl is None else
               lambda name, delta: pl.model_part(f"sampler.{name}.weight",
                                                 delta))
        if torch.is_grad_enabled() or (pl is not None and pl.shards
                                       and not self._weights_gathered):
            adapters = {dense: functools.partial(
                            merged_weight, pair=pair, alpha=self.lora_alpha,
                            cut=cut and functools.partial(cut, name))
                        for name, (dense, pair) in layers.items()}
            with use_adapters(adapters):
                yield
            return
        merged = merge_lora(self.sampler, self.lora_sampler, self.lora_alpha,
                            cut)
        with use_weights({layers[name][0]: w for name, w in merged.items()}):
            yield

    def load_state_dicts(self, state_dicts: Dict[str, Dict[str, torch.Tensor]]):
        """Load ``{"sampler", "dac", "encoder", "bridge", "lora_sampler"}``
        state dicts (the keys present) into the matching submodules."""
        for name, sd in state_dicts.items():
            module = getattr(self, name)
            if module is None:
                raise ValueError(f"state dict for {name!r}, which this system "
                                 "does not have")
            module.load_state_dict(sd)
        return self

    def _quantizes_probs(self) -> bool:
        """Whether decode attention quantizes its probabilities per chunk
        group (``int8_dots`` over a quantized cache)."""
        cfg = self.sampler_config
        return cfg.int8_dots and cfg.quantize_cache

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def load_dac_embeddings_into_sampler(self) -> bool:
        """Initialise the sampler's factored token embeddings from the DAC
        quantizer: each codebook table (plus a seeded random special row)
        and the folded out-projection as ``v`` with gain ``||v||``. Returns
        False, and changes nothing, when the geometries differ. Plain token
        tables (``dac_factored_embeddings: false``) raise ``ValueError`` when
        the geometries agree: the JAX package writes the ``[K*(V+1),
        codebook_dim]`` codebooks over the ``[K*(V+1), token_dim]`` table
        there, and its next forward fails on the shape."""
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
        if not cfg.dac_factored_embeddings:
            raise ValueError(
                "load_dac_embeddings_into_sampler: the DAC codebooks "
                "initialise DAC-factored token embeddings only; this sampler "
                "has plain tables (dac_factored_embeddings: false), which the "
                "JAX package's loader overwrites with a table of the wrong "
                "shape")
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
        encoder, ``frames`` is taken as ``[B, Tv, D]`` features. Under a
        mesh every rank calls it with the same frames, as FSDP2 gathers each
        sharded block's weights in its forward, and gets the whole
        features."""
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
                    feats = torch.cat([self._encoder_chunk(frames[i:i + c])
                                       for i in range(0, B, c)])
                else:
                    feats = self._encoder_chunk(frames, train, generator)
            B, S, t, D = feats.shape
            feats = feats.reshape(B, S * t, D)
        if self.bridge is not None:
            feats = self.bridge(feats)
        return feats

    def _encoder_chunk(self, frames: torch.Tensor, *args) -> torch.Tensor:
        with span("encoder.chunk"):
            return self.encoder(frames, *args)

    # ------------------------------------------------------------------ #
    def encode_audio(self, audio: torch.Tensor) -> torch.Tensor:
        """Waveform ``[B, 1, T]`` -> codes ``[B, K, T / hop]`` (no graph)."""
        return self.dac.encode(audio.to(self.device))

    @_merges_lora
    @_draws_by_rows
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
            with span("train.codec_encode"):
                codes = self.encode_audio(audio)
        codes = codes.to(self.device).long().detach()
        B, _, Ta = codes.shape

        if vis_feats is None:
            with span("train.encoder"):
                vis_feats = self.visual_features(
                    frames, train=train and not self.freeze_feature_extractor,
                    generator=generator)
        with span("train.sampler"):
            pattern = self.pattern_provider.get_pattern(Ta)
            # implicit BOS shift: the sequence is built over codes[:, :, :-1]
            seq, _, _ = pattern.build_pattern_sequence(codes[:, :K, :-1],
                                                       self.special_token_id)
            logits = self.sampler(seq, vis_feats.to(self.device), train,
                                  generator=generator)  # [B, K, S, card]
        with span("train.loss"):
            # align the logits with the codes' timesteps; NaN marks the
            # slots no sequence step predicts
            reverted, _, logits_mask = pattern.revert_pattern_logits(
                logits.permute(0, 3, 1, 2), float("nan"))
            reverted = reverted.permute(0, 2, 3, 1)  # [B, K, Ta, card]
            mask = torch.as_tensor(logits_mask, device=self.device)[None].expand(
                B, K, Ta)
            targets = codes[:, :K]
            loss, loss_per_cb = masked_codebook_cross_entropy(
                reverted, targets, mask,
                self.placement.batch_sum if self._shards_rows() else None)
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
            return torch.cat([self._dac_slice(codes[i:i + c])
                              for i in range(0, B, c)])
        return self._dac_slice(codes)

    def _dac_slice(self, codes: torch.Tensor) -> torch.Tensor:
        with span("dac.slice"):
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

    def step_rows(self, cache, gen_seq: torch.Tensor, cond_seq: torch.Tensor,
                  s: torch.Tensor, valid_mask: torch.Tensor,
                  generator: Optional[torch.Generator] = None, *,
                  use_sampling: bool, temp: float, top_k: int, top_p: float,
                  cfg_scale: float, row: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Step ``s``, which writes nothing: feed the token at ``s-1``, run
        the sampler at position ``s-1`` into cache row ``row`` (by default
        ``s-1``), blend CFG, sample, force the special token on invalid
        codebook slots and keep the column's tokens that are not UNKNOWN
        (prompt tokens win). ``s`` (and ``row``) are 0-d int64 tensors on
        the device, ``valid_mask [K, S]`` a device bool tensor; every index
        is an ``index_select`` and decode attention the registered operator
        (``Sampler.decode_rows``), so one traced graph serves every step.
        ``noise`` is the sampling's uniform draw
        (``ops.sampling.uniform_noise``), else drawn from ``generator``.
        Returns ``(the column gen_seq[:, :, s] becomes [B, K], this
        position's cache rows)``."""
        prev = (s - 1).reshape(1)
        with span("decode_step.forward"):
            tok_in = gen_seq.index_select(2, prev)
            if cfg_scale > 1.0:
                tok_in = tok_in.repeat(2, 1, 1)
            logits, rows = self.sampler.decode_rows(
                tok_in, cond_seq.index_select(1, prev), cache, s - 1,
                s - 1 if row is None else row)
        with span("decode_step.sample"):
            col = self._next_tokens(
                logits, gen_seq.index_select(2, s.reshape(1))[..., 0],
                valid_mask.index_select(1, s.reshape(1))[:, 0], generator,
                noise=noise, use_sampling=use_sampling, temp=temp,
                top_k=top_k, top_p=top_p, cfg_scale=cfg_scale)
        return col, rows

    def _next_tokens(self, logits: torch.Tensor, cur: torch.Tensor,
                     valid: torch.Tensor,
                     generator: Optional[torch.Generator], *,
                     use_sampling: bool, temp: float, top_k: int,
                     top_p: float, cfg_scale: float,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The column a step writes: the CFG blend of ``logits``, a sample,
        the special token where ``valid [K]`` is false, and ``cur [B, K]``
        (the column as it stands) where it is not UNKNOWN."""
        B = cur.shape[0]
        if cfg_scale > 1.0:
            logits = cfg_blend(logits[:B], logits[B:], cfg_scale)
        next_tok = sample_tokens(logits, generator=generator,
                                 use_sampling=use_sampling, temp=temp,
                                 top_k=top_k, top_p=top_p,
                                 rows=self._sample_rows(B), noise=noise)
        next_tok = torch.where(valid[None], next_tok, self.special_token_id)
        return torch.where(cur == UNKNOWN_TOKEN, next_tok, cur)

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
        initial_cache: Optional[Dict[str, torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Run steps ``start_step .. S-1`` and return the completed
        ``[B, K, S]`` sequence. ``initial_cache`` (``Sampler.prefill``'s) is
        the cache to continue, in place; by default a zero cache of ``S``
        rows.

        ``decode_buckets`` is the JAX package's split of the cache into
        chunk buffers. The decode-attention kernel reads only the cache
        positions below each step's position from the one preallocated
        cache, which is what the chunk buffers did there, so without
        ``int8_dots`` the split changes only how float32 sums are grouped
        and is not made. Under ``int8_dots`` (with a quantized cache) the
        attention probabilities are quantized per chunk, and the chunks'
        first rows (``chunk_bounds``) become the cache's
        ``chunk_starts``.

        The steps run in ``_device_loop``; on a card without a mesh, with at
        least ``GRAPH_MIN_STEPS`` steps, they are replayed from a CUDA graph:
        the same kernels on the same values, the same draws from
        ``generator``."""
        cache = (initial_cache if initial_cache is not None else
                 self.sampler.init_cache(cond_seq.shape[0], S, dtype=cache_dtype))
        if self._quantizes_probs():
            cache["chunk_starts"] = torch.tensor(
                chunk_bounds(S, decode_buckets, start_step)[:-1],
                dtype=torch.int32, device=cache["k"].device)
        cfg = self.sampler_config
        if cfg.moe:  # the rows each expert gets, a row per position
            self.sampler.expert_load = torch.zeros(
                S, cfg.moe_layers, cfg.n_routed_experts, dtype=torch.int32,
                device=cond_seq.device)
            self.sampler.expert_choices = None if not self.record_routes \
                else torch.full((S, cfg.moe_layers, cond_seq.shape[0],
                                 cfg.num_experts_per_tok), NO_EXPERT,
                                dtype=torch.uint8, device=cond_seq.device)
        gen_seq = gen_seq_init.clone()
        vm = torch.as_tensor(valid_mask, device=gen_seq.device)
        kw = dict(use_sampling=use_sampling, temp=temp, top_k=top_k,
                  top_p=top_p, cfg_scale=cfg_scale)
        steps = range(start_step, S)
        with torch.cuda.device_of(gen_seq):  # its device's streams
            self._device_loop(cache, gen_seq, cond_seq, vm, generator, steps,
                              graph=self._replays_steps(cache, len(steps)),
                              **kw)
        return gen_seq

    def _replays_steps(self, cache, steps: int) -> bool:
        """Whether ``generate_tokens`` replays its steps from a CUDA graph:
        the cache on a card, no mesh (tensor parallelism's all-reduces stay
        eager) and at least ``GRAPH_MIN_STEPS`` steps to run."""
        return (cache[self.sampler.cache_names[0]].is_cuda
                and self.placement is None and steps >= GRAPH_MIN_STEPS)

    def expert_load(self) -> Optional[torch.Tensor]:
        """The last ``generate_tokens`` call's rows routed to each expert,
        int32 ``[positions, moe_layers, n_routed_experts]`` on the host (row
        ``p`` the step that read position ``p``; rows no step ran are 0);
        None without routed experts or before a call. Reads the device
        counter once (``Sampler.expert_load``)."""
        load = self.sampler.expert_load
        return None if load is None else load.cpu()

    def expert_choices(self, rows: Optional[torch.Tensor] = None
                       ) -> Optional[torch.Tensor]:
        """With ``record_routes`` set before the call, the last
        ``generate_tokens`` call's chosen experts of each decode row (the CFG
        null stream's rows after the batch's), uint8 ``[positions,
        moe_layers, rows, num_experts_per_tok]`` on the host (``NO_EXPERT``
        where no choice was made), of ``rows`` (a device index) or of
        all; else None."""
        ch = self.sampler.expert_choices
        if ch is None:
            return None
        return (ch if rows is None else ch.index_select(2, rows)).cpu()

    def _device_loop(self, cache, gen_seq: torch.Tensor,
                     cond_seq: torch.Tensor, valid_mask: torch.Tensor,
                     generator: Optional[torch.Generator], steps: range, *,
                     graph: bool, row_shift: int = 0, **kw) -> None:
        """Steps ``steps`` in place, every decode loop's: the position a
        0-d int64 tensor that each step advances by one, and before each
        step the sampling's uniform draw made from ``generator`` into one
        buffer (``uniform_noise``'s values, in its order; under a mesh the
        whole batch's rows, of which ``sample_tokens`` keeps this rank's). A
        step is ``step_rows``, its rows committed to cache row ``s - 1 +
        row_shift`` (the rolling cache's shift; 0 adds no launch) and its
        column written to ``gen_seq[:, :, s]``. The step reads and writes
        only tensors that live through the loop, so with ``graph`` the loop
        runs the first ``GRAPH_WARMUP_STEPS`` eagerly on a side stream,
        records the next as a CUDA graph there (span ``decode_capture``)
        and replays it for that step and every later one on the current
        stream (span ``decode_step.replay``). A replay adds to the launch
        counters what its recording launched; the recording counts none.
        The graph and its memory pool go when the loop ends, the pool's
        memory back to the card (without a pool of its own a released
        graph's memory stays reserved: ~0.9 GiB a call at batch 512).
        Without ``graph`` every step runs eagerly on the current stream."""
        global replayed_steps, eager_steps
        dev = gen_seq.device
        s = torch.full((), steps.start, dtype=torch.int64, device=dev)
        noise = None
        if draws_noise(kw["use_sampling"], kw["temp"]):
            whole = self._sample_rows(gen_seq.shape[0])
            noise = torch.empty(whole[1] if whole else gen_seq.shape[0],
                                self.num_codebooks,
                                self.sampler_config.d_codebook, device=dev)

        def draw():
            if noise is not None:
                noise.uniform_(generator=generator)

        def step():
            row = s + (row_shift - 1) if row_shift else None
            col, rows = self.step_rows(cache, gen_seq, cond_seq, s,
                                       valid_mask, row=row, noise=noise, **kw)
            self.sampler.commit_rows(cache, rows, s - 1 if row is None
                                     else row)
            gen_seq.index_copy_(2, s.reshape(1), col.unsqueeze(2))
            s.add_(1)

        n_eager = min(GRAPH_WARMUP_STEPS, len(steps)) if graph else len(steps)
        side = _capture_stream(dev) if graph else None
        if graph:  # the side stream reads what the current one wrote
            torch.cuda.current_stream(dev).synchronize()
        with torch.cuda.stream(side) if graph else contextlib.nullcontext():
            for _ in range(n_eager):
                with span("decode_step"):
                    draw()
                    step()
        eager_steps += n_eager
        if n_eager == len(steps):
            return
        # the recording's memory: a pool of its own, whose segments go back
        # to the card when the pool goes (after the graph, its other user)
        pool = torch.cuda.MemPool()
        recording = torch.cuda.CUDAGraph()
        try:
            with span("decode_capture"):  # while the warm-up runs
                before = _launch_counts()
                with torch.cuda.stream(side):
                    recording.capture_begin(pool=pool.id,
                                            capture_error_mode="thread_local")
                    try:
                        step()
                    finally:
                        recording.capture_end()
                after = _launch_counts()
                recorded = {k: after[k] - n for k, n in before.items()
                            if after[k] != n}
                _add_launch_counts({k: -n for k, n in recorded.items()})
            side.synchronize()  # the replays read what the warm-up wrote
            for _ in range(len(steps) - n_eager):
                with span("decode_step"):
                    draw()
                    with span("decode_step.replay"):
                        recording.replay()
                _add_launch_counts(recorded)
                replayed_steps += 1
        finally:
            recording.reset()

    @torch.no_grad()
    @_gathers_weights
    @_merges_lora
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
        remove_prompts: bool = False,
        vis_feats: Optional[torch.Tensor] = None,
        decode_to_audio: bool = True,
        dac_chunk_size: Optional[int] = None,
        encoder_chunk_size: Optional[int] = None,
        decode_buckets: int = 8,
        check: bool = False,
        gather: Optional[str] = None,
    ) -> Dict[str, object]:
        """Frames (or features) -> ``{"codes" [B, K, max_new_tokens],
        "audio" [B, 1, samples], "stage_ms"}``; under a mesh of this rank's
        rows, or with ``gather`` (``"all"``, ``"main"``) of the whole batch
        (``_gather_result``). Sampling draws from
        ``generator`` (a new one seeded with ``seed`` on the system's device
        when none is given). A prompt whose first generated step lies past
        sequence step 16 is ingested by one ``Sampler.prefill`` and the
        decode loop starts at that step; a shorter one runs through the
        decode steps, which keep its tokens. ``remove_prompts`` drops the
        prompt's timesteps from the codes. ``decode_buckets`` matters only
        under ``int8_dots`` (see ``generate_tokens``). ``stage_ms`` holds the
        milliseconds of
        the encoder, decode loop and DAC stages."""
        K = self.num_codebooks
        dev = self.device
        clock = StageClock(dev)
        clock.mark("start")
        generator = self._generator(generator, seed)
        pattern, valid_mask, S = self.prepare_generation(max_new_tokens)

        if vis_feats is None and self.encoder is not None and frames is not None:
            vis_feats = self.visual_features(frames,
                                             chunk_size=encoder_chunk_size)
        if vis_feats is None:
            raise ValueError("generate needs frames or vis_feats")
        vis_feats = vis_feats.to(dev)
        clock.mark("encoder")
        B = vis_feats.shape[0]

        start_offset = 0
        if audio_prompt_codes is not None:
            start_offset = int(audio_prompt_codes.shape[-1])
            if start_offset >= max_new_tokens:
                raise ValueError("the prompt must be shorter than max_new_tokens")
        with span("decode_setup"):
            gen_codes = torch.full((B, K, max_new_tokens), UNKNOWN_TOKEN,
                                   dtype=torch.long, device=dev)
            if audio_prompt_codes is not None:
                gen_codes[:, :, :start_offset] = audio_prompt_codes.to(dev).long()
            gen_seq, _, _ = pattern.build_pattern_sequence(
                gen_codes, self.special_token_id)
            use_cfg = cfg_scale > 1.0
            cond_seq = self.build_cond_seq_for_generation(
                vis_feats, S, tokens_per_frame, cfg=use_cfg)
            # a long prompt (a long-horizon chunk carries about 3/4 of one):
            # one causal forward writes its K/V, and the loop starts at the
            # first step that holds a timestep to generate. Rows from there
            # on hold K/V of the UNKNOWN placeholders (read as token 0);
            # every step reads only rows below its own, which the loop has
            # rewritten
            start_step, initial_cache = 1, None
            if start_offset > 0:
                first = pattern.get_first_step_with_timesteps(start_offset)
                if first is not None and first > 16:
                    tok_in = gen_seq.repeat(2, 1, 1) if use_cfg else gen_seq
                    _, initial_cache = self.sampler.prefill(
                        tok_in.clamp_min(0), cond_seq)
                    start_step = first
        gen_seq = self.generate_tokens(
            cond_seq, gen_seq, generator, S=S, valid_mask=valid_mask,
            start_step=start_step, initial_cache=initial_cache,
            use_sampling=use_sampling, temp=temp, top_k=top_k, top_p=top_p,
            cfg_scale=cfg_scale, decode_buckets=decode_buckets)

        with span("decode_revert"):
            if check:
                seq = gen_seq.cpu().numpy()
                assert not (seq == UNKNOWN_TOKEN).any(), "unfilled positions"
                assert (seq == np.where(valid_mask[None], seq,
                                        self.special_token_id)).all(), (
                    "sequence/mask mismatch")
            out_codes, _, _ = pattern.revert_pattern_sequence(gen_seq,
                                                              UNKNOWN_TOKEN)
            out_codes = out_codes[..., :max_new_tokens]
            if check:
                assert int(out_codes.min()) >= 0 and int(
                    out_codes.max()) <= self.special_token_id
            if remove_prompts:
                out_codes = out_codes[..., start_offset:]
        clock.mark("decode_loop")
        result: Dict[str, object] = {"codes": out_codes}
        if decode_to_audio:
            result["audio"] = self.decode_audio(out_codes, chunk_size=dac_chunk_size)
            clock.mark("dac")
        result["stage_ms"] = clock.ms()
        return self._gather_result(result, gather)

    # ------------------------------------------------------------------ #
    # long horizons
    # ------------------------------------------------------------------ #
    def _generator(self, generator: Optional[torch.Generator],
                   seed: int) -> torch.Generator:
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        return generator

    @torch.no_grad()
    def _long_encode_segments(self, frames: Optional[torch.Tensor],
                              vis_feats_segments: Optional[torch.Tensor],
                              chunk_size: Optional[int] = None
                              ) -> torch.Tensor:
        """The visual encoder ONCE over all segments of a long clip, frames
        ``[B, S_total, C, T, H, W]`` -> features ``[B, S_total, t, D]``;
        chunks then index these instead of encoding overlapping windows.
        ``chunk_size`` runs the encoder over sequential batch slices. Given
        ``vis_feats_segments`` are returned as they are. As in the JAX
        package (``vaura.py:935-976``), the bridge is not applied here."""
        if vis_feats_segments is not None:
            return vis_feats_segments.to(self.device)
        if self.encoder is None or frames is None:
            raise ValueError("long generation needs frames and an encoder, "
                             "or vis_feats_segments")
        frames = frames.to(self.device)
        B = frames.shape[0]
        if chunk_size and B > chunk_size:
            c = _largest_divisor(B, chunk_size)
            return torch.cat([self._encoder_chunk(frames[i:i + c])
                              for i in range(0, B, c)])
        return self._encoder_chunk(frames)

    @staticmethod
    def long_chunk_schedule(total_tokens: int, stride_tokens: int,
                            model_max_tokens: int) -> list:
        """The NEW tokens each chunk of ``generate_long`` produces, computed
        before any model work (the streaming path's last chunk, a client's
        increment sizes). ``sum == total_tokens``."""
        sizes = []
        prompt_len = current = 0
        while current + prompt_len < total_tokens:
            n = min(total_tokens - current, model_max_tokens)
            sizes.append(n - prompt_len)
            prompt_len = max(0, n - stride_tokens)
            current += stride_tokens
        assert sum(sizes) == total_tokens
        return sizes

    def _long_chunk_tokens(self, generator: torch.Generator,
                           vis_feats_segments: torch.Tensor, *,
                           total_tokens: int, stride_tokens: int,
                           model_max_tokens: int, vfps: float,
                           frames_per_segment: int, tokens_per_frame: int,
                           decode_buckets: int, sampling: dict):
        """Generator over the chunks of ``generate_long``: yields each
        chunk's NEW tokens ``[B, K, n_new]`` (the carried prompt stripped).
        A chunk generates at most ``model_max_tokens`` over the video
        segments its time span covers (modulo the video's length) and keeps
        its last ``chunk - stride`` tokens as the next chunk's prompt
        (reference ``scripts/generate.py:327-370``); the sizes are
        ``long_chunk_schedule``'s."""
        frame_rate = 86  # codec tokens per second
        B, S_total, t_seg, D = vis_feats_segments.shape
        sampling = dict(sampling)
        check = bool(sampling.pop("check", False))
        prompt: Optional[torch.Tensor] = None
        sizes = self.long_chunk_schedule(total_tokens, stride_tokens,
                                         model_max_tokens)
        for i, n_new in enumerate(sizes):
            time_offset = i * stride_tokens / frame_rate
            n_chunk = n_new + (0 if prompt is None else prompt.shape[-1])
            first_frame = math.ceil(time_offset * vfps)
            n_frames = math.ceil(n_chunk / frame_rate * vfps)
            seg_lo = first_frame // frames_per_segment
            seg_hi = (first_frame + n_frames) // frames_per_segment
            segs = np.arange(seg_lo, max(seg_hi, seg_lo + 1)) % S_total
            sel = vis_feats_segments[:, torch.as_tensor(segs)].reshape(
                B, len(segs) * t_seg, D)
            codes = self.generate(
                None, generator=generator, vis_feats=sel,
                audio_prompt_codes=prompt, max_new_tokens=n_chunk,
                tokens_per_frame=tokens_per_frame, decode_to_audio=False,
                decode_buckets=decode_buckets, **sampling)["codes"]
            if check:
                assert int(codes.min()) >= 0
                assert int(codes.max()) <= self.special_token_id
                if prompt is not None:
                    assert torch.equal(codes[..., :prompt.shape[-1]], prompt)
            new = codes if prompt is None else codes[:, :, prompt.shape[-1]:]
            assert new.shape[-1] == n_new  # schedule <-> generate contract
            yield new
            prompt = codes[:, :, stride_tokens:]

    @torch.no_grad()
    @_gathers_weights
    @_merges_lora
    def generate_long(
        self,
        frames: Optional[torch.Tensor] = None,   # [B, S_total, C, T, H, W]
        *,
        generator: Optional[torch.Generator] = None,
        seed: int = 0,
        total_tokens: int,
        stride_tokens: int,
        model_max_tokens: int = 221,
        vfps: float = 25.0,
        frames_per_segment: int = 16,
        tokens_per_frame: int = 7,
        vis_feats_segments: Optional[torch.Tensor] = None,  # [B, S_total, t, D]
        decode_to_audio: bool = True,
        dac_chunk_size: Optional[int] = None,
        encoder_chunk_size: Optional[int] = None,
        decode_buckets: int = 2,
        gather: Optional[str] = None,
        **sampling,
    ) -> Dict[str, object]:
        """Long generation in chunks with the prompt carried over (see
        ``_long_chunk_tokens``): ``{"codes" [B, K, total_tokens], "audio",
        "stage_ms"}``. The encoder runs once over all segments. Every chunk
        after the first ingests its prompt with ``Sampler.prefill``.
        ``sampling``: ``generate``'s sampling keywords and ``check``;
        ``gather`` as ``generate``'s."""
        clock = StageClock(self.device)
        clock.mark("start")
        generator = self._generator(generator, seed)
        feats = self._long_encode_segments(frames, vis_feats_segments,
                                           encoder_chunk_size)
        clock.mark("encoder")
        codes = torch.cat(list(self._long_chunk_tokens(
            generator, feats, total_tokens=total_tokens,
            stride_tokens=stride_tokens, model_max_tokens=model_max_tokens,
            vfps=vfps, frames_per_segment=frames_per_segment,
            tokens_per_frame=tokens_per_frame, decode_buckets=decode_buckets,
            sampling=sampling)), dim=-1)[..., :total_tokens]
        clock.mark("decode_loop")
        result: Dict[str, object] = {"codes": codes}
        if decode_to_audio:
            result["audio"] = self.decode_audio(codes, chunk_size=dac_chunk_size)
            clock.mark("dac")
        result["stage_ms"] = clock.ms()
        return self._gather_result(result, gather)

    def _longkv_setup(self, frames, vis_feats_segments, *, total_tokens: int,
                      tokens_per_frame: int,
                      encoder_chunk_size: Optional[int], cfg_scale: float):
        """What both rolling-cache paths start from: the features of all
        segments, laid out over the whole horizon (segments wrap modulo the
        video's length), the conditioning and the UNKNOWN sequence to fill.
        Returns ``(pattern, valid_mask, S, cond_seq, gen_seq)``."""
        if self.sampler_config.deepseek:
            raise NotImplementedError(
                "the rolling cache with the DeepSeek-V3 block: its latent "
                "cache keeps every row")
        K = self.num_codebooks
        pattern, valid_mask, S = self.prepare_generation(total_tokens)
        if self.sampler_config.block_size < S:
            raise ValueError(
                f"generate_long_kv: horizon needs {S} RoPE positions but "
                f"sampler block_size is {self.sampler_config.block_size} "
                "— raise SamplerConfig.block_size_audio")
        feats = self._long_encode_segments(frames, vis_feats_segments,
                                           encoder_chunk_size)
        with span("decode_setup"):
            B, S_total, t_seg, D = feats.shape
            n_feat = -(-S // tokens_per_frame)
            n_seg = -(-n_feat // t_seg)
            segs = torch.as_tensor(np.arange(n_seg) % S_total)
            vis_all = feats[:, segs].reshape(B, n_seg * t_seg, D)
            cond_seq = self.build_cond_seq_for_generation(
                vis_all, S, tokens_per_frame, cfg=cfg_scale > 1.0)
            gen_codes = torch.full((B, K, total_tokens), UNKNOWN_TOKEN,
                                   dtype=torch.long, device=self.device)
            gen_seq, _, _ = pattern.build_pattern_sequence(
                gen_codes, self.special_token_id)
        return pattern, valid_mask, S, cond_seq, gen_seq

    @staticmethod
    def rolling_cache_plan(S: int, chunk_steps: int, window_chunks: int,
                           sink_chunks: int):
        """The chunks of ``_stream_kv_segments``: ``(eff, bounds, kept)``
        with ``eff[j]`` the step that ends segment ``j``, chunk ``j`` the
        positions ``bounds[j] .. bounds[j + 1] - 1`` (the ones segment ``j``
        writes), and ``kept[j]`` the chunks segment ``j`` attends: the
        ``sink_chunks`` first and the last ``window_chunks`` others up to
        ``j``, in order. A chunk that leaves the window never returns."""
        C = int(chunk_steps)
        if C % 8 or window_chunks < 1:
            raise ValueError("chunk_steps must be a multiple of 8 and "
                             "window_chunks at least 1")
        eff = list(range(C, S, C)) + [S]
        bounds = [0] + [h - 1 for h in eff[:-1]] + [S]
        kept_per_seg, kept = [], []
        for j in range(len(eff)):
            kept = kept + [j]
            sink = [i for i in kept if i < sink_chunks]
            roll = [i for i in kept if i >= sink_chunks][-window_chunks:]
            kept = sink + roll
            kept_per_seg.append(kept)
        return eff, bounds, kept_per_seg

    @torch.no_grad()
    def _stream_kv_segments(
        self,
        cond_seq: torch.Tensor,
        gen_seq_init: torch.Tensor,
        generator: Optional[torch.Generator],
        *,
        S: int,
        valid_mask: np.ndarray,
        window_chunks: int = 4,
        chunk_steps: int = 56,
        sink_chunks: int = 0,
        cache_dtype: Optional[torch.dtype] = None,
        use_sampling: bool = True,
        temp: float = 1.0,
        top_k: int = 256,
        top_p: float = 0.0,
        cfg_scale: float = 1.0,
    ):
        """Generator behind ``generate_tokens_streaming``: yields ``(hi,
        gen_seq)`` after each segment, positions ``[0, hi)`` of ``gen_seq``
        final (it is the one buffer the loop fills: consume it before
        resuming).

        Under ``int8_dots`` the kept chunks' first buffer rows are the
        cache's ``chunk_starts`` for the segment (padded with the buffer's
        length, empty groups, to the most chunks any segment keeps), as the
        JAX package quantizes the probabilities per kept chunk.

        The segments and the chunks each attends are
        ``rolling_cache_plan``'s, as in the JAX package (JAX
        ``vaura.py:555-711``), which carries a tuple of chunk buffers and
        drops a chunk by not carrying it. Here the kept chunks lie packed,
        in order, in ONE buffer of as many rows as the most any segment
        keeps: when a chunk leaves the window, the chunks after it move
        down by its size in one copy (at most ``window_chunks *
        chunk_steps`` rows a segment), and the new chunk takes the rows
        after them. A step then attends every buffer row below its own, the
        one bound the decode-attention kernel knows. Positions stay GLOBAL:
        a step's RoPE row and conditioning are those of its position,
        ``row`` (its buffer row) is what the step writes and bounds
        attention with; RoPE scores depend only on position differences, so
        K/V keep their rows' values when they move. A segment's steps run
        eagerly in ``_device_loop``, their buffer rows their positions less
        one constant (``row_shift``)."""
        eff, bounds, kept_per_seg = self.rolling_cache_plan(
            S, chunk_steps, window_chunks, sink_chunks)
        size = lambda i: bounds[i + 1] - bounds[i]
        rows = max(sum(size(i) for i in kept) for kept in kept_per_seg)
        cache = self.sampler.init_cache(cond_seq.shape[0], rows,
                                        dtype=cache_dtype)
        buffers = [cache[n] for n in self.sampler.cache_names]
        n_groups = max(len(kept) for kept in kept_per_seg)
        gen_seq = gen_seq_init.clone()
        vm = torch.as_tensor(valid_mask, device=gen_seq.device)
        offset: Dict[int, int] = {}  # chunk -> its first buffer row
        lo = 1
        for j, hi in enumerate(eff):
            carried, packed = kept_per_seg[j][:-1], {}
            for i in carried:
                packed[i] = sum(size(c) for c in packed)
            moved = [i for i in carried if offset[i] != packed[i]]
            if moved:  # the chunks after the dropped one, contiguous
                src, dst = offset[moved[0]], packed[moved[0]]
                n = sum(size(i) for i in moved)
                for t in buffers:
                    t[:, :, dst:dst + n] = t[:, :, src:src + n].clone()
            offset = dict(packed)
            offset[j] = sum(size(i) for i in carried)
            if self._quantizes_probs():
                starts = [offset[i] for i in kept_per_seg[j]]
                cache["chunk_starts"] = torch.tensor(
                    starts + [rows] * (n_groups - len(starts)),
                    dtype=torch.int32, device=cache["k"].device)
            self._device_loop(
                cache, gen_seq, cond_seq, vm, generator, range(lo, hi),
                graph=False, row_shift=offset[j] - bounds[j],
                use_sampling=use_sampling, temp=temp, top_k=top_k,
                top_p=top_p, cfg_scale=cfg_scale)
            lo = hi
            yield hi, gen_seq

    @torch.no_grad()
    def generate_tokens_streaming(
        self,
        cond_seq: torch.Tensor,
        gen_seq_init: torch.Tensor,
        generator: Optional[torch.Generator],
        *,
        S: int,
        valid_mask: np.ndarray,
        window_chunks: int = 4,
        chunk_steps: int = 56,
        sink_chunks: int = 0,
        cache_dtype: Optional[torch.dtype] = None,
        use_sampling: bool = True,
        temp: float = 1.0,
        top_k: int = 256,
        top_p: float = 0.0,
        cfg_scale: float = 1.0,
    ) -> torch.Tensor:
        """One continuous decode over all ``S`` steps with the rolling cache
        of ``_stream_kv_segments``: a step attends the ``sink_chunks``
        first chunks and the last ``window_chunks`` chunks of
        ``chunk_steps`` steps (its own included). With ``window_chunks *
        chunk_steps >= S`` no chunk drops and the tokens are
        ``generate_tokens``'s. Returns the completed ``[B, K, S]``
        sequence."""
        out = gen_seq_init
        for _, out in self._stream_kv_segments(
                cond_seq, gen_seq_init, generator, S=S,
                valid_mask=valid_mask, window_chunks=window_chunks,
                chunk_steps=chunk_steps, sink_chunks=sink_chunks,
                cache_dtype=cache_dtype, use_sampling=use_sampling,
                temp=temp, top_k=top_k, top_p=top_p, cfg_scale=cfg_scale):
            pass
        return out

    @torch.no_grad()
    @_gathers_weights
    @_merges_lora
    def generate_long_kv(
        self,
        frames: Optional[torch.Tensor] = None,   # [B, S_total, C, T, H, W]
        *,
        generator: Optional[torch.Generator] = None,
        seed: int = 0,
        total_tokens: int,
        vfps: float = 25.0,
        frames_per_segment: int = 16,
        tokens_per_frame: int = 7,
        vis_feats_segments: Optional[torch.Tensor] = None,  # [B, S_total, t, D]
        window_chunks: int = 4,
        chunk_steps: int = 56,
        sink_chunks: int = 0,
        decode_to_audio: bool = True,
        dac_chunk_size: Optional[int] = None,
        encoder_chunk_size: Optional[int] = None,
        check: bool = False,
        gather: Optional[str] = None,
        **sampling,
    ) -> Dict[str, object]:
        """Long generation as ONE decode over the whole horizon with the
        rolling cache of ``generate_tokens_streaming``: no prompt is
        ingested twice. ``{"codes" [B, K, total_tokens], "audio",
        "stage_ms"}``. The RoPE table must cover the horizon
        (``block_size >= S``, else ``ValueError``). With ``window_chunks *
        chunk_steps >= S`` the tokens are ``generate(max_new_tokens=
        total_tokens)``'s; with a smaller window every position's K/V keep
        the history they were computed with (JAX ``vaura.py:1151-1233``).
        ``gather`` as ``generate``'s."""
        clock = StageClock(self.device)
        clock.mark("start")
        generator = self._generator(generator, seed)
        pattern, valid_mask, S, cond_seq, gen_seq = self._longkv_setup(
            frames, vis_feats_segments, total_tokens=total_tokens,
            tokens_per_frame=tokens_per_frame,
            encoder_chunk_size=encoder_chunk_size,
            cfg_scale=float(sampling.get("cfg_scale", 1.0)))
        clock.mark("encoder")
        gen_seq = self.generate_tokens_streaming(
            cond_seq, gen_seq, generator, S=S, valid_mask=valid_mask,
            window_chunks=window_chunks, chunk_steps=chunk_steps,
            sink_chunks=sink_chunks, **sampling)
        with span("decode_revert"):
            codes, _, _ = pattern.revert_pattern_sequence(gen_seq,
                                                          UNKNOWN_TOKEN)
            codes = codes[..., :total_tokens]
            if check:
                assert int(codes.min()) >= 0
                assert int(codes.max()) <= self.special_token_id
        clock.mark("decode_loop")
        result: Dict[str, object] = {"codes": codes}
        if decode_to_audio:
            result["audio"] = self.decode_audio(codes, chunk_size=dac_chunk_size)
            clock.mark("dac")
        result["stage_ms"] = clock.ms()
        return self._gather_result(result, gather)

    def _emit(self, codes: torch.Tensor, emitted: int, n_known: int,
              final: bool, margin: int):
        """The waveform increment once ``n_known`` timesteps of ``codes``
        are final: samples of timesteps ``emitted .. emit_to`` (up to
        ``margin`` short of ``n_known`` until the final call), cut from a
        DAC decode of a window with ``margin`` timesteps of context on each
        side, whose interior equals the full decode's. Returns ``(audio
        [B, samples], emit_to)``."""
        hop = self.dac.cfg.hop_length
        emit_to = n_known if final else max(emitted, n_known - margin)
        if emit_to <= emitted:  # the margin still holds back all that is known
            return codes.new_zeros((codes.shape[0], 0), dtype=torch.float32), emitted
        win_lo = max(0, emitted - margin)
        wav = self.decode_audio(codes[..., win_lo:n_known])
        audio = wav[..., (emitted - win_lo) * hop:(emit_to - win_lo) * hop]
        return audio.reshape(wav.shape[0], -1), emit_to

    @torch.no_grad()
    @_gathers_weights
    @_merges_lora
    def generate_long_kv_stream(
        self,
        frames: Optional[torch.Tensor] = None,   # [B, S_total, C, T, H, W]
        *,
        generator: Optional[torch.Generator] = None,
        seed: int = 0,
        total_tokens: int,
        vfps: float = 25.0,
        frames_per_segment: int = 16,
        tokens_per_frame: int = 7,
        vis_feats_segments: Optional[torch.Tensor] = None,
        window_chunks: int = 4,
        chunk_steps: int = 56,
        sink_chunks: int = 0,
        emit_margin_tokens: Optional[int] = None,
        encoder_chunk_size: Optional[int] = None,
        **sampling,
    ):
        """``generate_long_kv`` as a generator of one dict per segment that
        made timesteps final: ``{"codes" [B, K, n_new], "audio" [B,
        n_emit * hop], "token_start"}``, ``token_start`` the timestep of
        ``audio[..., 0]``. Codes are ``generate_long_kv``'s under the same
        generator, and the audio increments concatenate to its waveform
        (``emit_margin_tokens``, by default the decoder's receptive field,
        of context on each side of a windowed decode). A timestep is final
        once every codebook's slot of it lies below the segment's end, so
        emission trails the decode by the pattern's largest delay and the
        margin (JAX ``vaura.py:1235-1349``)."""
        generator = self._generator(generator, seed)
        pattern, valid_mask, S, cond_seq, gen_seq = self._longkv_setup(
            frames, vis_feats_segments, total_tokens=total_tokens,
            tokens_per_frame=tokens_per_frame,
            encoder_chunk_size=encoder_chunk_size,
            cfg_scale=float(sampling.get("cfg_scale", 1.0)))
        if emit_margin_tokens is None:
            emit_margin_tokens = self.dac.cfg.decoder_receptive_field_frames
        # timestep t is final once the steps up to known_bar[t] have run
        last_step = np.zeros(total_tokens, dtype=np.int64)
        for s, coords in enumerate(pattern.layout):
            for t, _ in coords:
                if t < total_tokens:
                    last_step[t] = max(last_step[t], s)
        known_bar = np.maximum.accumulate(last_step) + 1
        emitted = n_prev = 0
        for hi, seq in self._stream_kv_segments(
                cond_seq, gen_seq, generator, S=S, valid_mask=valid_mask,
                window_chunks=window_chunks, chunk_steps=chunk_steps,
                sink_chunks=sink_chunks, **sampling):
            final = hi >= S
            n_known = (total_tokens if final else
                       min(int(np.searchsorted(known_bar, hi, side="right")),
                           total_tokens))
            if n_known <= n_prev and not final:
                continue  # the segment made no timestep final
            codes, _, _ = pattern.revert_pattern_sequence(seq, UNKNOWN_TOKEN)
            codes = codes[..., :total_tokens]
            audio, emit_to = self._emit(codes, emitted, n_known, final,
                                        emit_margin_tokens)
            yield {"codes": codes[..., n_prev:n_known], "audio": audio,
                   "token_start": emitted}
            emitted, n_prev = emit_to, n_known

    @torch.no_grad()
    @_gathers_weights
    @_merges_lora
    def generate_long_stream(
        self,
        frames: Optional[torch.Tensor] = None,   # [B, S_total, C, T, H, W]
        *,
        generator: Optional[torch.Generator] = None,
        seed: int = 0,
        total_tokens: int,
        stride_tokens: int,
        model_max_tokens: int = 221,
        vfps: float = 25.0,
        frames_per_segment: int = 16,
        tokens_per_frame: int = 7,
        vis_feats_segments: Optional[torch.Tensor] = None,
        emit_margin_tokens: Optional[int] = None,
        encoder_chunk_size: Optional[int] = None,
        decode_buckets: int = 2,
        **sampling,
    ):
        """``generate_long`` as a generator of one dict per chunk, as soon
        as its tokens exist: ``{"codes" [B, K, n_new], "audio" [B,
        n_emit * hop], "token_start"}``. Codes are ``generate_long``'s
        under the same generator and the audio increments concatenate to
        its waveform (see ``generate_long_kv_stream``); the last chunk
        flushes the margin held back (JAX ``vaura.py:1351-1443``)."""
        generator = self._generator(generator, seed)
        feats = self._long_encode_segments(frames, vis_feats_segments,
                                           encoder_chunk_size)
        if emit_margin_tokens is None:
            emit_margin_tokens = self.dac.cfg.decoder_receptive_field_frames
        n_chunks = len(self.long_chunk_schedule(total_tokens, stride_tokens,
                                                model_max_tokens))
        codes: Optional[torch.Tensor] = None
        emitted = 0
        for i, new in enumerate(self._long_chunk_tokens(
                generator, feats, total_tokens=total_tokens,
                stride_tokens=stride_tokens, model_max_tokens=model_max_tokens,
                vfps=vfps, frames_per_segment=frames_per_segment,
                tokens_per_frame=tokens_per_frame,
                decode_buckets=decode_buckets, sampling=sampling)):
            codes = new if codes is None else torch.cat([codes, new], dim=-1)
            audio, emit_to = self._emit(codes, emitted, codes.shape[-1],
                                        i == n_chunks - 1, emit_margin_tokens)
            yield {"codes": new, "audio": audio, "token_start": emitted}
            emitted = emit_to
