"""Batched generation server, on one card or one process per card.

Counterpart of ``scripts/serve.py``, feature for feature: a micro-batching
queue in front of ``VauraSystem.generate`` (requests are padded to the
smallest batch bucket that fits and answered individually), long-horizon
streams, hot reload, drain, Prometheus metrics and a plain-HTTP surface.

Endpoints::

    GET  /healthz            -> {"status": "ok"|"draining", "batch": B,
                                 "mesh": {"data", "fsdp", "model"} | null,
                                 "device": "cuda"|"cpu", ...}
    GET  /metrics            -> Prometheus counters (requests, batches,
                                fill ratio, latency avg, inflight, mesh)
    POST /generate           body: {"features": [[...cond_dim floats...] x Tv]}
                             or    {"video_b64": "<base64 mp4>"}
                             or    .npy bytes [Tv, cond_dim] as
                                   application/octet-stream
                             -> WAV bytes (audio/wav)
    POST /generate?raw=codes -> JSON {"codes": [[...]]} (token output)
    POST /generate_long      body: {"features_segments": [[...] x t] x S}
                             or .npy bytes [S, t, cond_dim]
                             -> live WAV stream (an increment written as
                                each chunk decodes; stream_mode=kv decodes
                                the horizon once with a rolling KV cache)
    POST /reload             body: {"ckpt_path": "..."} (optional; defaults
                             to the startup checkpoint) -> swap the serving
                             weights; a reload that fails the int8 gate
                             keeps the current weights serving

Usage::

    python -m vaura_tpu_torch config=CONFIG.yaml action=serve
        [experiment_path=...] [ckpt_path=...] [port=8800] [batch=8]
        [batch_buckets=1,4] [duration=2.56] [quantize=cache|true]
        [stream_mode=reprefill|kv] [aot_export=PATH | aot_load=PATH]
        [trainer.platform=cpu]
    torchrun --nproc_per_node=N -m vaura_tpu_torch config=... action=serve
        [mesh_serving=true] [trainer.mesh.fsdp=1] [trainer.mesh.model=1]

The server runs on ``cuda`` unless ``trainer.platform=cpu``.
``aot_export=PATH`` writes the generation pipeline as exported graphs after
the warm-up (``utils/aot.py``: ``torch.export``, the weights outside them);
``aot_load=PATH`` answers every batch from such an artifact with the
served weights and the batch's seed, the codes of the eager path. An
artifact whose ``batch``, ``tv``, ``cond_dim`` or sampling differs from the
server's, or one traced for another device type, is refused with
``ValueError``, as are ``batch_buckets`` and a serving mesh with either key
(JAX ``scripts/serve.py:346-350,386-416``).
``compilation_cache_dir`` is logged and ignored; ``decode_buckets`` (8 by
default) matters only under ``int8_dots``, whose probabilities are quantized
per chunk (``VauraSystem.generate_tokens``). A LoRA
experiment serves its adapters merged into its base (the run's ``frozen/``
save, else its ``finetune.init_from``:
``scripts/generate.py::load_lora_base_``); a reload
swaps in new adapters; ``quantize=true`` raises ``ValueError`` with LoRA
(the adapters cannot be merged into int8 weights; ``quantize=cache`` can).

**Several processes** (one per card, started by ``torchrun``; the JAX
server's multi-device path, ``scripts/serve.py:309-355``): with
``mesh_serving`` (the default) and a ``batch`` that the run's processes
divide, the ranks serve over a ``(data, fsdp, model)`` mesh of
``trainer.mesh`` (JAX's defaults ``data=-1, fsdp=1, model=1``), the system
placed by ``shard_module(..., train=False)``: at ``fsdp = model = 1`` every
rank holds the whole weights, as JAX's specs leave every leaf whole there,
and nothing is gathered per batch. Every ``batch_buckets`` entry must be
divisible by ``data * fsdp`` (``ValueError``). Rank 0 is the leader: it
runs the HTTP server, the queue and the micro-batch worker; the others are
followers and open no port. For each job the worker sends one header on
the control channel (``parallel.multihost.ControlChannel``: ``batch``,
``stream``, ``features``, ``reload``, ``shutdown``, and a no-op heartbeat
when no header went out for ``HEARTBEAT_S``), then the job's tensors, then
every rank runs the job: a batch on each rank's rows, gathered to rank 0; a
stream (B=1) replicated (``VauraSystem.replicated``: every rank the whole
batch and the one-process draws), a clip's encoder pass on every rank; a
reload on every rank, swapped only when every rank's load and int8 gate
succeeded (``ControlChannel.all_ok``), so a refused reload keeps the old
weights on every rank. Only the worker thread
issues collectives: a clip's encoder pass and a reload are jobs on its
queue, which the HTTP handler waits for. A failure after a header went out
stops the server: rank 0 answers the job's requests with 500, drains the
queue and exits non-zero (``torchrun`` then ends the rest); a follower that
raises exits non-zero. SIGTERM drains rank 0, whose ``shutdown`` header
ends the followers (they log the signal and wait for it); every rank exits
0. Without ``mesh_serving``, or with a ``batch`` the processes do not
divide, rank 0 serves on its card alone and the others wait for its
``shutdown`` (JAX's branch without a mesh; logged).

Differences from the JAX server that come from eager PyTorch:

* ``_dispatch`` runs the host-bound eager decode loop to its end, so it
  is synchronous, not asynchronous as in JAX. The worker collects, then
  dispatches and fetches each batch in turn (``_fetch`` copies the results
  to the host and replies). Requests that arrive while a batch computes
  wait in the queue, so the next collection fills at once.
* The weights live in modules. ``reload`` loads a checkpoint into NEW
  sampler (and bridge / unfrozen encoder) modules, quantizes them and runs
  the int8 gate there, then swaps in a new view of the system that holds
  them (``_with_modules``). The worker reads ``self.system`` once per batch
  and per stream, so a batch never mixes weights and the running one
  finishes on the old modules, as JAX's ``self.params = params``.
* ``torch.no_grad`` is per thread: the worker enters it, and so does
  each HTTP handler thread that runs the encoder (``video_to_features``)
  in one process.
* Sampling draws from ``torch.Generator(device).manual_seed(seed)`` where
  JAX uses ``PRNGKey(seed)``, with the same seed sequence.
"""

from __future__ import annotations

import base64
import copy
import dataclasses
import io
import json
import logging
import os
import queue
import signal
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from vaura_tpu_torch.models.factory import build_system, maybe_load_pretrained
from vaura_tpu_torch.models.sampler import Sampler
from vaura_tpu_torch.ops.audio import pcm16, wav_stream_header, write_wav
from vaura_tpu_torch.ops.quantization import quantize_sampler_params
from vaura_tpu_torch.parallel import multihost
from vaura_tpu_torch.scripts.generate import (
    LORA_INT8,
    REPO_ROOT,
    _replace_sampler,
    _round_params_to_bf16_,
    config_device,
    load_lora_base_,
)
from vaura_tpu_torch.train.checkpoint import (
    load_trainable_,
    restore_trainable_params,
)
from vaura_tpu_torch.train.steps import split_params
from vaura_tpu_torch.utils import seeded_init_
from vaura_tpu_torch.utils.experiment import (
    load_hparams,
    resolve_best_checkpoint,
    resolve_experiment_paths,
)

logger = logging.getLogger("serve")

FRAMES_PER_SEGMENT = 16  # the divided_224_16x4 contract


class DrainingError(RuntimeError):
    """Raised for requests arriving after shutdown began (HTTP 503)."""


class ServerFailed(RuntimeError):
    """A job failed on a mesh and stopped the server (HTTP 500)."""


class ReloadRefused(RuntimeError):
    """A reload that failed to load or quantize, or the int8 gate refused,
    on this rank or another one: every rank keeps its weights serving."""


def _parse_batch_buckets(buckets, batch: int) -> list[int]:
    """Normalize the batch_buckets knob to a sorted list ending in batch.

    Accepts a comma string ("1,4"), a YAML list, or a bare int (the CLI
    overlay coerces "batch_buckets=1" to int). The full batch is always
    included as the largest bucket.
    """
    if not buckets:
        return [batch]
    if isinstance(buckets, str):
        buckets = [int(b) for b in buckets.split(",") if b.strip()]
    elif isinstance(buckets, int):
        buckets = [buckets]
    out = sorted({int(b) for b in buckets} | {batch})
    if out[-1] != batch or out[0] < 1:
        raise ValueError(
            f"batch_buckets {out} must be within [1, batch={batch}]"
        )
    return out


def _with_modules(system, **modules):
    """A view of ``system`` that runs ``modules`` (for example a new
    ``sampler``) in place of its own and shares every other submodule; the
    original is left as it is."""
    view = copy.copy(system)
    view._modules = dict(system._modules)
    for name, module in modules.items():
        setattr(view, name, module)
    if "sampler" in modules:
        view.sampler_config = modules["sampler"].cfg
    return view


def _serving_mesh(cfg: dict, batch: int, buckets: list, device_type: str):
    """The ``(data, fsdp, model)`` mesh the ranks of a launched run serve
    on (JAX ``scripts/serve.py:316-341``), or None: one process without a
    launcher, ``mesh_serving=false``, or a ``batch`` the run's processes do
    not divide (rank 0 then serves alone)."""
    from vaura_tpu_torch.parallel.mesh import make_mesh, mesh_shape

    world = multihost.process_count()
    if not multihost.launched():
        return None
    if not bool(cfg.get("mesh_serving", True)) or batch % world:
        if world > 1:
            why = ("mesh_serving=false"
                   if not bool(cfg.get("mesh_serving", True))
                   else f"batch {batch} not divisible by {world} processes")
            logger.warning("%s: serving on rank 0's card alone; the other "
                           "%d ranks wait for its shutdown", why, world - 1)
        return None
    axes = dict((cfg.get("trainer") or {}).get("mesh") or {})
    shape = mesh_shape(world, int(axes.get("data", -1)),
                       int(axes.get("fsdp", 1)), int(axes.get("model", 1)))
    rows = shape[0] * shape[1]
    bad = [b for b in buckets if b % rows]
    if bad:
        raise ValueError(
            f"batch_buckets {bad} not divisible by data*fsdp={rows} of the "
            f"serving mesh {shape}; every bucket must shard evenly (or set "
            "mesh_serving=false)")
    return make_mesh(*shape, device_type=device_type)


class GenerationService:
    """Owns the served system and the micro-batching queue; under several
    processes one rank's part of them (``leader``: rank 0)."""

    def __init__(self, cfg: dict):
        cache_dir = cfg.get("compilation_cache_dir") or (
            cfg.get("trainer") or {}
        ).get("compilation_cache_dir")
        if cache_dir:
            logger.info("compilation_cache_dir=%s ignored: nothing is "
                        "compiled (the CUDA kernels build once into the "
                        "package's _build/)", cache_dir)
        self.device = config_device(cfg)

        self.batch = int(cfg.get("batch", 8))
        # smaller batch sizes a micro-batch pads to instead of the full
        # batch (a lone request need not pay for a full-batch decode)
        self.batch_buckets = _parse_batch_buckets(
            cfg.get("batch_buckets"), self.batch
        )
        self.duration = float(cfg.get("duration", 2.56))
        self.tokens = int(self.duration * 86)
        # fixed conditioning length: every request is padded to this many
        # feature rows (25 fps, 16-frame segments, 8 features a segment;
        # 2.56 s -> 32)
        self.tv = max(1, int(self.duration * 25.0) // 16) * 8
        self.max_wait_s = float(cfg.get("max_wait_ms", 20)) / 1e3
        # accepted for config compatibility; no effect (generate_tokens)
        self.decode_buckets = int(cfg.get("decode_buckets", 8))
        self.dac_chunk_size = int(
            cfg.get("dac_chunk_size")
            or max(1, int(8 * 2.56 / self.duration * 4))
        )
        # long-horizon streaming (/generate_long): fixed stream geometry
        self.stream_tokens = int(
            cfg.get("stream_tokens")
            or float(cfg.get("stream_duration", 10.24)) * 86
        )
        self.stream_stride_tokens = int(
            cfg.get("stream_stride_tokens")
            or float(cfg.get("stream_stride", 0.64)) * 86
        )
        self.stream_max_tokens = int(cfg.get("stream_max_tokens", 221))
        # the video segments must cover the generated seconds, also when
        # only stream_tokens is given
        stream_secs = float(
            cfg.get("stream_duration") or self.stream_tokens / 86.0
        )
        self.stream_segments = max(1, int(stream_secs * 25.0) // 16)
        self.stream_t = int(cfg.get("stream_features_per_segment", 8))
        # /generate_long decode mode: "reprefill" (generate_long_stream) or
        # "kv" (generate_long_kv_stream: one decode, rolling KV cache)
        self.stream_mode = str(cfg.get("stream_mode", "reprefill")).lower()
        if self.stream_mode not in ("reprefill", "kv"):
            raise ValueError(f"unknown stream_mode: {self.stream_mode!r}")
        self.stream_window_chunks = int(cfg.get("stream_window_chunks", 4))
        self.stream_chunk_steps = int(cfg.get("stream_chunk_steps", 56))
        self.sampling = dict(
            use_sampling=bool(cfg.get("use_sampling", True)),
            temp=float(cfg.get("temperature", 1.0)),
            top_k=int(cfg.get("top_k", 128)),
            top_p=float(cfg.get("top_p", 0.0)),
            cfg_scale=float(cfg.get("cfg_scale", 6.0)),
        )

        # several processes: the mesh (or rank 0 alone) and the channel of
        # rank 0's jobs
        self.mesh = _serving_mesh(cfg, self.batch, self.batch_buckets,
                                  self.device.type)
        self.mesh_shape = (None if self.mesh is None else dict(zip(
            self.mesh.mesh_dim_names, self.mesh.mesh.shape)))
        # the exported serving graphs (utils/aot.py): ``aot_load`` answers
        # from an artifact, ``aot_export`` writes one after the warm-up
        self.aot_export = cfg.get("aot_export")
        self.aot_export_s = None  # the export's seconds, once written
        aot_load = cfg.get("aot_load")
        self._aot = None
        if self.mesh is not None and (self.aot_export or aot_load):
            raise ValueError(
                "aot_export/aot_load and mesh serving are mutually "
                "exclusive (exported artifacts are single-device); "
                "set mesh_serving=false to use AOT graphs"
            )
        if (self.aot_export or aot_load) and len(self.batch_buckets) > 1:
            raise ValueError(
                "batch_buckets and aot_export/aot_load are mutually "
                "exclusive (exported artifacts are single fixed-batch "
                "graphs); drop the buckets or the AOT flags"
            )
        self.leader = multihost.is_main_process()
        self.channel = None
        if self.mesh is not None or multihost.process_count() > 1:
            self.channel = multihost.ControlChannel(self.device)
        # every rank runs each job (a mesh); without one, rank 0 runs them
        # and sends the others only its heartbeats and its shutdown. A
        # follower's wait for a header lasts at most HEARTBEAT_S and the
        # longest job rank 0 runs alone (_take).
        self._last_header = time.monotonic()
        self.failed: Optional[BaseException] = None
        self.on_fatal = None  # called once when a job stops the server
        self.system = None
        if self.mesh is None and not self.leader:
            return  # rank 0 serves alone; this rank waits (follow)

        model_cfg = cfg.get("model")
        ckpt_path = cfg.get("ckpt_path")
        exp = cfg.get("experiment_path")
        if exp:
            paths = resolve_experiment_paths(exp)
            if paths["hparams"] is not None:
                model_cfg = load_hparams(paths["hparams"])["model"]
            if ckpt_path is None:
                best = resolve_best_checkpoint(paths["checkpoints"])
                ckpt_path = str(best) if best else None
        if model_cfg is None:
            # a generate config without a model section (as
            # configs/generate_vgg.yaml): the flagship defaults, as the
            # generate action takes them
            from vaura_tpu_torch.config import load_config

            model_cfg = load_config(
                REPO_ROOT / "configs" / "vaura_defaults.yaml", REPO_ROOT
            )["model"]
            logger.warning("no experiment_path/model config: serving the "
                           "flagship defaults")

        # bf16 storage of the matmul weights: generation only
        system = build_system(model_cfg, device=self.device,
                              param_dtype=torch.bfloat16)
        qmode = cfg.get("quantize")
        if system.lora_sampler is not None and qmode and qmode != "cache":
            raise ValueError(LORA_INT8)
        if self.stream_mode == "kv":
            # the rolling-KV decode runs over the whole stream horizon, so
            # the RoPE table must cover it (pattern delay + headroom)
            need = self.stream_tokens + 64
            if system.sampler_config.block_size < need:
                _replace_sampler(system, block_size_audio=need)
        seed = int(cfg.get("seed", 0))
        seeded_init_(system, torch.Generator(self.device).manual_seed(seed))
        maybe_load_pretrained(system, model_cfg)
        system.load_dac_embeddings_into_sampler()
        if system.lora_sampler is not None:
            load_lora_base_(system, cfg, ckpt_path)
        if ckpt_path:
            load_trainable_(system, ckpt_path, model_cfg, cfg.get("trainer"))
            logger.info("loaded %s", ckpt_path)
        else:
            logger.warning("serving RANDOM weights (no checkpoint given)")
        # hot-reload state (POST /reload): the names, shapes and dtypes of
        # the trainable leaves, and the configs that rebuild the optimizer
        # of a training checkpoint; the frozen modules (codec, a frozen
        # encoder) are shared by every swap
        trainable, _ = split_params(system)
        system.requires_grad_(False)
        self._trainable_like = {
            k: torch.empty_like(v, device="meta") for k, v in trainable.items()
        }
        self._model_cfg = model_cfg
        self._trainer_cfg = cfg.get("trainer")
        self.ckpt_path = str(ckpt_path) if ckpt_path else None
        _round_params_to_bf16_(system)
        # "cache": int8 KV cache with bf16 weights, a property of the
        # decode, not of the weights: reload does not quantize and the
        # teacher-forced gate does not apply
        self._quantize = bool(qmode) and qmode != "cache"
        self._quantize_min_agreement = 0.0
        if qmode == "cache":
            _replace_sampler(system, quantize_cache=True)
            logger.info("int8 KV cache with bf16 weights (quantize=cache)")
        elif self._quantize:
            fp_sampler = system.sampler
            _replace_sampler(system, quantize_weights=True,
                             quantize_cache=True)
            # quality gate: int8 must reproduce the bf16 argmax at the
            # loaded weights' own margins before it may serve
            min_agree = float(cfg.get("quantize_min_agreement", 0.0) or 0.0)
            self._quantize_min_agreement = min_agree
            if min_agree > 0.0:
                agree = self._int8_agreement_probe(
                    system, fp_sampler, system.sampler
                )
                msg = (
                    "int8 teacher-forced argmax agreement vs bf16: %.4f "
                    "(gate: %.2f)" % (agree, min_agree)
                )
                if agree < min_agree:
                    raise RuntimeError(
                        msg + " — refusing to serve int8 at these weights; "
                        "serve without quantize or lower "
                        "quantize_min_agreement"
                    )
                logger.info(msg)
            else:
                logger.info(
                    "int8 agreement gate disabled "
                    "(quantize_min_agreement=0); skipping probe"
                )
            del fp_sampler
        # the unplaced modules a reload copies where the placed ones are
        # FSDP2 modules, which do not copy
        self._templates = {}
        if self.mesh is not None:
            from vaura_tpu_torch.parallel import shard_module

            tops = {k.split(".", 1)[0] for k in trainable} - {"sampler"}
            if self.mesh.size(1) > 1:
                self._templates = {top: copy.deepcopy(getattr(system, top))
                                   .cpu() for top in tops}
            shard_module(system, self.mesh, train=False)
            logger.info("serving batch %d over %d processes (mesh %s)",
                        self.batch, multihost.process_count(),
                        self.mesh_shape)
        self.system = system
        self.cond_dim = system.sampler_config.cond_in_dim
        self.sample_rate = system.dac.cfg.sample_rate
        if aot_load:
            self._load_aot(aot_load)
        self._next_seed = seed
        self._q: "queue.Queue" = queue.Queue()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        # observability + graceful shutdown
        self._metrics_lock = threading.Lock()
        self._metrics = {
            "requests_total": 0,
            "stream_requests_total": 0,
            "batches_total": 0,
            "batch_slots_total": 0,
            "errors_total": 0,
            "reloads_total": 0,
            "batch_capacity_total": 0,
            "batch_seconds_sum": 0.0,
        }
        self._bucket_counts = {b: 0 for b in self.batch_buckets}
        self._reload_lock = threading.Lock()
        self._inflight = 0
        self._draining = False

    def _load_aot(self, path: str) -> None:
        """Answer every batch from the artifact at ``path``; its input
        contract and its sampling must be the server's."""
        from vaura_tpu_torch.utils.aot import load_generate

        fn, meta = load_generate(path, self.device)
        for key, want in (("batch", self.batch), ("tv", self.tv),
                          ("cond_dim", self.cond_dim)):
            got = meta.get(key)
            if got is not None and int(got) != int(want):
                raise ValueError(
                    f"aot_load artifact {key}={got} does not match "
                    f"server {key}={want} (re-export with this config)"
                )
        # sampling is BAKED into the exported graph: a mismatch would
        # silently serve the artifact's temperature/top_k/cfg, not the
        # configured ones
        baked = meta.get("sampling")
        mine = {k: str(v) for k, v in self.sampling.items()}
        if baked is not None and baked != mine:
            raise ValueError(
                f"aot_load artifact sampling {baked} does not match "
                f"server sampling {mine} (re-export, or start the "
                "server with the artifact's sampling config)"
            )
        self._aot = fn
        logger.info("loaded AOT generation graph %s (%s, %s)", path,
                    meta.get("device"), meta.get("device_name"))

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def _int8_agreement_probe(
        self, system, fp_sampler, q_sampler, batch: int = 2, tokens: int = 32
    ) -> float:
        """Teacher-forced argmax agreement between the bf16 and int8
        sampler at the loaded weights, on a fixed synthetic probe batch
        (two short forwards of ``VauraSystem.train_forward``; on this rank
        alone, the samplers unplaced)."""
        cfg_q = q_sampler.cfg
        rng = np.random.default_rng(0)
        codes = torch.as_tensor(rng.integers(
            0, cfg_q.d_codebook, size=(batch, cfg_q.num_codebooks, tokens)
        ), device=self.device)
        vis = torch.as_tensor(rng.standard_normal(
            (batch, 8, cfg_q.cond_in_dim)
        ).astype(np.float32), device=self.device)

        def logits_for(sampler):
            view = _with_modules(system, sampler=sampler)
            view.placement = None
            _, aux = view.train_forward(
                None, None, None, train=False, vis_feats=vis, codes=codes)
            return aux["logits"].float(), aux["mask"]

        lf, mask = logits_for(fp_sampler)
        lq, _ = logits_for(q_sampler)
        return float(
            (lf.argmax(-1)[mask] == lq.argmax(-1)[mask]).float().mean()
        )

    def reload(self, ckpt_path: Optional[str] = None) -> dict:
        """Swap the serving weights for a checkpoint's (POST /reload).

        Restores the trainable leaves into NEW modules on the device
        (sampler, bridge, an unfrozen encoder), shares the frozen ones,
        re-applies int8 quantization (re-running the agreement gate: a
        reload that fails it keeps the current weights serving), and swaps
        in a view of the system that holds them. The worker reads
        ``self.system`` once per batch, so in-flight batches finish on the
        old weights and the next batch uses the new ones. Under several
        processes the reload is a job of the worker (every rank reloads),
        which this call waits for.
        """
        path = str(ckpt_path or self.ckpt_path or "")
        if not path:
            raise ValueError(
                "no checkpoint to reload: pass ckpt_path (the server was "
                "started without one)"
            )
        if self.mesh is None:
            return self._reload(path)
        return self._run_in_worker({"job": "reload", "path": path})

    @torch.no_grad()
    def _load_modules(self, path: str):
        """New top modules holding the checkpoint's trainable leaves, whole
        and unplaced (int8-quantized behind the gate where the server
        quantizes); ``(modules, agreement or None)``."""
        restored = restore_trainable_params(
            path, self._trainable_like, self._model_cfg, self._trainer_cfg,
        )  # on the host, memory-mapped: copied once into the modules
        live = self.system
        modules, gate = {}, None
        for top in sorted({k.split(".", 1)[0] for k in restored}):
            if top == "sampler":
                module = Sampler(dataclasses.replace(
                    live.sampler_config, quantize_weights=False),
                    self.device)
            elif top in self._templates:
                module = copy.deepcopy(self._templates[top]).to(self.device)
            else:
                module = copy.deepcopy(getattr(live, top))
            for name, p in module.named_parameters():
                p.copy_(restored[f"{top}.{name}"])
            module.requires_grad_(False)
            _round_params_to_bf16_(module)
            modules[top] = module
        del restored
        if self._quantize:
            fp_sampler = modules["sampler"]
            q_sampler = Sampler(live.sampler_config, self.device)
            q_sampler.load_state_dict(
                quantize_sampler_params(fp_sampler.state_dict()))
            q_sampler.requires_grad_(False)
            modules["sampler"] = q_sampler
            if self._quantize_min_agreement > 0.0:
                gate = self._int8_agreement_probe(live, fp_sampler, q_sampler)
                if gate < self._quantize_min_agreement:
                    raise RuntimeError(
                        "reload refused: int8 agreement %.4f < gate "
                        "%.2f at %s — current weights keep serving"
                        % (gate, self._quantize_min_agreement, path)
                    )
        return modules, gate

    def _reload(self, path: str) -> dict:
        """The reload on this rank; under several processes every rank
        calls it for the same job, and the new modules are placed and
        swapped in only when every rank loaded them (all or nothing)."""
        with self._reload_lock:
            t0 = time.time()
            try:
                modules, gate = self._load_modules(path)
                error = None
            except Exception as e:  # every rank learns of it below
                modules, gate, error = None, None, e
            if self.mesh is not None and not self.channel.all_ok(
                    error is None):
                error = error or RuntimeError(
                    f"reload refused: {path} failed on another rank — "
                    "current weights keep serving")
            if error is not None:
                raise ReloadRefused(str(error)) from error
            live = self.system
            if live.placement is not None:
                from vaura_tpu_torch.parallel.partitioning import (
                    place_modules,
                )

                place_modules(live.placement, modules)
            self.system = _with_modules(live, **modules)  # the next batch
            self.ckpt_path = path
            with self._metrics_lock:
                self._metrics["reloads_total"] += 1
            dt = time.time() - t0
            logger.info("reloaded weights from %s (%.2fs)", path, dt)
            info = {"reloaded": True, "ckpt_path": path,
                    "seconds": round(dt, 3)}
            if gate is not None:
                info["int8_agreement"] = round(gate, 4)
            return info

    def start(self):
        """Warm up (every rank of a mesh, together) and, on the leader,
        start the micro-batch worker. A follower then calls ``follow``."""
        if self.system is not None:
            self._warmup()
        if self.aot_export and self.system is not None:
            from vaura_tpu_torch.utils.aot import export_generate

            t0 = time.time()
            meta = export_generate(
                self.system,
                batch=self.batch, tv=self.tv,
                max_new_tokens=self.tokens,
                sampling=self.sampling,
                decode_buckets=self.decode_buckets,
                dac_chunk_size=self.dac_chunk_size,
                path=self.aot_export,
            )
            self.aot_export_s = time.time() - t0
            logger.info("exported AOT generation graph to %s (%s, %.1fs)",
                        self.aot_export, meta["device_name"],
                        self.aot_export_s)
        if self.leader:
            self._worker.start()

    def _generate(self, feats: torch.Tensor, seed: int,
                  sampling: Optional[dict] = None) -> Optional[dict]:
        """One batch through ``VauraSystem.generate`` (``self.system`` read
        once): ``{"audio" [B, 1, samples], "codes" [B, K, tokens]}`` on the
        device. On a mesh every rank calls it with the whole padded batch,
        generates its rows, and rank 0 gets the whole batch (the others'
        values are None). With ``aot_load`` the loaded artifact answers,
        with the served weights and the same seed."""
        if self._aot is not None:
            from vaura_tpu_torch.utils.aot import serving_state

            audio, codes = self._aot(serving_state(self.system), feats, seed)
            return {"audio": audio, "codes": codes}
        kw = {}
        if self.mesh is not None:
            from vaura_tpu_torch.parallel.mesh import batch_rows

            feats = feats[batch_rows(self.mesh, feats.shape[0])]
            kw["gather"] = "main"
        out = self.system.generate(
            vis_feats=feats,
            generator=torch.Generator(self.device).manual_seed(int(seed)),
            max_new_tokens=self.tokens,
            tokens_per_frame=7,
            decode_to_audio=True,
            dac_chunk_size=self.dac_chunk_size,
            decode_buckets=self.decode_buckets,
            **(sampling or self.sampling),
            **kw,
        )
        return {"audio": out["audio"], "codes": out["codes"]}

    def _put_batch(self, feats: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(feats, np.float32)).to(self.device)

    def _warmup(self):
        """One generation for each bucket: the CUDA kernels build (nvcc)
        and the libraries' handles are made before the first request."""
        with torch.no_grad():
            self._warmup_buckets()

    def _warmup_buckets(self):
        for b in self.batch_buckets:
            t0 = time.time()
            out = self._generate(self._put_batch(
                np.zeros((b, self.tv, self.cond_dim), np.float32)), 0)
            if out["audio"] is not None:
                out["audio"].cpu()
            logger.info(
                "warmed up generation: batch=%d tv=%d duration=%.2fs "
                "(%.1fs)", b, self.tv, self.duration, time.time() - t0,
            )

    def video_to_features(self, video_bytes: bytes) -> np.ndarray:
        """mp4 bytes -> [Tv, cond_dim] features via the visual encoder."""
        from vaura_tpu_torch.data import media

        with tempfile.NamedTemporaryFile(suffix=".mp4") as f:
            f.write(video_bytes)
            f.flush()
            frames, _, _ = media.read_video(
                f.name, fps=25.0, duration=self.duration + 0.01,
                want_audio=False,
            )
        return self.frames_to_features(frames)

    def _clip_frames(self, frames: np.ndarray) -> np.ndarray:
        """The whole 16-frame segments of ``frames`` within the server's
        duration (``ValueError`` for a clip shorter than one, or a server
        without an encoder)."""
        if self.system.encoder is None:
            raise ValueError("no visual encoder configured")
        fps = FRAMES_PER_SEGMENT
        if frames is None or frames.ndim != 4 or frames.shape[0] < fps:
            n = 0 if frames is None else frames.shape[0]
            raise ValueError(
                f"video too short: {n} frames at 25 fps < "
                f"one {fps}-frame segment (need >= 0.64 s)"
            )
        n_seg = max(1, frames.shape[0] // fps)
        n_seg = min(n_seg, max(1, int((self.duration + 1e-6) / 0.64)))
        return np.ascontiguousarray(frames[: n_seg * fps])

    def frames_to_features(self, frames: np.ndarray) -> np.ndarray:
        """Decoded frames ``[N, H, W, 3]`` uint8 at 25 fps -> ``[Tv,
        cond_dim]`` features: whole 16-frame segments within the server's
        duration, normalized to [-1, 1] (mean/std 0.5, the configs'
        ``Normalize``), through the encoder and the bridge. Under several
        processes a job of the worker, on every rank."""
        frames = self._clip_frames(frames)
        if self.mesh is None:
            with torch.no_grad():
                return self._features(torch.from_numpy(frames))
        return self._run_in_worker({"job": "features", "frames": frames})

    def _features(self, frames: torch.Tensor) -> np.ndarray:
        """The encoder and the bridge over a clip's segments (``frames``
        ``[n_seg * 16, H, W, 3]`` uint8); on a mesh every rank runs it on
        the whole clip (the placed encoder's collectives take every rank)
        and gets the whole features."""
        fps = FRAMES_PER_SEGMENT
        n_seg = frames.shape[0] // fps
        x = (frames.to(self.device).float() / 255.0 - 0.5) / 0.5
        x = x.permute(3, 0, 1, 2).reshape(3, n_seg, fps, *frames.shape[1:3])
        x = x.permute(1, 0, 2, 3, 4)[None].contiguous()  # [1, S, C, T, H, W]
        return self.system.visual_features(x).float().cpu().numpy()[0]

    def submit(self, feats: np.ndarray, want: str = "audio"):
        """Enqueue one request; blocks until its result is ready.

        ``feats`` must have at most ``self.tv`` rows — shorter requests
        are zero-padded to the fixed conditioning length (the empty-video
        padding of the reference, ``llama.py:555-586``); longer ones are
        rejected rather than silently truncated.
        """
        if feats.shape[0] > self.tv:
            raise ValueError(
                f"features too long: {feats.shape[0]} rows > tv={self.tv} "
                f"(duration {self.duration:.2f}s); re-encode a shorter clip "
                "or start the server with a larger duration"
            )
        return self._run_in_worker({"feats": feats, "want": want})

    def _run_in_worker(self, slot: dict):
        """Enqueue ``slot`` (a request, or a ``job``), wait until the
        worker answered it, and return its result (raise its error)."""
        done = threading.Event()
        slot["done"] = done
        self._enqueue(slot)
        done.wait()
        if "error" in slot:
            raise slot.get("error_type", RuntimeError)(slot["error"])
        return slot.get("result")

    def _enqueue(self, slot: dict) -> None:
        with self._metrics_lock:
            if self._draining:
                raise DrainingError(
                    "server is draining (shutdown in progress)"
                )
            self._inflight += 1
            if slot.get("job") in (None, "stream"):
                key = ("stream_requests_total" if slot.get("job")
                       else "requests_total")
                self._metrics[key] += 1
            # under the lock: a drain that stops the worker empties the
            # queue after setting _draining, and no slot can slip past it
            self._q.put(slot)

    def _finish(self, slots, error: Optional[str] = None,
                error_type=RuntimeError) -> None:
        with self._metrics_lock:
            self._inflight -= len(slots)
            if error is not None:
                self._metrics["errors_total"] += len(slots)
        for s in slots:
            if error is not None:
                s["error"], s["error_type"] = error, error_type
            s["done"].set()

    def _fail(self, slots, error: BaseException) -> None:
        """Stop the server after a job failed on a mesh (the ranks'
        collectives can no longer be trusted to pair): answer ``slots`` and
        every queued request with 500, stop accepting work, and hand the
        stop to ``on_fatal``. Nothing more is sent to the followers."""
        logger.error("a job failed under the mesh; the server stops: %s",
                     error, exc_info=error)
        self.failed = error
        msg = f"the server stopped after a failed job: {error}"
        self._finish(slots, msg, ServerFailed)
        with self._metrics_lock:
            self._draining = True
        while True:
            try:
                s = self._q.get_nowait()
            except queue.Empty:
                break
            if s is not None:
                self._finish([s], msg, ServerFailed)
        if self.on_fatal is not None:
            self.on_fatal()

    def begin_drain(self) -> None:
        """Stop accepting work; queued/in-flight requests still finish."""
        with self._metrics_lock:
            if self._draining:
                return
            self._draining = True
        logger.info("draining: no new requests accepted")

    def drain(self, timeout: float = 120.0) -> bool:
        """Block until every accepted request has been answered (or
        ``timeout``). Returns True when fully drained."""
        self.begin_drain()
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._metrics_lock:
                if self._inflight == 0:
                    return True
            time.sleep(0.05)
        with self._metrics_lock:
            left = self._inflight
        logger.warning("drain timeout: %d requests still in flight", left)
        return False

    def metrics_text(self) -> str:
        """Prometheus exposition-format counters."""
        with self._metrics_lock:
            m = dict(self._metrics)
            buckets = dict(self._bucket_counts)
            inflight = self._inflight
            draining = int(self._draining)
        batches = max(1, m["batches_total"])
        capacity = max(1, m["batch_capacity_total"])
        lines = [
            "# TYPE vaura_requests_total counter",
            f"vaura_requests_total {m['requests_total']}",
            f"vaura_stream_requests_total {m['stream_requests_total']}",
            f"vaura_batches_total {m['batches_total']}",
            f"vaura_errors_total {m['errors_total']}",
            f"vaura_reloads_total {m['reloads_total']}",
        ] + [
            'vaura_bucket_batches_total{bucket="%d"} %d' % (b, n)
            for b, n in buckets.items()
        ] + [
            "# TYPE vaura_batch_fill_ratio gauge",
            "vaura_batch_fill_ratio "
            f"{m['batch_slots_total'] / capacity:.4f}",
            f"vaura_batch_seconds_avg {m['batch_seconds_sum'] / batches:.4f}",
            f"vaura_inflight {inflight}",
            f"vaura_draining {draining}",
            f"vaura_compiled_batch {self.batch}",
        ] + [
            'vaura_mesh_size{axis="%s"} %d' % (axis, n)
            for axis, n in (self.mesh_shape or {}).items()
        ]
        return "\n".join(lines) + "\n"

    def submit_stream(self, feats_segments: np.ndarray, writer) -> None:
        """Enqueue one streaming long-generation request; ``writer`` is
        called from the worker thread with a float32 waveform increment
        ``[n_samples]`` per chunk, as soon as that chunk is decoded.
        Blocks until the stream completes. ``feats_segments``:
        ``[S_total, t, cond_dim]`` per-segment visual features."""
        want = (self.stream_segments, self.stream_t, self.cond_dim)
        if tuple(feats_segments.shape) != want:
            raise ValueError(
                f"stream features must be {list(want)} (server "
                f"stream_duration geometry x features/segment); got "
                f"{list(feats_segments.shape)}"
            )
        self._run_in_worker({"job": "stream", "feats": feats_segments,
                             "writer": writer})

    def _stream(self, feats: torch.Tensor, seed: int, mode: str, writer):
        """The increments of ``generate_long_stream`` (or, ``mode`` "kv",
        ``generate_long_kv_stream``) of the B=1 ``feats`` ``[1, S_total, t,
        cond_dim]``, each handed to ``writer`` as it decodes; returns
        ``(chunks, the writer's error or None)``. On a mesh every rank runs
        the whole stream (replicated) and only rank 0 has a writer; a
        writer that raises there (a client gone) ends rank 0's writing, not
        the stream, whose collectives the other ranks share. In one process
        the writer's error ends the stream."""
        system = self.system
        gen = torch.Generator(self.device).manual_seed(seed)
        if mode == "kv":
            chunks = system.generate_long_kv_stream(
                generator=gen,
                total_tokens=self.stream_tokens,
                vis_feats_segments=feats,
                window_chunks=self.stream_window_chunks,
                chunk_steps=self.stream_chunk_steps,
                **self.sampling,
            )
        else:
            chunks = system.generate_long_stream(
                generator=gen,
                total_tokens=self.stream_tokens,
                stride_tokens=self.stream_stride_tokens,
                model_max_tokens=self.stream_max_tokens,
                vis_feats_segments=feats,
                **self.sampling,
            )
        n, lost = 0, None
        with system.replicated():
            for chunk in chunks:
                n += 1
                if writer is None:
                    continue
                audio = chunk["audio"].float().cpu().numpy()[0]
                if not audio.size:
                    continue
                try:
                    writer(audio)
                except Exception as e:
                    if self.mesh is None:
                        raise
                    writer, lost = None, e
        return n, lost

    def _run_stream(self, slot: dict) -> None:
        """Run one streaming request exclusively (B=1): the increments of
        ``generate_long_stream`` (or ``generate_long_kv_stream``) are
        written out as they decode."""
        seed = self._next_seed
        self._next_seed += 1
        t0 = time.time()
        try:
            job, (feats,) = self._broadcast(
                {"kind": "stream", "seed": seed, "mode": self.stream_mode},
                [self._put_batch(slot["feats"])[None]])
            n, lost = self._stream(feats, seed, job["mode"], slot["writer"])
        except Exception as e:
            if self.mesh is not None:
                self._fail([slot], e)
                return
            logger.exception("stream failed")
            self._finish([slot], error=str(e))
            return
        if lost is not None:
            logger.error("stream's client lost: %s", lost)
            self._finish([slot], error=str(lost))
            return
        logger.info("stream done: %d chunks, %d tokens, %.2fs",
                    n, self.stream_tokens, time.time() - t0)
        self._finish([slot])

    def _run_job(self, slot: dict) -> None:
        """A clip's encoder pass or a reload (a slot of the worker's queue
        under several processes): its header to every rank, then the job
        here; rank 0 answers the slot. A refused reload keeps serving; any
        other failure after the header went out stops the server."""
        try:
            if slot["job"] == "features":
                _, (frames,) = self._broadcast(
                    {"kind": "features"}, [torch.from_numpy(slot["frames"])])
                slot["result"] = self._features(frames)
            else:
                self._broadcast({"kind": "reload", "path": slot["path"]})
                slot["result"] = self._reload(slot["path"])
        except ReloadRefused as e:
            logger.warning("%s", e)
            self._finish([slot], error=str(e), error_type=ReloadRefused)
        except Exception as e:
            self._fail([slot], e)
        else:
            self._finish([slot])

    def _broadcast(self, header: dict, tensors=()):
        """A job's header and tensors to every rank (the control channel);
        in one process, or a job that rank 0 runs alone, themselves."""
        if self.channel is None or (self.mesh is None and header["kind"]
                                    not in ("noop", "shutdown")):
            return header, list(tensors)
        self._last_header = time.monotonic()
        return self.channel.broadcast(header, tensors)

    def follow(self) -> None:
        """A follower's loop: run each job rank 0 sends, in its order,
        until its ``shutdown``. A failed job raises (the process exits
        non-zero); a refused reload keeps serving, as on rank 0."""
        with torch.no_grad():
            self._follow()

    def _follow(self) -> None:
        logger.info("rank %d follows rank 0's jobs (pid %d)",
                    multihost.process_index(), os.getpid())
        while True:
            job, tensors = self.channel.broadcast()
            kind = job["kind"]
            if kind == "noop":
                continue
            if kind == "shutdown":
                logger.info("rank %d: shutdown from rank 0",
                            multihost.process_index())
                return
            if self.system is None:
                raise RuntimeError(f"a {kind} job reached a rank that "
                                   "serves nothing")
            if kind == "batch":
                self._generate(tensors[0], job["seed"], job["sampling"])
            elif kind == "stream":
                self._stream(tensors[0], job["seed"], job["mode"], None)
            elif kind == "features":
                self._features(tensors[0])
            elif kind == "reload":
                try:
                    self._reload(job["path"])
                except ReloadRefused as e:
                    logger.warning("%s", e)
            else:
                raise ValueError(f"unknown job {kind!r} from rank 0")

    def close(self, timeout: float = 10.0) -> bool:
        """Drain, stop the worker thread, and release the service.

        Idempotent; used by tests and the server's signal path so a
        retired service does not leave its micro-batch worker (which
        holds ``self`` and its modules) alive. The worker's last act is
        the ``shutdown`` header that ends the followers.
        """
        drained = self.drain(timeout=timeout)
        self._q.put(None)  # wake + stop the worker
        if self._worker.is_alive():
            self._worker.join(timeout=timeout)
        return drained

    def _dispatch(self, slots):
        """Pad ``slots`` to the smallest bucket and run the generation;
        returns the batch record for ``_fetch``, or None when it failed
        (its requests are then answered with the error; on a mesh the
        server stops)."""
        bucket = next(b for b in self.batch_buckets if b >= len(slots))
        feats = np.zeros((bucket, self.tv, self.cond_dim), np.float32)
        for i, s in enumerate(slots):
            feats[i, : s["feats"].shape[0]] = s["feats"]
        seed = self._next_seed
        self._next_seed += 1
        t0 = time.time()
        try:
            job, (batch,) = self._broadcast(
                {"kind": "batch", "bucket": bucket, "seed": seed,
                 "sampling": self.sampling}, [self._put_batch(feats)])
            out = self._generate(batch, seed, job["sampling"])
        except Exception as e:
            if self.mesh is not None:
                self._fail(slots, e)
                return None
            logger.exception("batch dispatch failed")
            self._finish(slots, error=str(e))
            return None
        return {"slots": slots, "bucket": bucket, "out": out, "t0": t0}

    def _fetch(self, p) -> None:
        """Copy a batch's results to the host and reply to its requests."""
        slots = p["slots"]
        try:
            audio = p["out"]["audio"].float().cpu().numpy()
            codes = p["out"]["codes"].cpu().numpy()
            dt = time.time() - p["t0"]
            for i, s in enumerate(slots):
                s["result"] = codes[i] if s["want"] == "codes" else audio[i]
            with self._metrics_lock:
                self._metrics["batches_total"] += 1
                self._metrics["batch_slots_total"] += len(slots)
                self._metrics["batch_capacity_total"] += p["bucket"]
                self._bucket_counts[p["bucket"]] += 1
                self._metrics["batch_seconds_sum"] += dt
            self._finish(slots)
            logger.info(
                "batch n=%d/%d total=%.3fs", len(slots), p["bucket"], dt
            )
        except Exception as e:  # pragma: no cover - defensive
            logger.exception("batch failed")
            self._finish(slots, error=str(e))

    def _take(self):
        """The next slot of the queue (blocking while idle); under several
        processes a no-op header to the followers whenever ``HEARTBEAT_S``
        passed since the last header went out: while idle, and between the
        batches and jobs that rank 0 runs alone
        (``multihost.ControlChannel``)."""
        if self.channel is None:
            return self._q.get()
        while True:
            wait = self._last_header + multihost.HEARTBEAT_S - time.monotonic()
            if wait <= 0:
                self._broadcast({"kind": "noop"})
                continue
            try:
                return self._q.get(timeout=wait)
            except queue.Empty:
                pass

    def _run_special(self, s: dict) -> None:
        if s["job"] == "stream":
            self._run_stream(s)
        else:
            self._run_job(s)

    def _loop(self):
        """Micro-batch worker: block for a first request, collect up to
        ``batch`` within ``max_wait_ms``, then run and answer the batch.
        Requests that arrive meanwhile queue, so the next collection fills
        at once. A job (stream, clip, reload) or the close() sentinel met
        while collecting runs after the batch collected before it. The
        loop ends with the ``shutdown`` header to the followers, or without
        it when a job stopped the server; a header that fails outside a
        job (a heartbeat, the shutdown) stops it too."""
        try:
            with torch.no_grad():
                self._serve_queue()
        except Exception as e:
            self._fail([], e)

    def _serve_queue(self) -> None:
        while self.failed is None:
            s = self._take()  # idle: block until work arrives
            if s is None:
                break
            if s.get("job"):
                self._run_special(s)
                continue
            slots = [s]
            special = None  # intercepted job slot, or "close"
            deadline = time.time() + self.max_wait_s
            while len(slots) < self.batch:
                timeout = deadline - time.time()
                if timeout <= 0:
                    break
                try:
                    s = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if s is None or s.get("job"):
                    special = "close" if s is None else s
                    break
                slots.append(s)
            p = self._dispatch(slots)
            if p is not None:
                self._fetch(p)
            if special == "close":
                break
            if special is not None and self.failed is not None:
                self._finish([special], "the server stopped after a failed "
                             f"job: {self.failed}", ServerFailed)
            elif special is not None:
                self._run_special(special)
        if self.failed is None:
            self._broadcast({"kind": "shutdown"})


def make_handler(service: GenerationService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.info("%s " + fmt, self.client_address[0], *args)

        def _reply(self, code, body: bytes, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, e: Exception):
            code = (503 if isinstance(e, DrainingError) else
                    500 if isinstance(e, ServerFailed) else 400)
            self._reply(code, json.dumps({"error": str(e)}).encode())

        def do_GET(self):
            if self.path.startswith("/metrics"):
                self._reply(
                    200, service.metrics_text().encode(),
                    "text/plain; version=0.0.4",
                )
                return
            if self.path.startswith("/healthz"):
                info = {
                    "status": "draining" if service._draining else "ok",
                    "batch": service.batch,
                    "batch_buckets": service.batch_buckets,
                    "duration_s": service.duration,
                    "max_feature_rows": service.tv,
                    "sample_rate": service.sample_rate,
                    "cond_dim": service.cond_dim,
                    "ckpt_path": service.ckpt_path,
                    "mesh": service.mesh_shape,
                    "device": service.system.device.type,
                }
                self._reply(200, json.dumps(info).encode())
            else:
                self._reply(404, b'{"error": "not found"}')

        def _features(self, feats) -> np.ndarray:
            feats = np.asarray(feats, np.float32)
            if feats.ndim != 2 or feats.shape[1] != service.cond_dim:
                raise ValueError(
                    f"features must be [Tv, {service.cond_dim}]")
            return feats

        def do_POST(self):
            if self.path.startswith("/generate_long"):
                self._do_stream()
                return
            if self.path.startswith("/reload"):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    info = service.reload(req.get("ckpt_path"))
                    self._reply(200, json.dumps(info).encode())
                except Exception as e:
                    self._error(e)
                return
            if not self.path.startswith("/generate"):
                self._reply(404, b'{"error": "not found"}')
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                ctype = (self.headers.get("Content-Type") or "").split(";")[0]
                if ctype == "application/octet-stream":
                    # binary fast path: .npy bytes of a [Tv, cond_dim]
                    # float array (~100 KB at 32 x 768, against ~600 KB
                    # of JSON whose parse serializes on the host)
                    feats = self._features(
                        np.load(io.BytesIO(body), allow_pickle=False))
                else:
                    req = json.loads(body or b"{}")
                    if "features" in req:
                        feats = self._features(req["features"])
                    elif "video_b64" in req:
                        feats = service.video_to_features(
                            base64.b64decode(req["video_b64"])
                        )
                    else:
                        raise ValueError(
                            "body needs 'features' or 'video_b64' (JSON), "
                            "or .npy bytes as application/octet-stream"
                        )
                want = "codes" if "raw=codes" in self.path else "audio"
                result = service.submit(feats, want)
                if want == "codes":
                    self._reply(
                        200, json.dumps({"codes": result.tolist()}).encode()
                    )
                else:
                    buf = io.BytesIO()
                    write_wav(buf, result.reshape(1, -1), service.sample_rate)
                    self._reply(200, buf.getvalue(), "audio/wav")
            except Exception as e:
                self._error(e)

        def _do_stream(self):
            """POST /generate_long — long-horizon generation streamed as a
            live WAV (unknown-length RIFF header + PCM increments, close-
            delimited): the client hears the first chunk while later
            chunks are still decoding. Body: .npy bytes (octet-stream) or
            JSON {"features_segments": ...} of [S_total, t, cond_dim]
            per-segment visual features."""
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                ctype = (self.headers.get("Content-Type") or "").split(";")[0]
                if ctype == "application/octet-stream":
                    feats = np.load(io.BytesIO(body), allow_pickle=False)
                else:
                    feats = np.asarray(
                        json.loads(body or b"{}")["features_segments"]
                    )
                feats = np.asarray(feats, np.float32)
                if feats.ndim != 3:
                    raise ValueError("features_segments must be 3-D")
            except Exception as e:
                self._reply(400, json.dumps({"error": str(e)}).encode())
                return
            headers_sent = False

            def write_increment(audio: np.ndarray):
                nonlocal headers_sent
                if not headers_sent:
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/wav")
                    self.send_header("Connection", "close")
                    self.end_headers()
                    self.wfile.write(
                        wav_stream_header(service.sample_rate)
                    )
                    headers_sent = True
                self.wfile.write(pcm16(audio))
                self.wfile.flush()

            try:
                service.submit_stream(feats, write_increment)
                if not headers_sent:  # zero-length stream edge case
                    write_increment(np.zeros((0,), np.float32))
                self.close_connection = True
            except Exception as e:
                if headers_sent:
                    # mid-stream failure: the status line is gone; all we
                    # can do is cut the close-delimited stream short
                    logger.error("stream aborted mid-response: %s", e)
                    self.close_connection = True
                else:
                    self._error(e)

    return Handler


def make_server(cfg: dict):
    """The started service and, on rank 0, its HTTP server on 127.0.0.1
    (``port``, 8800 by default; 0 picks a free one), not yet serving; a
    follower of several processes gets ``(service, None)`` and calls
    ``service.follow()``."""
    service = GenerationService(cfg)
    service.start()
    if not service.leader:
        return service, None
    # the listen backlog must exceed the target concurrency: the
    # http.server default (5) resets connects beyond it under burst load
    ThreadingHTTPServer.request_queue_size = int(
        cfg.get("listen_backlog", 256)
    )
    server = ThreadingHTTPServer(
        ("127.0.0.1", int(cfg.get("port", 8800))), make_handler(service))
    service.on_fatal = lambda: threading.Thread(
        target=server.shutdown, daemon=True).start()
    return service, server


def run_server(cfg: dict) -> None:
    """Start the micro-batching HTTP server from an assembled config
    (``python -m vaura_tpu_torch ... action=serve``; one process per card
    under ``torchrun``). Raises when a job stopped the server."""
    logging.getLogger().setLevel(logging.INFO)
    rank = multihost.process_index()
    if rank != 0:
        # SIGTERM reaches every process of a job; a follower's end is rank
        # 0's shutdown header, after rank 0 has drained
        def _wait(signum, frame):
            logger.info("signal %d: rank %d waits for rank 0's shutdown",
                        signum, rank)

        signal.signal(signal.SIGTERM, _wait)
        signal.signal(signal.SIGINT, _wait)
    service, server = make_server(cfg)
    if server is None:
        service.follow()
        logger.info("shutdown complete (rank %d)", rank)
        return

    # graceful shutdown: SIGTERM/SIGINT -> stop accepting work (new
    # requests get 503), answer everything already accepted, then exit 0
    def _shutdown(signum, frame):
        logger.info("signal %d: draining", signum)
        service.begin_drain()
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)

    logger.info("serving on http://127.0.0.1:%d (batch=%d, pid %d)",
                server.server_address[1], service.batch, os.getpid())
    server.serve_forever()
    server.server_close()
    drained = service.close(timeout=float(cfg.get("drain_timeout_s", 120)))
    if service.failed is not None:
        raise ServerFailed(f"the server stopped after a failed job: "
                           f"{service.failed}") from service.failed
    logger.info("shutdown complete (drained=%s)", drained)
