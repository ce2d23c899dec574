"""Batched generation server on one card.

Counterpart of ``scripts/serve.py``, feature for feature: a micro-batching
queue in front of ``VauraSystem.generate`` (requests are padded to the
smallest batch bucket that fits and answered individually), long-horizon
streams, hot reload, drain, Prometheus metrics and a plain-HTTP surface.

Endpoints::

    GET  /healthz            -> {"status": "ok"|"draining", "batch": B, ...}
    GET  /metrics            -> Prometheus counters (requests, batches,
                                fill ratio, latency avg, inflight)
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
        [stream_mode=reprefill|kv] [trainer.platform=cpu]

The server runs on ``cuda`` unless ``trainer.platform=cpu``, on one card:
with several cards visible (``mesh_serving``) it says so in a log line.
``aot_export`` / ``aot_load`` raise (eager PyTorch has no graph to export);
``compilation_cache_dir`` is logged and ignored; ``decode_buckets`` (8 by
default) matters only under ``int8_dots``, whose probabilities are quantized
per chunk (``VauraSystem.generate_tokens``). A LoRA
experiment serves its adapters merged into its base (the run's ``frozen/``
save, else its ``finetune.init_from``:
``scripts/generate.py::load_lora_base_``); a reload
swaps in new adapters; ``quantize=true`` raises ``ValueError`` with LoRA
(the adapters cannot be merged into int8 weights; ``quantize=cache`` can).

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
* ``torch.inference_mode`` is per thread: the worker enters it, and so does
  each HTTP handler thread that runs the encoder (``video_to_features``).
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


class DrainingError(RuntimeError):
    """Raised for requests arriving after shutdown began (HTTP 503)."""


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


class GenerationService:
    """Owns the served system and the micro-batching queue."""

    def __init__(self, cfg: dict):
        if cfg.get("aot_export") or cfg.get("aot_load"):
            raise NotImplementedError(
                "aot_export/aot_load serialize a jax.export graph; eager "
                "PyTorch has no graph to export: drop both keys")
        cache_dir = cfg.get("compilation_cache_dir") or (
            cfg.get("trainer") or {}
        ).get("compilation_cache_dir")
        if cache_dir:
            logger.info("compilation_cache_dir=%s ignored: nothing is "
                        "compiled (the CUDA kernels build once into the "
                        "package's _build/)", cache_dir)
        self.device = config_device(cfg)
        if (self.device.type == "cuda" and torch.cuda.device_count() > 1
                and bool(cfg.get("mesh_serving", True))):
            logger.info("%d CUDA devices are visible; the port's server runs "
                        "on one (%s)", torch.cuda.device_count(), self.device)

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
        self.system = system
        self.cond_dim = system.sampler_config.cond_in_dim
        self.sample_rate = system.dac.cfg.sample_rate
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

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def _int8_agreement_probe(
        self, system, fp_sampler, q_sampler, batch: int = 2, tokens: int = 32
    ) -> float:
        """Teacher-forced argmax agreement between the bf16 and int8
        sampler at the loaded weights, on a fixed synthetic probe batch
        (two short forwards of ``VauraSystem.train_forward``)."""
        cfg_q = q_sampler.cfg
        rng = np.random.default_rng(0)
        codes = torch.as_tensor(rng.integers(
            0, cfg_q.d_codebook, size=(batch, cfg_q.num_codebooks, tokens)
        ), device=self.device)
        vis = torch.as_tensor(rng.standard_normal(
            (batch, 8, cfg_q.cond_in_dim)
        ).astype(np.float32), device=self.device)

        def logits_for(sampler):
            _, aux = _with_modules(system, sampler=sampler).train_forward(
                None, None, None, train=False, vis_feats=vis, codes=codes)
            return aux["logits"].float(), aux["mask"]

        lf, mask = logits_for(fp_sampler)
        lq, _ = logits_for(q_sampler)
        return float(
            (lf.argmax(-1)[mask] == lq.argmax(-1)[mask]).float().mean()
        )

    @torch.no_grad()
    def reload(self, ckpt_path: Optional[str] = None) -> dict:
        """Swap the serving weights for a checkpoint's (POST /reload).

        Restores the trainable leaves into NEW modules on the device
        (sampler, bridge, an unfrozen encoder), shares the frozen ones,
        re-applies int8 quantization (re-running the agreement gate: a
        reload that fails it keeps the current weights serving), and swaps
        in a view of the system that holds them. The worker reads
        ``self.system`` once per batch, so in-flight batches finish on the
        old weights and the next batch uses the new ones.
        """
        path = str(ckpt_path or self.ckpt_path or "")
        if not path:
            raise ValueError(
                "no checkpoint to reload: pass ckpt_path (the server was "
                "started without one)"
            )
        with self._reload_lock:
            t0 = time.time()
            restored = restore_trainable_params(
                path, self._trainable_like, self._model_cfg,
                self._trainer_cfg,
            )  # on the host, memory-mapped: copied once into the modules
            live = self.system
            modules, gate = {}, None
            for top in sorted({k.split(".", 1)[0] for k in restored}):
                if top == "sampler":
                    module = Sampler(dataclasses.replace(
                        live.sampler_config, quantize_weights=False),
                        self.device)
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
                    gate = self._int8_agreement_probe(
                        live, fp_sampler, q_sampler
                    )
                    if gate < self._quantize_min_agreement:
                        raise RuntimeError(
                            "reload refused: int8 agreement %.4f < gate "
                            "%.2f at %s — current weights keep serving"
                            % (gate, self._quantize_min_agreement, path)
                        )
                del fp_sampler
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
        self._warmup()
        self._worker.start()

    def _generate(self, feats: torch.Tensor, seed: int) -> dict:
        """One batch through ``VauraSystem.generate`` (``self.system`` read
        once): ``{"audio" [B, 1, samples], "codes" [B, K, tokens]}`` on the
        device."""
        out = self.system.generate(
            vis_feats=feats,
            generator=torch.Generator(self.device).manual_seed(int(seed)),
            max_new_tokens=self.tokens,
            tokens_per_frame=7,
            decode_to_audio=True,
            dac_chunk_size=self.dac_chunk_size,
            decode_buckets=self.decode_buckets,
            **self.sampling,
        )
        return {"audio": out["audio"], "codes": out["codes"]}

    def _put_batch(self, feats: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(feats, np.float32)).to(self.device)

    @torch.inference_mode()
    def _warmup(self):
        """One generation for each bucket: the CUDA kernels build (nvcc)
        and the libraries' handles are made before the first request."""
        for b in self.batch_buckets:
            t0 = time.time()
            out = self._generate(self._put_batch(
                np.zeros((b, self.tv, self.cond_dim), np.float32)), 0)
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

    @torch.inference_mode()
    def frames_to_features(self, frames: np.ndarray) -> np.ndarray:
        """Decoded frames ``[N, H, W, 3]`` uint8 at 25 fps -> ``[Tv,
        cond_dim]`` features: whole 16-frame segments within the server's
        duration, normalized to [-1, 1] (mean/std 0.5, the configs'
        ``Normalize``), through the encoder and the bridge."""
        system = self.system
        if system.encoder is None:
            raise ValueError("no visual encoder configured")
        fps = 16  # frames per segment (divided_224_16x4 contract)
        if frames is None or frames.shape[0] < fps:
            n = 0 if frames is None else frames.shape[0]
            raise ValueError(
                f"video too short: {n} frames at 25 fps < "
                f"one {fps}-frame segment (need >= 0.64 s)"
            )
        n_seg = max(1, frames.shape[0] // fps)
        n_seg = min(n_seg, max(1, int((self.duration + 1e-6) / 0.64)))
        frames = frames[: n_seg * fps]
        x = (frames.astype(np.float32) / 255.0 - 0.5) / 0.5
        x = np.transpose(x, (3, 0, 1, 2)).reshape(
            3, n_seg, fps, *frames.shape[1:3]
        ).transpose(1, 0, 2, 3, 4)[None]  # [1, S, C, T, H, W]
        feats = system.visual_features(torch.from_numpy(
            np.ascontiguousarray(x)).to(self.device))
        return feats.float().cpu().numpy()[0]

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
        done = threading.Event()
        slot: dict = {"feats": feats, "want": want, "done": done}
        self._enqueue(slot)
        done.wait()
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["result"]

    def _enqueue(self, slot: dict) -> None:
        with self._metrics_lock:
            if self._draining:
                raise DrainingError(
                    "server is draining (shutdown in progress)"
                )
            self._inflight += 1
            key = (
                "stream_requests_total" if slot.get("stream")
                else "requests_total"
            )
            self._metrics[key] += 1
        self._q.put(slot)

    def _finish(self, slots, error: Optional[str] = None) -> None:
        with self._metrics_lock:
            self._inflight -= len(slots)
            if error is not None:
                self._metrics["errors_total"] += len(slots)
        for s in slots:
            if error is not None:
                s["error"] = error
            s["done"].set()

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
        done = threading.Event()
        slot: dict = {
            "stream": True, "feats": feats_segments, "writer": writer,
            "done": done,
        }
        self._enqueue(slot)
        done.wait()
        if "error" in slot:
            raise RuntimeError(slot["error"])

    def _run_stream(self, slot: dict) -> None:
        """Run one streaming request exclusively (B=1): the increments of
        ``generate_long_stream`` (or ``generate_long_kv_stream``) are
        written out as they decode."""
        try:
            system = self.system
            seed = self._next_seed
            self._next_seed += 1
            t0 = time.time()
            n = 0
            feats = self._put_batch(slot["feats"])[None]
            gen = torch.Generator(self.device).manual_seed(seed)
            if self.stream_mode == "kv":
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
            for chunk in chunks:
                audio = chunk["audio"].float().cpu().numpy()[0]
                if audio.size:
                    slot["writer"](audio)
                n += 1
            logger.info(
                "stream done: %d chunks, %d tokens, %.2fs",
                n, self.stream_tokens, time.time() - t0,
            )
            self._finish([slot])
        except Exception as e:
            logger.exception("stream failed")
            self._finish([slot], error=str(e))

    def close(self, timeout: float = 10.0) -> bool:
        """Drain, stop the worker thread, and release the service.

        Idempotent; used by tests and the server's signal path so a
        retired service does not leave its micro-batch worker (which
        holds ``self`` and its modules) alive.
        """
        drained = self.drain(timeout=timeout)
        self._q.put(None)  # wake + stop the worker
        if self._worker.is_alive():
            self._worker.join(timeout=timeout)
        return drained

    def _dispatch(self, slots):
        """Pad ``slots`` to the smallest bucket and run the generation;
        returns the batch record for ``_fetch``, or None when it failed
        (its requests are then answered with the error)."""
        bucket = next(b for b in self.batch_buckets if b >= len(slots))
        feats = np.zeros((bucket, self.tv, self.cond_dim), np.float32)
        for i, s in enumerate(slots):
            feats[i, : s["feats"].shape[0]] = s["feats"]
        seed = self._next_seed
        self._next_seed += 1
        t0 = time.time()
        try:
            out = self._generate(self._put_batch(feats), seed)
        except Exception as e:
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

    @torch.inference_mode()
    def _loop(self):
        """Micro-batch worker: block for a first request, collect up to
        ``batch`` within ``max_wait_ms``, then run and answer the batch.
        Requests that arrive meanwhile queue, so the next collection fills
        at once. A stream or the close() sentinel met while collecting runs
        after the batch collected before it."""
        while True:
            s = self._q.get()  # idle: block until work arrives
            if s is None:
                return
            if s.get("stream"):
                self._run_stream(s)
                continue
            slots = [s]
            special = None  # intercepted stream slot, or "close"
            deadline = time.time() + self.max_wait_s
            while len(slots) < self.batch:
                timeout = deadline - time.time()
                if timeout <= 0:
                    break
                try:
                    s = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if s is None or s.get("stream"):
                    special = "close" if s is None else s
                    break
                slots.append(s)
            p = self._dispatch(slots)
            if p is not None:
                self._fetch(p)
            if special == "close":
                return
            if special is not None:
                self._run_stream(special)


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
                    self._reply(400, json.dumps({"error": str(e)}).encode())
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
            except DrainingError as e:
                self._reply(503, json.dumps({"error": str(e)}).encode())
            except Exception as e:
                self._reply(400, json.dumps({"error": str(e)}).encode())

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
            except DrainingError as e:
                self._reply(503, json.dumps({"error": str(e)}).encode())
            except Exception as e:
                if headers_sent:
                    # mid-stream failure: the status line is gone; all we
                    # can do is cut the close-delimited stream short
                    logger.error("stream aborted mid-response: %s", e)
                    self.close_connection = True
                else:
                    self._reply(400, json.dumps({"error": str(e)}).encode())

    return Handler


def make_server(cfg: dict) -> tuple[GenerationService, ThreadingHTTPServer]:
    """The started service and its HTTP server on 127.0.0.1 (``port``,
    8800 by default; 0 picks a free one), not yet serving."""
    service = GenerationService(cfg)
    service.start()
    # the listen backlog must exceed the target concurrency: the
    # http.server default (5) resets connects beyond it under burst load
    ThreadingHTTPServer.request_queue_size = int(
        cfg.get("listen_backlog", 256)
    )
    server = ThreadingHTTPServer(
        ("127.0.0.1", int(cfg.get("port", 8800))), make_handler(service))
    return service, server


def run_server(cfg: dict) -> None:
    """Start the micro-batching HTTP server from an assembled config
    (``python -m vaura_tpu_torch ... action=serve``)."""
    logging.getLogger().setLevel(logging.INFO)
    service, server = make_server(cfg)

    # graceful shutdown: SIGTERM/SIGINT -> stop accepting work (new
    # requests get 503), answer everything already accepted, then exit 0
    def _shutdown(signum, frame):
        logger.info("signal %d: draining", signum)
        service.begin_drain()
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)

    logger.info("serving on http://127.0.0.1:%d (batch=%d)",
                server.server_address[1], service.batch)
    server.serve_forever()
    server.server_close()
    drained = service.close(timeout=float(cfg.get("drain_timeout_s", 120)))
    logger.info("shutdown complete (drained=%s)", drained)
