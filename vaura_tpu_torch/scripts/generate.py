"""Generate action: build the system from a config, load a reference
checkpoint or a checkpoint of this package (``ckpt_path``, or the best one
of ``experiment_path`` with the ``hparams.yaml`` beside it; else seeded
random weights), iterate a generation
dataloader, run single-chunk or long-horizon generation on the device, and
write one WAV file per clip (+ ``.codes.npy`` under
``return_sampled_indices``, + an MP4 mux when the native media module is
available).

Counterpart of ``scripts/generate.py``, feature for feature: ``duration`` /
``stride`` / ``model_max_duration`` decide between one chunk and the long
modes (``long_mode``: ``reprefill`` -> ``generate_long``, ``stream_kv`` ->
``generate_long_kv``, with ``block_size_audio`` raised to cover the
horizon); ``quantize`` (int8 sampler weights and int8 KV cache);
``prompt_duration`` (ground-truth audio encoded into prompt codes) and
``remove_prompts``; ``save_original_files`` with ``compress_original_audio``
(the DAC round trip); ``frame_step``, ``encoder_chunk_size``,
``max_batches``, ``seed``, ``audio_norm_strategy``; the per-batch error
handling; bf16 weights at inference (every floating parameter rounded to
bf16, as the JAX action's ``cast_floats``). A LoRA experiment (``lora_rank``
in its hparams) gets its base weights from the run's ``finetune.init_from``
(``load_lora_base_``) and its adapters from the checkpoint, merged at
generation; with ``quantize`` it raises ``ValueError``, as the adapters
cannot be merged into int8 weights.

The device is ``cuda`` unless the config says ``trainer.platform: cpu``
(``config_device``); without CUDA and without that key it raises. The
action runs on one device: the JAX action's sharding of the batch over
several devices is not ported (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import logging
import traceback
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from vaura_tpu_torch.config.yaml_subset import dump
from vaura_tpu_torch.data import get_datamodule_from_type
from vaura_tpu_torch.models.factory import build_system
from vaura_tpu_torch.models.sampler import Sampler
from vaura_tpu_torch.ops.audio import normalize_audio, write_wav
from vaura_tpu_torch.ops.quantization import quantize_sampler_params
from vaura_tpu_torch.train.checkpoint import (
    load_base_,
    load_trainable_,
    lora_base_checkpoint,
)
from vaura_tpu_torch.utils import resolve_device, seeded_init_
from vaura_tpu_torch.utils.experiment import (
    load_hparams,
    resolve_best_checkpoint,
    resolve_experiment_paths,
)
from vaura_tpu_torch.utils.seeding import seed_everything

logger = logging.getLogger(__name__)

COMPRESSION_MODEL_FRAME_RATE = 86  # DAC tokens/s (reference generate.py:30)
REPO_ROOT = Path(__file__).resolve().parents[2]
_PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def config_device(cfg: dict) -> torch.device:
    """The device of an action: ``trainer.platform`` (``cpu``, ``gpu`` or
    ``cuda``, the key the JAX ``main.py`` reads), else CUDA, which raises
    when absent (``resolve_device``)."""
    platform = (cfg.get("trainer") or {}).get("platform")
    if platform is not None and str(platform).lower() not in _PLATFORMS:
        raise ValueError(f"trainer.platform={platform!r}: the port runs on "
                         f"one of {sorted(_PLATFORMS)}")
    return resolve_device(_PLATFORMS[str(platform).lower()] if platform
                          else None)


def scale_audio(
    audio: np.ndarray, strategy: str = "clip", sample_rate: int = 44100
) -> np.ndarray:
    """Reference ``scripts/generate.py:443-461``."""
    return normalize_audio(
        audio, strategy=strategy, sample_rate=sample_rate, peak_clip_headroom_db=6.0
    ).reshape(1, -1)


def save_results(
    audio: np.ndarray,
    frames: Optional[np.ndarray],
    output_dir: Path,
    fn: str,
    v_fps: float = 25.0,
    a_fps: int = 44100,
    audio_norm_strategy: str = "clip",
) -> None:
    """WAV always; MP4 mux via the native libav module when it is built
    (reference ``save_results``, ``generate.py:392-440``)."""
    if fn.endswith(".mp4") or fn.endswith(".wav"):
        fn = fn[:-4]
    audio = scale_audio(audio, audio_norm_strategy, a_fps)
    write_wav(output_dir / f"{fn}.wav", audio, a_fps)
    if frames is not None:
        try:
            from vaura_tpu_torch.data.media import write_video

            write_video(
                str(output_dir / f"{fn}.mp4"),
                frames,
                fps=v_fps,
                audio=audio,
                audio_sample_rate=a_fps,
            )
        except Exception as e:  # native module absent or mux failure
            logger.warning("mp4 mux skipped for %s: %s", fn, e)


@torch.no_grad()
def _round_params_to_bf16_(module: torch.nn.Module) -> None:
    """Round every floating parameter to bf16 (the JAX action's
    ``cast_floats``); matmul weights stored in bf16 are already rounded,
    the rest keep their float32 storage."""
    for p in module.parameters():
        if p.is_floating_point() and p.dtype != torch.bfloat16:
            p.copy_(p.to(torch.bfloat16))


def _replace_sampler(system, **changes) -> None:
    """Rebuild the sampler with ``changes`` to its configuration, carrying
    its weights (int8-quantized when ``quantize_weights`` is turned on)."""
    old = system.sampler
    cfg = dataclasses.replace(system.sampler_config, **changes)
    sd = old.state_dict()
    if cfg.quantize_weights and not system.sampler_config.quantize_weights:
        sd = quantize_sampler_params(sd)
    sampler = Sampler(cfg, system.device)
    sampler.load_state_dict(sd)
    sampler.requires_grad_(False)
    system.sampler, system.sampler_config = sampler, cfg


def _model_config(cfg: dict):
    """``(model_cfg, reference state dicts or None, checkpoint or None)``:
    a reference checkpoint's converted weights and hparams; else the
    experiment's ``hparams.yaml`` (or the config's own ``model`` section, or
    the flagship defaults) with the port-format checkpoint of ``ckpt_path``
    or the experiment's best one."""
    from vaura_tpu_torch.utils.reference_ckpt import (
        is_reference_checkpoint,
        load_reference_experiment,
    )

    exp_path = cfg.get("experiment_path")
    ckpt_path = cfg.get("ckpt_path") or cfg.get("checkpoint_path")
    probe = ckpt_path or exp_path
    if probe and is_reference_checkpoint(probe):
        model_cfg, ref_sds, ckpt_file = load_reference_experiment(
            probe,
            overridden_hparams=cfg["overridden_hparams"]
            if "overridden_hparams" in cfg else None,
            hparams=cfg.get("hparams"),
        )
        logger.info("Loaded reference checkpoint %s", ckpt_file)
        return model_cfg, ref_sds, None
    hparams = None
    if exp_path:
        paths = resolve_experiment_paths(exp_path)
        if ckpt_path is None:
            ckpt_path = resolve_best_checkpoint(paths["checkpoints"])
        if paths["hparams"] is not None:
            hparams = load_hparams(paths["hparams"])
    source = hparams if hparams and "model" in hparams else cfg
    if "model" not in source:
        # no experiment and no inline model section: the flagship defaults
        # with random weights, so the shipped generate configs run as they
        # are
        from vaura_tpu_torch.config import load_config

        source = load_config(REPO_ROOT / "configs" / "vaura_defaults.yaml",
                             REPO_ROOT)
        logger.warning("no experiment_path/model config: using flagship "
                       "defaults with random weights")
    model_cfg = source["model"]
    for k, v in (cfg.get("overridden_hparams") or {}).items():
        model_cfg[k] = v
    return model_cfg, None, (str(ckpt_path) if ckpt_path else None)


LORA_INT8 = ("LoRA adapters cannot be merged into int8 weights: generate "
             "from a LoRA experiment without quantize")


def load_lora_base_(system, cfg: dict, ckpt_path: Optional[str]) -> None:
    """The base weights of a LoRA experiment, in place: the run's
    ``frozen/`` save, else its ``finetune.init_from`` (from the
    experiment's ``hparams.yaml``, or from the config when no experiment is
    named; ``train/checkpoint.py::lora_base_checkpoint``). The JAX action
    leaves the seeded initialisation here, so its adapters merge into
    another base than the one they trained over (ROADMAP.md, section 3)."""
    hparams, ckpt_dir = cfg, None
    if cfg.get("experiment_path"):
        paths = resolve_experiment_paths(cfg["experiment_path"])
        ckpt_dir = paths["checkpoints"]
        if paths["hparams"] is not None:
            hparams = load_hparams(paths["hparams"])
    elif ckpt_path:
        ckpt_dir = Path(ckpt_path).parent
    base = lora_base_checkpoint(hparams, ckpt_dir)
    if base is None:
        logger.warning("LoRA experiment without a frozen save or "
                       "finetune.init_from: the adapters merge into the "
                       "seeded initialisation")
        return
    load_base_(system, base)
    logger.info("Loaded the LoRA base weights from %s", base)


def generate(cfg: dict) -> dict:
    logging.basicConfig(level=logging.INFO)
    logging.getLogger().setLevel(logging.INFO)
    duration = float(cfg.get("duration", 2.56))
    stride = float(cfg.get("stride", 0.64))
    assert (
        abs(stride / 0.64 - round(stride / 0.64)) < 1e-6
    ), "Stride must be a multiple of 0.64"
    vfps = float(cfg.get("vfps", 25))
    model_max_duration = cfg.get("model_max_duration")
    use_sampling = bool(cfg.get("use_sampling", True))
    temp = float(cfg.get("temperature", 1.0))
    top_k = int(cfg.get("top_k", 256))
    top_p = float(cfg.get("top_p", 0.0))
    cfg_scale = float(cfg.get("cfg_scale", 1.0))
    audio_norm_strategy = cfg.get("audio_norm_strategy", "clip")
    long_mode = str(cfg.get("long_mode", "reprefill")).lower()
    if long_mode not in ("reprefill", "stream_kv"):
        raise ValueError(f"unknown long_mode: {long_mode!r}")
    device = config_device(cfg)
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        logger.info("%d CUDA devices are visible; the port's generate action "
                    "runs on one (%s)", torch.cuda.device_count(), device)

    model_cfg, ref_sds, ckpt_path = _model_config(cfg)
    # bf16 storage of the matmul weights: generation only
    system = build_system(model_cfg, device=device,
                          param_dtype=torch.bfloat16)
    if system.lora_sampler is not None and cfg.get("quantize"):
        raise ValueError(LORA_INT8)
    generator = seed_everything(int(cfg.get("seed", 666)), device)
    seeded_init_(system, generator)
    system.load_dac_embeddings_into_sampler()
    if system.lora_sampler is not None:
        load_lora_base_(system, cfg, ckpt_path)
    if ckpt_path:
        load_trainable_(system, ckpt_path, model_cfg, cfg.get("trainer"))
        logger.info("Loaded checkpoint %s", ckpt_path)
    if ref_sds is not None:
        system.load_state_dicts(ref_sds)
    system.requires_grad_(False)
    _round_params_to_bf16_(system)
    if cfg.get("quantize"):
        # int8 weight-only decoder + int8 KV cache
        _replace_sampler(system, quantize_weights=True, quantize_cache=True)
        logger.info("int8 weight + KV-cache quantization enabled")

    if model_max_duration is None:
        model_max_duration = (
            2.56 if system.sampler_config.block_size > 64 else 0.64
        )  # reference generate.py:221-226
    total_gen_len = int(duration * COMPRESSION_MODEL_FRAME_RATE)
    stride_tokens = int(COMPRESSION_MODEL_FRAME_RATE * stride)
    model_max_tokens = int(model_max_duration * COMPRESSION_MODEL_FRAME_RATE)
    if long_mode == "stream_kv" and duration > model_max_duration:
        need = total_gen_len + 64  # interleave delays + headroom
        if system.sampler_config.block_size < need:
            _replace_sampler(system, block_size_audio=need)

    out_dir = Path(cfg.get("output_dir", "./generated"))
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "config.yaml").write_text(dump(cfg), encoding="utf-8")

    # `dataset_to_use` / `samples_per_video` are action-level keys carried
    # inside the dataloader section (reference generate.py:135-137 pops
    # them before the datamodule sees the kwargs)
    dl_cfg = dict(cfg["dataloader"])
    split = str(
        dl_cfg.pop("dataset_to_use", cfg.get("dataset_to_use", "test"))
    ).lower()
    dl_cfg.pop("samples_per_video", None)
    datamodule = get_datamodule_from_type(dl_cfg["dataset_type"], dl_cfg)
    datamodule.setup(split)
    loader = {
        "train": datamodule.train_dataloader,
        "test": datamodule.test_dataloader,
        "validation": datamodule.val_dataloader,
    }[split]()

    sampling = dict(
        use_sampling=use_sampling, temp=temp, top_k=top_k, top_p=top_p,
        cfg_scale=cfg_scale,
    )
    if cfg.get("encoder_chunk_size"):
        sampling["encoder_chunk_size"] = int(cfg["encoder_chunk_size"])
    save_original_files = bool(cfg.get("save_original_files", False))
    compress_original_audio = bool(cfg.get("compress_original_audio", True))
    prompt_duration = float(cfg.get("prompt_duration", 0.0))
    remove_prompts = bool(cfg.get("remove_prompts", False))
    a_sr = system.dac.cfg.sample_rate
    max_batches = cfg.get("max_batches")

    n_done = 0
    stage_ms: dict = {}
    for bi, batch in enumerate(loader):
        if max_batches is not None and bi >= int(max_batches):
            break
        try:
            frames = torch.from_numpy(np.asarray(batch["frames"])).to(device)
            gt_audio = batch.get("audio")
            if gt_audio is not None:
                gt_audio = np.asarray(gt_audio, dtype=np.float32)
                if gt_audio.ndim == 4:  # clip-partitioned [B, n, 1, T]
                    gt_audio = gt_audio.transpose(0, 2, 1, 3).reshape(
                        gt_audio.shape[0], 1, -1
                    )
            prompt_codes = None
            if prompt_duration > 0 and gt_audio is not None:
                n_samp = int(prompt_duration * a_sr)
                n_tok = int(prompt_duration * COMPRESSION_MODEL_FRAME_RATE)
                prompt_codes = system.encode_audio(
                    torch.from_numpy(gt_audio[:, :, :n_samp]))[:, :, :n_tok]
            frame_step = int(cfg.get("frame_step", 1) or 1)
            if frame_step > 1:
                # temporal subsample within each segment
                # (reference generate.py:311,345)
                frames = frames[:, :, :, ::frame_step]
            if duration <= model_max_duration:
                item = system.generate(
                    frames, generator=generator,
                    max_new_tokens=total_gen_len,
                    tokens_per_frame=7,
                    audio_prompt_codes=prompt_codes,
                    remove_prompts=remove_prompts,
                    **sampling,
                )
            elif long_mode == "stream_kv":
                item = system.generate_long_kv(
                    frames, generator=generator,
                    total_tokens=total_gen_len,
                    vfps=vfps,
                    window_chunks=int(cfg.get("window_chunks", 4)),
                    chunk_steps=int(cfg.get("chunk_steps", 56)),
                    sink_chunks=int(cfg.get("sink_chunks", 0)),
                    **sampling,
                )
            else:
                item = system.generate_long(
                    frames, generator=generator,
                    total_tokens=total_gen_len,
                    stride_tokens=stride_tokens,
                    model_max_tokens=model_max_tokens,
                    vfps=vfps,
                    **sampling,
                )
            for k, v in item["stage_ms"].items():
                stage_ms[k] = stage_ms.get(k, 0.0) + v
            audio = item["audio"].float().cpu().numpy()
            codes = (
                item["codes"].cpu().numpy()
                if cfg.get("return_sampled_indices")
                else None
            )
            for i in range(audio.shape[0]):
                fn = Path(batch["meta"]["filepath"][i]).name
                if codes is not None:
                    # sampled codebook indices for token-distribution
                    # analysis (reference generate.py:316,358)
                    np.save(out_dir / f"{Path(fn).stem}.codes.npy", codes[i])
                orig_frames = None
                if cfg.get("save_video", True):
                    # re-read the source video so the mux carries original
                    # pixels (reference generate.py:279-285,464-520)
                    try:
                        from vaura_tpu_torch.data import media

                        start = batch["meta"].get("start_pts")
                        start = (
                            float(np.asarray(start)[i])
                            if start is not None
                            else 0.0
                        )
                        orig_frames, _, _ = media.read_video(
                            batch["meta"]["filepath"][i],
                            start=start,
                            duration=duration,
                            fps=vfps,
                            want_audio=False,
                        )
                    except Exception as e:
                        logger.debug("original reload failed for %s: %s", fn, e)
                save_results(
                    audio[i], orig_frames, out_dir, fn,
                    v_fps=vfps, a_fps=a_sr,
                    audio_norm_strategy=audio_norm_strategy,
                )
                if save_original_files and gt_audio is not None:
                    # GT audio next to the generated clip; DAC round-trip by
                    # default (reference generate.py:286-301,428-440)
                    ga = gt_audio[i : i + 1]
                    if compress_original_audio:
                        ga = system.decode_audio(system.encode_audio(
                            torch.from_numpy(ga))).float().cpu().numpy()
                    save_results(
                        ga.reshape(-1), orig_frames, out_dir,
                        f"{Path(fn).stem}_original",
                        v_fps=vfps, a_fps=a_sr,
                        audio_norm_strategy=audio_norm_strategy,
                    )
                n_done += 1
        except Exception as e:
            # per-sample robustness (reference generate.py:386-389)
            logger.error("Error generating batch: %s", e)
            traceback.print_exc()
            continue
    logger.info("Generated %d clips into %s", n_done, out_dir)
    return {"output_dir": str(out_dir), "num_generated": n_done,
            "stage_ms": stage_ms}
