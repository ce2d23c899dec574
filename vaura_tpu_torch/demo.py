"""The demo: frames of a video -> 2.56 s of audio in one chunk, and longer
audio in chunks, as WAV (and MP4 where the media library is built).

Counterpart of the repo's ``demo.py`` (reference ``demo.ipynb`` cells
3-8): the flagship system from the module configs
(``configs/modules/...``: ``llama_9cbs``, ``dac_8kbps_wrapper``,
``avclip_vggsound``, ``delayed_9cbs``) with seeded random weights, or the
model and weights of a reference checkpoint (``--ckpt``: a Lightning
``.ckpt`` or experiment directory, converted on load; or a checkpoint of
this package's Trainer), every weight rounded to bf16 as the JAX demo's
``cast_floats`` rounds them. ``--config`` takes the ``model`` section of a
config file instead (``configs/experiments/dummy.yaml``: the tiny model).

Input: ``--video clip.mp4`` (decoded at 25 fps, short side 256, centre crop
224; needs the native media library, ``data/media.py``), or ``--frames
x.npy``: ``[S, 3, T, 224, 224]`` float segments as the encoder takes them,
or raw ``[N, H, W, 3]`` uint8 frames at 25 fps, cropped and normalised as a
video's. Without either: the first bundled clip under ``data/demo``, else a
synthesised one. Output under ``--out``: ``generated.wav`` (and
``generated.mp4`` for a video input where the library can mux), and with
``--long-duration`` above 2.56 s ``generated_long.wav``
(``VauraSystem.generate_long``, stride 0.64 s).

Usage::

    python -m vaura_tpu_torch.demo [--video clip.mp4 | --frames x.npy]
        [--ckpt path] [--duration 2.56] [--long-duration 5.12] [--out demo_out]
        [--greedy] [--platform cpu]
"""

from __future__ import annotations

import argparse
import logging
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger("vaura_tpu_torch.demo")

REPO = Path(__file__).resolve().parents[1]
MODULE_CONFIGS = {
    "sampler_config": "configs/modules/samplers/llama_9cbs.yaml",
    "audio_encoder_config": "configs/modules/audio_codecs/dac_8kbps_wrapper.yaml",
    "feature_extractor_config":
        "configs/modules/feature_extractors/avclip_vggsound.yaml",
    "pattern_provider_config":
        "configs/modules/codebook_patterns/delayed_9cbs.yaml",
}
SEED = 666  # the weights' and the draws' seed, as the JAX demo's
TOKENS_PER_SECOND = 86
MODEL_MAX_DURATION = 2.56
STRIDE_S = 0.64
FPS = 25.0


def flagship_model_config() -> dict:
    """The model section the JAX demo builds from the module configs."""
    from vaura_tpu_torch.config import load_config

    cfg = {k: load_config(REPO / v) for k, v in MODULE_CONFIGS.items()}
    cfg["freeze_feature_extractor"] = True
    return cfg


def load_system(ckpt: Optional[str] = None, model_cfg: Optional[dict] = None,
                device=None):
    """The demo's system (see the module docstring), weights rounded to
    bf16, no graph."""
    from vaura_tpu_torch.models.factory import build_system
    from vaura_tpu_torch.scripts.generate import _round_params_to_bf16_
    from vaura_tpu_torch.utils import seeded_init_
    from vaura_tpu_torch.utils.reference_ckpt import (
        is_reference_checkpoint,
        load_reference_experiment,
    )
    from vaura_tpu_torch.utils.seeding import seed_everything

    ref = ckpt is not None and is_reference_checkpoint(ckpt)
    state_dicts = None
    if ref:
        model_cfg, state_dicts, path = load_reference_experiment(ckpt)
        logger.info("using reference checkpoint %s", path)
    elif model_cfg is None:
        model_cfg = flagship_model_config()
    system = build_system(model_cfg, device=device,
                          param_dtype=torch.bfloat16)
    seeded_init_(system, seed_everything(SEED, system.device))
    system.load_dac_embeddings_into_sampler()
    if state_dicts is not None:
        system.load_state_dicts(state_dicts)
    elif ckpt is not None:
        from vaura_tpu_torch.train.checkpoint import load_base_

        load_base_(system, ckpt)
        logger.info("loaded checkpoint %s", ckpt)
    else:
        logger.warning("no checkpoint: generating with random weights")
    system.requires_grad_(False)
    _round_params_to_bf16_(system)
    return system


def segments_from_rgb(frames: np.ndarray, seg_t: int, size: int = 224
                      ) -> np.ndarray:
    """Raw ``[N, H, W, 3]`` uint8 frames -> ``[1, S, 3, seg_t, size,
    size]`` float32 in [-1, 1]: centre crop, whole segments of ``seg_t``
    frames."""
    H, W = frames.shape[1:3]
    if min(H, W) < size:
        raise ValueError(f"frames {H}x{W} are smaller than {size}")
    y0, x0 = (H - size) // 2, (W - size) // 2
    frames = frames[:, y0:y0 + size, x0:x0 + size]
    frames = (frames.astype(np.float32) / 255.0 - 0.5) / 0.5
    n_seg = frames.shape[0] // seg_t
    if n_seg == 0:
        raise ValueError(f"{frames.shape[0]} frames: fewer than one segment "
                         f"of {seg_t}")
    frames = frames[: n_seg * seg_t].reshape(n_seg, seg_t, size, size, 3)
    return np.transpose(frames, (0, 4, 1, 2, 3))[None]


def load_frames(path: str | Path, seg_t: int, size: int = 224) -> np.ndarray:
    """``--frames``: ``[S, 3, T, size, size]`` segments (float) or raw
    ``[N, H, W, 3]`` uint8 frames -> ``[1, S, 3, T, size, size]``."""
    a = np.load(path)
    if a.ndim == 4 and a.shape[-1] == 3 and a.dtype == np.uint8:
        return segments_from_rgb(a, seg_t, size)
    if a.ndim == 5 and a.shape[1] == 3 and a.shape[-2:] == (size, size):
        return a.astype(np.float32)[None]
    raise ValueError(f"{path}: frames {a.shape} {a.dtype}; expected "
                     f"[S, 3, T, {size}, {size}] float or [N, H, W, 3] uint8")


def video_frames(video: Path, seconds: float, seg_t: int) -> np.ndarray:
    """A video's frames at 25 fps (short side 256) as segments."""
    from vaura_tpu_torch.data import media

    frames, _, _ = media.read_video(video, duration=seconds, fps=FPS,
                                    min_side=256, want_audio=False)
    return segments_from_rgb(frames, seg_t)


def synthesize_demo_video(path: Path, seconds: float = 4.0) -> None:
    """A moving test pattern with click audio (the JAX demo's stand-in for
    the bundled clips)."""
    from vaura_tpu_torch.data import media

    n = int(seconds * FPS)
    h = w = 256
    t = np.arange(n)[:, None, None]
    y = np.arange(h)[None, :, None]
    x = np.arange(w)[None, None, :]
    chans = (((x + t * 6) % 256), ((y + t * 3) % 256), ((x + y) % 256))
    frames = np.stack([np.broadcast_to(c, (n, h, w)) for c in chans],
                      axis=-1).astype(np.uint8)
    sr = 44100
    audio = np.zeros(int(seconds * sr), np.float32)
    for k in range(int(seconds * 4)):  # 4 clicks a second
        i = int(k * sr / 4)
        audio[i:i + 200] = 0.8 * np.hanning(200)
    media.write_video(path, frames, fps=FPS, audio=audio,
                      audio_sample_rate=sr)


def run_demo(system, frames: np.ndarray, out: Path, duration: float = 2.56,
             long_duration: float = 0.0, cfg_scale: float = 6.0,
             temperature: float = 0.95, top_k: int = 128,
             greedy: bool = False, mux: bool = False) -> dict:
    """Generate from ``frames [1, S, 3, T, H, W]`` and write the WAVs (and
    with ``mux`` the MP4) under ``out``; returns ``{"codes", "audio"[,
    "codes_long", "audio_long"], "files"}``."""
    from vaura_tpu_torch.ops.audio import write_wav

    out.mkdir(parents=True, exist_ok=True)
    sr = system.dac.cfg.sample_rate
    sampling = dict(use_sampling=not greedy, temp=temperature, top_k=top_k,
                    cfg_scale=cfg_scale)
    generator = torch.Generator(device=system.device).manual_seed(SEED)
    x = torch.from_numpy(np.ascontiguousarray(frames)).to(system.device)
    tokens = int(duration * TOKENS_PER_SECOND)
    seg_for_chunk = max(math.ceil(duration / STRIDE_S), 1)
    logger.info("single-chunk generation: %d tokens", tokens)
    r = system.generate(x[:, :seg_for_chunk], generator=generator,
                        max_new_tokens=tokens, tokens_per_frame=7, **sampling)
    audio = np.clip(r["audio"].float().cpu().numpy(), -1, 1)
    write_wav(out / "generated.wav", audio[0], sr)
    result = {"codes": r["codes"].cpu(), "audio": audio,
              "files": [out / "generated.wav"]}
    if mux:
        from vaura_tpu_torch.data import media

        rgb = frames[0, :seg_for_chunk].transpose(0, 2, 3, 4, 1)
        media.write_video(out / "generated.mp4",
                          rgb.reshape(-1, *rgb.shape[2:]) * 0.5 + 0.5,
                          fps=FPS, audio=audio[0, 0], audio_sample_rate=sr)
        result["files"].append(out / "generated.mp4")
    if long_duration > MODEL_MAX_DURATION:
        total = int(long_duration * TOKENS_PER_SECOND)
        logger.info("chunked generation: %d tokens", total)
        r = system.generate_long(
            x, generator=generator, total_tokens=total,
            stride_tokens=int(STRIDE_S * TOKENS_PER_SECOND), **sampling)
        audio = np.clip(r["audio"].float().cpu().numpy(), -1, 1)
        write_wav(out / "generated_long.wav", audio[0], sr)
        result.update(codes_long=r["codes"].cpu(), audio_long=audio)
        result["files"].append(out / "generated_long.wav")
    for f in result["files"]:
        logger.info("wrote %s", f)
    return result


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--video", type=Path, default=None)
    ap.add_argument("--frames", type=Path, default=None,
                    help="[S, 3, T, 224, 224] float or [N, H, W, 3] uint8 .npy")
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--config", type=Path, default=None,
                    help="a config file whose model section to build")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default=None)
    ap.add_argument("--duration", type=float, default=2.56)
    ap.add_argument("--long-duration", type=float, default=0.0,
                    help="above 2.56 s: also the chunked generation")
    ap.add_argument("--out", type=Path, default=Path("demo_out"))
    ap.add_argument("--cfg-scale", type=float, default=6.0)
    ap.add_argument("--temperature", type=float, default=0.95)
    ap.add_argument("--top-k", type=int, default=128)
    ap.add_argument("--greedy", action="store_true")
    args = ap.parse_args(argv)

    model_cfg = None
    if args.config is not None:
        from vaura_tpu_torch.config import load_config

        model_cfg = load_config(args.config)["model"]
    system = load_system(args.ckpt, model_cfg, args.platform)
    enc = system.encoder.cfg
    seg_t = enc.temporal_resolution * enc.z_block_size
    seconds = max(args.duration, args.long_duration) + 0.66
    mux = False
    if args.frames is not None:
        frames = load_frames(args.frames, seg_t, enc.img_size)
    else:
        from vaura_tpu_torch.data import media

        video = args.video
        if video is None:
            bundled = sorted((REPO / "data" / "demo").glob("*.mp4"))
            video = bundled[0] if bundled else args.out / "demo_input.mp4"
            if not video.exists():
                args.out.mkdir(parents=True, exist_ok=True)
                synthesize_demo_video(video)
        frames = video_frames(video, seconds, seg_t)
        mux = media.available()
    logger.info("frames -> %d segments", frames.shape[1])
    return run_demo(system, frames, args.out, args.duration,
                    args.long_duration, args.cfg_scale, args.temperature,
                    args.top_k, args.greedy, mux)


if __name__ == "__main__":
    main()
