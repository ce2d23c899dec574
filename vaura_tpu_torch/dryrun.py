"""A sharded training step and sharded generation on a ``(data, fsdp,
model)`` mesh: the port's counterpart of ``__graft_entry__.py``'s
``_midsize_system`` and ``dryrun_multichip(n)``.

The mid-size system is the JAX package's: a decoder of 4 layers x 512 with
9 codebooks of 1024 (+ the special token), 8 heads, remat on; the real DAC
strides (hop 512 at 44.1 kHz) at reduced channel width; a ViT at the real
224/16 patch geometry with 2 blocks of 96. Weights are drawn from a seeded
generator (the LM head zero, as JAX initialises it, so the first loss is
``ln 1024``), the DAC codebooks folded into the token embeddings. ``n``
ranks factor as JAX factors ``n`` devices: 8 -> 2 x 2 x 2, 4 -> 1 x 2 x 2,
2 -> 1 x 2 x 1. One training step (AdamW 1e-4, decay 0.01, clipping 1.0)
on a batch of ``data * fsdp`` clips (frames ``[B, 2, 3, 4, 224, 224]``,
audio ``[B, 1, 512 * 96]``), then generation of 24 tokens (top-k 8, CFG 3)
from features ``[B, 8, 96]`` down to audio, gathered to every rank. JAX's
record (``MULTICHIP_r05.json``): mesh 2 x 2 x 2, loss 6.9315, codes (4, 9,
24), audio (4, 1, 12288).

Run it

    torchrun --nproc_per_node=N -m vaura_tpu_torch.dryrun     # N cards
    python -m vaura_tpu_torch.dryrun --n 8 --platform cpu      # 8 gloo processes

``--system flagship`` runs the flagship training configuration
(``flagship.py``) instead: greedy generation of 221 tokens for 2 clips from
seeded frames, then one training step on a seeded batch; ``--mesh`` sets
the factoring (``run(None, ...)`` runs the same in one process without a
mesh, the reference a sharded run is held to). ``--out`` writes rank 0's
result (loss, codes, audio) with ``torch.save``. ``--n`` spawns gloo
processes on the CPU and so needs ``--platform cpu``: on cards the
processes come from ``torchrun``.
"""

from __future__ import annotations

import argparse
import math
import os
import socket
import subprocess
import sys
from typing import Optional, Tuple

import numpy as np
import torch

FLAGSHIP_BATCH = 2
GEN_KW = dict(max_new_tokens=24, tokens_per_frame=7, use_sampling=True,
              temp=1.0, top_k=8, cfg_scale=3.0, decode_buckets=2)


def factor(n: int) -> Tuple[int, int, int]:
    """``(data, fsdp, model)`` of ``n`` ranks, JAX's ``dryrun_multichip``
    rule."""
    if n % 4 == 0:
        return n // 4, 2, 2
    if n % 2 == 0:
        return n // 2, 2, 1
    return n, 1, 1


def midsize_system(device, seed: int = 0):
    """The mid-size system with seeded weights (see the module
    docstring)."""
    from vaura_tpu_torch.models.dac.model import DacConfig
    from vaura_tpu_torch.models.motionformer import MotionFormerConfig
    from vaura_tpu_torch.models.sampler import SamplerConfig
    from vaura_tpu_torch.models.vaura import VauraSystem
    from vaura_tpu_torch.utils import seeded_init_

    sampler = SamplerConfig(
        num_layers=4, d_model=512, d_codebook=1024, num_codebooks=9, nhead=8,
        block_size_audio=128, block_size_video=32, dropout=0.0,
        cond_in_dim=96,  # the reduced-width encoder's embed_dim
        cond_feature_channel_scaler=4,  # cond 128 + token 384 = 512
        codebook_dim=8, remat=True, dtype=torch.float32)
    dac = DacConfig(encoder_dim=8, encoder_rates=(2, 4, 8, 8),
                    decoder_dim=128, decoder_rates=(8, 8, 4, 2),
                    latent_dim=384, n_codebooks=9, codebook_size=1024,
                    codebook_dim=8)
    enc = MotionFormerConfig(img_size=224, patch_size=16, embed_dim=96,
                             depth=2, num_heads=4, temporal_resolution=2,
                             z_block_size=2, drop_path_rate=0.0,
                             dtype=torch.float32)
    system = VauraSystem(sampler, dac, enc, freeze_feature_extractor=True,
                         device=device)
    seeded_init_(system, torch.Generator(device=device).manual_seed(seed))
    torch.nn.init.zeros_(system.sampler.lm_head.weight)
    system.load_dac_embeddings_into_sampler()
    return system


def _midsize_inputs(B: int, device):
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((B, 2, 3, 4, 224, 224)).astype(np.float32)
    audio = (rng.standard_normal((B, 1, 512 * 96)) * 0.1).astype(np.float32)
    vis = rng.standard_normal((B, 8, 96)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)
    return {"frames": t(frames), "audio": t(audio)}, t(vis)


def run(mesh_shape: Optional[Tuple[int, int, int]] = "auto",
        device_type: str = "cuda", system_kind: str = "midsize",
        seed: int = 0) -> dict:
    """This rank's part of the dry run; returns ``{"mesh", "loss",
    "codes", "audio", "trainable_params", "launches"}`` (codes and audio of
    the whole batch; the kernels' launches of the run). ``mesh_shape`` "auto" factors the run's processes; None runs
    without a mesh. A launched process joins its process group first."""
    from vaura_tpu_torch.parallel import make_mesh, multihost, shard_module
    from vaura_tpu_torch.parallel.mesh import batch_rows
    from vaura_tpu_torch.train.state import TrainState, make_optimizer
    from vaura_tpu_torch.train.steps import make_train_step, split_params
    from vaura_tpu_torch.utils import resolve_device

    multihost.initialize_distributed(device_type=device_type)
    device = resolve_device(None if device_type == "cuda" else device_type)
    if mesh_shape == "auto":
        mesh_shape = factor(multihost.process_count())
    mesh = None if mesh_shape is None else make_mesh(
        *mesh_shape, device_type=device_type)
    B_ways = 1 if mesh is None else mesh_shape[0] * mesh_shape[1]

    if system_kind == "midsize":
        system = midsize_system(device, seed)
        B = B_ways
        train_batch, vis = _midsize_inputs(B, device)
        gen_kw = dict(GEN_KW, vis_feats=vis)
        gen_in = None
        make_tx = lambda: make_optimizer(1e-4, weight_decay=0.01,
                                         gradient_clip_val=1.0)
    else:
        from vaura_tpu_torch.flagship import (
            GENERATE_KW,
            LR_SCHEDULER,
            TRAIN_KW,
            flagship_system,
            random_frames,
            random_train_batch,
        )
        from vaura_tpu_torch.train.state import build_schedule

        gen = torch.Generator(device=device).manual_seed(seed)
        system = flagship_system(device, gen, training=True)
        B = FLAGSHIP_BATCH
        gen_in = random_frames(B, gen, device)
        train_batch = random_train_batch(B, gen, device)
        gen_kw = dict(GENERATE_KW, use_sampling=False)
        kw = dict(TRAIN_KW)
        lr = build_schedule(LR_SCHEDULER, kw.pop("learning_rate"))
        make_tx = lambda: make_optimizer(lr, **kw)
    # the whole system's trainable leaves (a rank holds parts of them)
    n_params = sum(p.numel() for p in split_params(system)[0].values())
    if mesh is not None:
        shard_module(system, mesh)
        rows = batch_rows(mesh, B)
        train_batch = {k: v[rows] for k, v in train_batch.items()}
        if gen_in is not None:
            gen_in = gen_in[rows]
        if "vis_feats" in gen_kw:
            gen_kw["vis_feats"] = gen_kw["vis_feats"][rows]
    trainable, _ = split_params(system)
    out = {"mesh": mesh_shape, "trainable_params": n_params}

    def generate():
        r = system.generate(gen_in, seed=seed + 2, decode_to_audio=True,
                            gather="all" if mesh is not None else None,
                            **gen_kw)
        return r["codes"], r["audio"]

    step = make_train_step(system)
    drop = torch.Generator(device=device).manual_seed(seed + 1)
    before = launch_counts()
    if system_kind == "flagship":  # generation first: the weights as seeded
        out["codes"], out["audio"] = generate()
    state = TrainState.create(trainable, make_tx(), system.placement)
    state, metrics = step(state, train_batch, drop)
    out["loss"] = float(metrics["loss"])
    if system_kind == "midsize":  # JAX's order: generation after the step
        out["codes"], out["audio"] = generate()
    out["launches"] = {k: v - before[k] for k, v in launch_counts().items()}
    return out


def launch_counts() -> dict:
    """The kernel wrappers' launch counters (``ops/``), by kernel."""
    from vaura_tpu_torch.ops import decode_attention as da
    from vaura_tpu_torch.ops import divided_attention as ga
    from vaura_tpu_torch.ops import encoder_fused as ef
    from vaura_tpu_torch.ops import mla_decode_attention as mla

    return {"decode_attention": da.launches - da.int8_launches
            - da.int4_launches - da.int8_dots_launches,
            "decode_attention_int8": da.int8_launches,
            "decode_attention_int4": da.int4_launches,
            "decode_attention_int8_dots": da.int8_dots_launches,
            "encoder_attention": ef.attention_launches,
            "encoder_mlp": ef.mlp_launches,
            "grouped_cls_attention": ga.launches,
            "mla_decode_attention": mla.launches}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n: int, timeout: float = 600.0) -> dict:
    """The mid-size dry run in ``n`` gloo processes on the CPU; returns rank
    0's result (its codes and audio on the host)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.pt")
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "vaura_tpu_torch.dryrun", "--platform",
             "cpu", "--out", out],
            env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                     LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port), OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n)]
        texts = []
        try:
            for p in procs:
                texts.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for p, text in zip(procs, texts):
            if p.returncode != 0:
                raise RuntimeError(f"dryrun rank failed:\n{text[-4000:]}")
        result = torch.load(out, weights_only=False)
    print(texts[0], end="")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=None,
                    help="spawn this many gloo processes on the CPU (with "
                         "--platform cpu)")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--system", choices=("midsize", "flagship"),
                    default="midsize")
    ap.add_argument("--mesh", default="auto",
                    help="DxFxM or 'auto' (JAX's factoring)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.n is not None and args.platform != "cpu":
        ap.error("--n spawns gloo processes on the CPU: pass --platform cpu "
                 "(on cards, start the ranks with torchrun)")
    if args.n is not None:
        r = dryrun_multichip(args.n)
        return 0 if math.isfinite(r["loss"]) else 1
    if args.platform == "cpu":
        torch.set_num_threads(1)
    mesh = ("auto" if args.mesh == "auto"
            else tuple(int(x) for x in args.mesh.lower().split("x")))
    r = run(mesh, args.platform, args.system)
    from vaura_tpu_torch.parallel import multihost

    codes, audio = r["codes"], r["audio"]
    if multihost.is_main_process():
        print(f"dryrun_multichip: {r['trainable_params'] / 1e6:.1f}M "
              "trainable params")
        print(f"dryrun_multichip: mesh={r['mesh']} loss={r['loss']:.4f} OK")
        print(f"dryrun_multichip: sharded generation OK (codes "
              f"{tuple(codes.shape)}, audio {tuple(audio.shape)})")
        if args.out:
            torch.save({**r, "codes": codes.cpu(), "audio": audio.cpu()},
                       args.out)
    ok = math.isfinite(r["loss"]) and bool(torch.isfinite(audio).all())
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
