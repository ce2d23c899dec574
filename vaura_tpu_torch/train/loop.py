"""Training loop (the Lightning ``Trainer`` equivalent).

Counterpart of ``vaura_tpu/train/loop.py``: epochs of ``train_step`` with
validation each epoch (or at a fractional ``val_check_interval``), early
stopping on the epoch val loss (reference ``train_utils.py:130-155``), the
learning rate logged each step, top-k + ``last`` checkpoints, an emergency
checkpoint on any exception (reference ``scripts/train.py:91-98``), the
debug knobs (``fast_dev_run``, ``overfit_batches``, ``limit_*_batches``,
``vaura_defaults.yaml:63-67``), TensorBoard media of the predict sample and
of tracked training files, and a profiler trace (``profiler: jax``, the
schema's one value, takes a ``torch.profiler`` trace of steps 3-6 of epoch
0 into ``<root>/profile``).

Device placement: batches come from the loader as host numpy and are copied
to the system's device, double-buffered (``prefetch_batches``, default 2;
0 or 1 copies each batch when it is taken). The system holds every tensor;
the ``TrainState`` names the trainable ones (``split_params``), which are
updated in place.

The JAX loop compiles its media hooks once and caches the compiled
functions (``cached_jit``); eager PyTorch compiles nothing, so there is
nothing to cache and no counterpart.

Under a mesh (``Trainer(..., mesh=)``: one process per card, the system
placed by ``parallel.shard_module``) every rank steps on its rows of each
batch and validates, tests and generates the predict media with the others
(the model is sharded); rank 0 alone writes the TensorBoard file and the
checkpoints, which hold whole leaves (``TrainState.state_dict`` gathers
them), and the other ranks wait for it at a barrier. The tracked training
files' rows lie on some ranks only, while the sharded weights need every
rank in each forward: on a step whose batch holds one, every rank gathers
the whole batch's rows (``MeshPlacement.gather_rows``) and runs their
greedy forward replicated (``VauraSystem.replicated``), and rank 0 writes
the audio (JAX ``loop.py:339-389``). ``scale_lr_with_device_count``
counts the processes of the run.
"""

from __future__ import annotations

import logging
import math
import time
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from vaura_tpu_torch.models.vaura import VauraSystem
from vaura_tpu_torch.parallel.multihost import (
    barrier,
    is_main_process,
    process_count,
)
from vaura_tpu_torch.train.checkpoint import CheckpointManager
from vaura_tpu_torch.train.state import (
    TrainState,
    build_schedule,
    copy_leaves,
    make_optimizer,
)
from vaura_tpu_torch.train.steps import (
    batch_to_device,
    make_eval_step,
    make_train_step,
    prefetch_to_device,
    split_params,
)
from vaura_tpu_torch.utils import StageClock
from vaura_tpu_torch.utils.tb import TBLogger
from vaura_tpu_torch.utils.viz import attn_rows_to_video, scale_to_01

logger = logging.getLogger(__name__)


class EarlyStopping:
    """Min-mode early stop on epoch val loss (reference uses Lightning
    ``EarlyStopping(val_loss_epoch, patience)``)."""

    def __init__(self, patience: int = 3, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = float("inf")
        self.count = 0

    def update(self, value: float) -> bool:
        """Returns True if training should stop."""
        if value < self.best - self.min_delta:
            self.best = value
            self.count = 0
            return False
        self.count += 1
        return self.count >= self.patience


class _NoTB:
    """The TensorBoard logger of a rank that does not write."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


class Trainer:
    """``fit`` and ``test`` of a ``VauraSystem``. ``stats`` collects the
    times of the run: each train step's ``clock`` milliseconds (forward,
    backward, optimizer), each validation's milliseconds, each epoch's
    predict-media seconds, and each checkpoint save's and restore's
    seconds. With a ``mesh`` the system (whole weights, the same on every
    rank) is placed on it here."""

    def __init__(
        self,
        system: VauraSystem,
        trainer_cfg: Dict[str, Any],
        model_cfg: Dict[str, Any],
        log_dirs: Dict[str, Any],
        mesh=None,
    ):
        self.system = system
        self.device = system.device
        self.cfg = trainer_cfg
        self.model_cfg = model_cfg
        self.dirs = log_dirs
        self.mesh = mesh
        if mesh is not None:
            from vaura_tpu_torch.parallel import shard_module

            shard_module(system, mesh)
        self.main = is_main_process()
        self.tb = TBLogger(str(log_dirs["root"])) if self.main else _NoTB()
        self.tb.add_custom_scalar_layout(system.num_codebooks)
        self.ckpt = CheckpointManager(
            log_dirs["checkpoints"],
            async_save=bool(trainer_cfg.get("async_checkpointing", False)),
            writes=self.main,
        )
        self.early_stop = EarlyStopping(
            patience=int(trainer_cfg.get("early_stop_patience", 3) or 10**9)
        )
        fdr = trainer_cfg.get("fast_dev_run", False)
        self.fast_dev_run = int(fdr) if fdr else 0
        self.stats: Dict[str, list] = {"step_ms": [], "val_ms": [],
                                       "media_s": [], "save_s": [],
                                       "restore_s": []}

    # ------------------------------------------------------------------ #
    def _limit(self, key: str, n: int) -> int:
        lim = self.cfg.get(key)
        if self.fast_dev_run:
            return min(n, self.fast_dev_run)
        if lim is None:
            return n
        if isinstance(lim, float) and lim <= 1.0:
            return max(1, int(n * lim))
        return min(n, int(lim))

    def _put(self, batch: dict) -> dict:
        return batch_to_device(batch, self.device, mesh=self.mesh)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _profiler(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def _stop_profiler(self, prof) -> None:
        self._sync()
        prof.stop()
        out = Path(self.dirs["root"]) / "profile"
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))
        logger.info("profiler trace written to %s", out)

    # ------------------------------------------------------------------ #
    def fit(
        self,
        datamodule,
        generator: Optional[torch.Generator] = None,
        resume_path: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Train on ``datamodule``; the dropout masks come from
        ``generator``. ``resume_path`` restores a checkpoint's parameters,
        optimizer state, step and early-stop state, and continues at the
        epoch after it (an emergency checkpoint: at its own epoch). Returns
        ``{"state", "frozen", "generator"}``."""
        cfg = self.cfg
        system = self.system
        trainable, frozen = split_params(system)

        base_lr = float(self.model_cfg.get("learning_rate", 1e-3))
        if cfg.get("scale_lr_with_device_count") or cfg.get(
                "scale_lr_with_gpu_count"):
            # sqrt(world) LR scaling (reference train_utils.py:282-283)
            base_lr *= math.sqrt(process_count())
        schedule = build_schedule(self.model_cfg.get("lr_scheduler"), base_lr)
        tx = make_optimizer(
            schedule,
            weight_decay=float(self.model_cfg.get("weight_decay", 0.0)),
            betas=tuple(self.model_cfg.get("betas", (0.9, 0.95))),
            gradient_clip_val=cfg.get("gradient_clip_val", 1.0),
            gradient_clip_algorithm=cfg.get("gradient_clip_algorithm", "value"),
            accumulate_grad_batches=int(cfg.get("accumulate_grad_batches", 1) or 1),
            mu_dtype=self.model_cfg.get("adam_mu_dtype"),
            nu_dtype=self.model_cfg.get("adam_nu_dtype"),
        )
        state = TrainState.create(trainable, tx, self.system.placement)
        start_epoch = 0
        if resume_path:
            t0 = time.time()
            state.load_state_dict(self.ckpt.restore(resume_path))
            self._sync()
            self.stats["restore_s"].append(time.time() - t0)
            # resume at the saved epoch + callback state (the reference's
            # Lightning ckpt_path resume restores both, scripts/train.py:93)
            meta = CheckpointManager.read_meta(resume_path) or {}
            # a crash checkpoint marks its epoch incomplete -> re-run that
            # epoch (Lightning resume re-runs the in-progress epoch); a
            # regular end-of-epoch save continues at the next one
            saved_epoch = int(meta.get("epoch", -1))
            start_epoch = (
                saved_epoch
                if meta.get("epoch_complete") is False
                else saved_epoch + 1
            )
            self.early_stop.best = float(
                meta.get("early_stop_best", self.early_stop.best)
            )
            self.early_stop.count = int(
                meta.get("early_stop_count", self.early_stop.count)
            )
            logger.info(
                "Resumed from %s at step %s (epoch %d)",
                resume_path, state.step, start_epoch,
            )

        placement = system.placement
        self.ckpt.save_frozen(frozen if placement is None
                              else placement.full_tree(frozen))
        train_step = make_train_step(system)
        eval_step = make_eval_step(system)

        max_epochs = self.fast_dev_run and 1 or int(cfg.get("max_epochs", 50))
        min_epochs = int(cfg.get("min_epochs", 1))
        overfit = int(cfg.get("overfit_batches", 0) or 0)
        profiler = cfg.get("profiler")
        prof = None

        train_loader = datamodule.train_dataloader()
        val_loader = datamodule.val_dataloader()

        vci = cfg.get("val_check_interval", 1.0)
        tracked = set(self.model_cfg.get("files_to_track_during_training") or [])

        global_step = int(state.step)
        stop = False
        epoch = start_epoch
        try:
            for epoch in range(start_epoch, max_epochs):
                if stop:
                    break
                train_loader.set_epoch(epoch)
                n_batches = self._limit("limit_train_batches", len(train_loader))
                if overfit:
                    n_batches = min(n_batches, overfit)
                epoch_losses = []
                t_epoch = time.time()
                cached_batches = []
                # double-buffered H2D: batch N+1's copy is issued before
                # step N's result is read (prefetch_batches=0 disables)
                n_prefetch = int(cfg.get("prefetch_batches", 2) or 0)
                it = iter(train_loader)
                if n_prefetch > 1:
                    it = prefetch_to_device(it, n_prefetch, self.device,
                                            self.mesh)
                for bi in range(n_batches):
                    if overfit and bi < len(cached_batches):
                        batch = cached_batches[bi]
                    else:
                        batch = next(it) if n_prefetch > 1 else self._put(next(it))
                        if overfit:
                            cached_batches.append(batch)
                    if profiler == "jax" and epoch == 0 and bi == 3:
                        prof = self._profiler()
                    clock = StageClock(self.device)
                    clock.mark("start")
                    state, metrics = train_step(state, batch, generator,
                                                clock=clock)
                    if prof is not None and bi == 6:
                        self._stop_profiler(prof)
                        prof = None
                    global_step += 1
                    loss = float(metrics["loss"])
                    self.stats["step_ms"].append(clock.ms())
                    epoch_losses.append(loss)
                    self.tb.scalar("train_loss_step", loss, global_step)
                    self.tb.scalar(
                        "lr",
                        float(schedule(global_step))
                        if callable(schedule)
                        else schedule,
                        global_step,
                    )
                    if tracked:
                        self._log_tracked_files(batch, global_step)
                    # mid-epoch validation (fractional val_check_interval,
                    # reference vaura_defaults.yaml:58)
                    if (
                        isinstance(vci, float)
                        and 0 < vci < 1.0
                        and (bi + 1) % max(1, int(n_batches * vci)) == 0
                        and bi + 1 < n_batches
                    ):
                        v_loss, _ = self._run_eval(
                            eval_step, val_loader,
                            self._limit("limit_val_batches", len(val_loader)),
                        )
                        self.tb.scalar("val_loss_step", v_loss, global_step)
                if prof is not None:  # an epoch of fewer than 7 steps
                    self._stop_profiler(prof)
                    prof = None
                train_loss = float(np.mean(epoch_losses)) if epoch_losses else float("nan")
                self.tb.scalar("train_loss_epoch", train_loss, global_step)

                # ---------------- predict-run media logging ----------------
                if self.model_cfg.get("predict_at_val_start") and not self.fast_dev_run:
                    t0 = time.time()
                    try:
                        self._log_predict_media(datamodule, generator,
                                                global_step)
                    except Exception as e:
                        logger.warning("predict-media logging failed: %s", e,
                                       exc_info=True)
                    self.stats["media_s"].append(time.time() - t0)

                # ---------------- validation ----------------
                val_loss, val_per_cb = self._run_eval(
                    eval_step, val_loader,
                    self._limit("limit_val_batches", len(val_loader)),
                )
                self.tb.scalar("val_loss_epoch", val_loss, global_step)
                self.tb.scalars_per_codebook(
                    "val_loss_per_codebook", val_per_cb, global_step
                )
                logger.info(
                    "epoch %d: train %.4f val %.4f (%.1fs)",
                    epoch, train_loss, val_loss, time.time() - t_epoch,
                )
                if epoch + 1 >= min_epochs and self.early_stop.update(val_loss):
                    logger.info("early stopping at epoch %d", epoch)
                    stop = True
                t0 = time.time()
                self.ckpt.save(
                    state, epoch, global_step, val_loss,
                    metadata={
                        "early_stop_best": self.early_stop.best,
                        "early_stop_count": self.early_stop.count,
                    },
                )
                self.stats["save_s"].append(time.time() - t0)
                if self.fast_dev_run:
                    break
        except BaseException:
            # emergency checkpoint (reference scripts/train.py:91-98);
            # carries the callback state so a resume doesn't silently
            # reset early stopping
            self.ckpt.save_emergency(
                state, epoch,
                metadata={
                    "step": global_step,
                    "early_stop_best": self.early_stop.best,
                    "early_stop_count": self.early_stop.count,
                },
            )
            raise
        finally:
            if prof is not None:
                prof.stop()
            # commit any in-flight async save before the run returns
            # (test action / resume may read `last` right after fit), and
            # let no rank read it before rank 0 wrote it
            self.ckpt.finalize()
            self.tb.flush()
            barrier()

        return {"state": state, "frozen": frozen, "generator": generator}

    # ------------------------------------------------------------------ #
    def _run_eval(self, eval_step, loader, n_batches):
        t0 = time.time()
        losses, per_cbs = [], []
        it = iter(loader)
        for _ in range(n_batches):
            m = eval_step(self._put(next(it)))
            losses.append(float(m["loss"]))
            per_cbs.append(m["loss_per_codebook"].float().cpu().numpy())
        self.stats["val_ms"].append((time.time() - t0) * 1e3)
        if not losses:
            return float("nan"), np.zeros(self.system.num_codebooks)
        return float(np.mean(losses)), np.mean(per_cbs, axis=0)

    @torch.no_grad()
    def _log_tracked_files(self, batch, step):
        """Greedy-decode audio for tracked training files and log it
        (reference ``_log_training_samples``, ``vaura_model.py:618-636``):
        the argmax of the teacher-forced logits through the DAC decoder.
        Under a mesh every rank gathers the whole batch's file names and,
        when one is tracked, its frames and audio from every rank's rows,
        runs the forward replicated, and only rank 0's logger writes; a
        failure there raises, as the ranks' collectives would no longer
        pair."""
        if self.mesh is None:
            try:
                self._tracked_audio(batch, step)
            except Exception as e:
                logger.warning("tracked-file logging failed: %s", e,
                               exc_info=True)
            return
        place = self.system.placement
        files = (batch.get("meta") or {}).get("filepath")
        if not isinstance(files, list):
            return
        files = place.gather_list(files)
        if not self._tracked_idxs(files):
            return
        whole = {"meta": {"filepath": files},
                 "audio": place.gather_rows(batch["audio"])}
        if batch.get("frames") is not None:
            whole["frames"] = place.gather_rows(batch["frames"])
        with self.system.replicated():
            self._tracked_audio(whole, step)

    def _tracked_idxs(self, files) -> list:
        tracked = set(self.model_cfg.get("files_to_track_during_training") or [])
        return [i for i, f in enumerate(files) if Path(str(f)).stem in tracked]

    def _tracked_audio(self, batch, step):
        files = (batch.get("meta") or {}).get("filepath")
        if not isinstance(files, list):
            return
        idxs = self._tracked_idxs(files)
        if not idxs:
            return
        sel = torch.as_tensor(idxs, device=self.device)
        frames = batch.get("frames")
        _, aux = self.system.train_forward(
            None if frames is None else frames[sel], batch["audio"][sel],
            None, train=False)
        tokens = torch.argmax(aux["logits"], dim=-1)
        wav = np.clip(self.system.decode_audio(tokens).float().cpu()
                      .numpy(), -1, 1)
        sr = self.system.dac.cfg.sample_rate
        for j, i in enumerate(idxs):
            name = Path(str(files[i])).stem
            self.tb.audio(
                f"generated_audio_of_training_data/{name}",
                wav[j, 0], step, sr,
            )

    @torch.no_grad()
    def _log_predict_media(self, datamodule, generator, step):
        """Generate audio for one predict sample and log audio +
        conditioned-frames video to TB (reference
        ``on_validation_epoch_start`` + ``_log_predict_run``,
        ``vaura_model.py:349-388,638-688``). The generation's KV cache lives
        inside ``generate`` and is freed when it returns."""
        system = self.system
        item = next(iter(datamodule.predict_dataloader()))
        frames = np.asarray(item["frames"])
        frames_dev = torch.from_numpy(frames).to(self.device)
        # reference uses 221 tokens when vis feats are flattened, else 48
        # (vaura_model.py:644-649)
        n_tokens = 221 if self.model_cfg.get("flatten_vis_feats") else 48
        n_tokens = min(n_tokens, system.sampler_config.block_size_audio - 16)
        out = system.generate(frames_dev, generator=generator,
                              max_new_tokens=n_tokens, top_k=128,
                              decode_to_audio=True)
        audio = np.clip(out["audio"].float().cpu().numpy(), -1, 1)
        codes = out["codes"]
        sr = system.dac.cfg.sample_rate
        name = "sample_0"
        if isinstance(item.get("meta"), dict):
            fps = item["meta"].get("filepath")
            if isinstance(fps, list) and fps:
                name = str(Path(fps[0]).stem)
        self.tb.audio(f"generated_audio/{name}", audio[0, 0], step, sr)
        # conditioned frames: [B, S, C, T, H, W] -> [S*T, H, W, C]
        fr = frames[0]
        video = scale_to_01(
            fr.transpose(0, 2, 3, 4, 1).reshape(-1, *fr.shape[-2:], fr.shape[1])
        )
        self.tb.video(f"conditioned_frames/{name}", video, step, fps=25)
        if self.model_cfg.get("plot_distr_of_pred_indices", True):
            # predicted-token-index distribution (reference
            # ``plot_distr_of_pred_indices``, vaura_model.py:651-668)
            self.tb.histogram(
                f"sampled_indices/{name}", codes.cpu().numpy().ravel(), step
            )
        if self.model_cfg.get("return_attention_weights"):
            # teacher-forced forward over the generated codes with every
            # layer's attention probabilities -> per-step attention-row
            # video of the last layer (reference attention-weight videos,
            # train_utils.py:204-255)
            try:
                pattern = system.pattern_provider.get_pattern(codes.shape[-1])
                seq, _, _ = pattern.build_pattern_sequence(
                    codes[:, :, :-1], system.special_token_id)
                vis_feats = system.visual_features(frames_dev)
                _, probs = system.sampler(seq, vis_feats, False,
                                          return_attn_probs=True)
                attn = probs[-1, 0].float().cpu().numpy()  # [S, S]
                self.tb.video(
                    f"s_attention_weights/{name}",
                    attn_rows_to_video(attn),
                    step,
                    fps=10,
                )
            except Exception as e:
                logger.warning("attention-video logging failed: %s", e,
                               exc_info=True)

    def test(self, datamodule,
             params: Optional[Mapping[str, torch.Tensor]] = None
             ) -> Dict[str, float]:
        """Teacher-forced test loss (reference ``scripts/test.py:97-99``).
        ``params`` (trainable leaves by name, e.g. a checkpoint's) are
        copied into the system first."""
        trainable, _ = split_params(self.system)
        if params is not None and self.system.placement is not None:
            self.system.placement.load_full_(trainable, params, "params")
        elif params is not None:
            copy_leaves(trainable, params, "params")
        eval_step = make_eval_step(self.system)
        loader = datamodule.test_dataloader()
        n = self._limit("limit_test_batches", len(loader))
        loss, per_cb = self._run_eval(eval_step, loader, n)
        self.tb.scalar("test_loss_epoch", loss, 0)
        self.tb.scalars_per_codebook("test_loss_per_codebook", per_cb, 0)
        self.tb.flush()
        return {"test_loss": loss}
