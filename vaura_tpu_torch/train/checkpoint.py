"""Checkpoints of the port.

Counterpart of ``vaura_tpu/train/checkpoint.py``, with the same directory
semantics: top-k by ``val_loss`` plus a ``last`` symlink (the reference's
Lightning ``ModelCheckpoint``, ``utils/train_utils.py:136-144``), the ledger
rebuilt from ``meta.json`` when a manager opens a directory, frozen
submodules stored once under ``frozen/``, and the emergency crash checkpoint
(``utils/train_utils.py:101-110``).

A checkpoint is a directory holding ``state.pt`` (``torch.save`` of
``{"params": {name: tensor}, "opt_state": OptState.state_dict(), "step":
int}``, CPU tensors) and ``meta.json``. The JAX package writes orbax trees,
which only JAX reads: a directory without ``state.pt`` raises ``ValueError``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import torch

from vaura_tpu_torch.train.state import (
    build_schedule,
    copy_leaves,
    make_optimizer,
)
from vaura_tpu_torch.utils.experiment import (
    checkpoint_name,
    resolve_best_checkpoint,
    timestamp_dirname,
)

STATE_FILE = "state.pt"


def _to_host(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor copied to the host (a copy even
    of a CPU tensor, so later in-place updates do not reach a write in
    flight)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, Mapping):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


def _resolve(path: str | Path) -> Path:
    path = Path(path)
    if path.is_symlink():
        path = path.parent / path.readlink()
    return path


def load_state(path: str | Path) -> Any:
    """The payload of a checkpoint directory's ``state.pt`` or of a
    ``torch.save`` file, memory-mapped on the host (a restore reads only
    the tensors it uses)."""
    path = _resolve(path)
    if path.is_dir():
        if not (path / STATE_FILE).exists():
            raise ValueError(
                f"{path} holds no {STATE_FILE}: not a checkpoint of this "
                "package. A checkpoint of the JAX package's own training "
                "(an orbax tree) needs JAX to read, which this package does "
                "not import; restore it with the JAX package")
        path = path / STATE_FILE
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def _write(path: Path, payload: Any) -> None:
    """``payload`` into ``path/state.pt``, through a temporary name so a
    reader never sees half a file."""
    tmp = path / (STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path / STATE_FILE)


class CheckpointManager:
    def __init__(
        self,
        ckpt_dir: str | Path,
        top_k: int = 3,
        save_last: bool = True,
        async_save: bool = False,
    ):
        self.ckpt_dir = Path(ckpt_dir)
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.top_k = top_k
        self.save_last = save_last
        self.async_save = async_save
        # the top-k ledger of the checkpoints already on disk, so a resumed
        # run prunes against them too
        self._saved: list[tuple[float, Path]] = sorted(
            (
                (float(meta["val_loss"]), p)
                for p in self.ckpt_dir.iterdir()
                if p.is_dir() and not p.is_symlink()
                for meta in [self.read_meta(p)]
                if meta is not None and "val_loss" in meta
            ),
            key=lambda t: t[0],
        )
        # async_save: save() copies the tensors to the host, then a thread
        # writes them; the bookkeeping that must see the written directory
        # (meta.json, top-k prune, `last`) waits for the next save /
        # restore / finalize()
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[Exception] = None
        self._pending: Optional[tuple[Path, dict, float]] = None

    # ------------------------------------------------------------------ #
    def _save_raw(self, path: Path, payload: Any) -> None:
        path.mkdir(parents=True)
        payload = _to_host(payload)
        if not self.async_save:
            _write(path, payload)
            return

        def write():
            try:
                _write(path, payload)
            except Exception as e:  # re-raised by finalize()
                self._write_error = e

        self._writer = threading.Thread(target=write, daemon=True)
        self._writer.start()

    def finalize(self) -> None:
        """Block until any in-flight async save committed (re-raising its
        failure), then run its deferred bookkeeping. Idempotent; no-op for
        sync managers."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._write_error is not None:
            # the failed save gets no bookkeeping
            err, self._write_error, self._pending = self._write_error, None, None
            raise err
        if self._pending is None:
            return
        path, meta, val_loss = self._pending
        self._pending = None
        (path / "meta.json").write_text(json.dumps(meta))
        # an overwritten same-named checkpoint must not keep its stale
        # ledger entry (pruning through it would delete the fresh write)
        self._saved = [t for t in self._saved if t[1] != path]
        self._saved.append((val_loss, path))
        self._saved.sort(key=lambda t: t[0])
        if self.save_last:
            last = self.ckpt_dir / "last"
            if last.is_symlink():
                last.unlink()
            elif last.exists():
                shutil.rmtree(last, ignore_errors=True)
            last.symlink_to(path.name)
        # keep the top-k by val_loss PLUS the newest save while `last`
        # points at it; it becomes prunable once `last` moves on
        keep = {p for _, p in self._saved[: self.top_k]}
        if self.save_last:
            keep.add(path)
        for entry in [t for t in self._saved if t[1] not in keep]:
            self._saved.remove(entry)
            shutil.rmtree(entry[1], ignore_errors=True)

    # ------------------------------------------------------------------ #
    def save_frozen(self, frozen_params: Mapping[str, Any]) -> None:
        """Persist frozen submodules once per run (synchronous)."""
        self.finalize()
        path = self.ckpt_dir / "frozen"
        if path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True)
        _write(path, _to_host(frozen_params))

    def restore_frozen(self) -> Dict[str, Any]:
        self.finalize()
        return load_state(self.ckpt_dir / "frozen")

    # ------------------------------------------------------------------ #
    def save(
        self,
        state: Any,
        epoch: int,
        step: int,
        val_loss: float,
        metadata: Optional[dict] = None,
    ) -> Path:
        """Save a ``TrainState``'s params, optimizer state and step; keep
        the top-k by val_loss + last. With ``async_save`` the call returns
        once the tensors are on the host; the write and the bookkeeping
        complete at the next save / restore / ``finalize()``."""
        self.finalize()  # at most one save in flight
        path = self.ckpt_dir / checkpoint_name(epoch, step, val_loss)
        if path.exists():
            shutil.rmtree(path)
        self._save_raw(path, state.state_dict())
        meta = {"epoch": epoch, "step": step, "val_loss": float(val_loss)}
        meta.update(metadata or {})
        self._pending = (path, meta, float(val_loss))
        if not self.async_save:
            self.finalize()
        return path

    def save_emergency(
        self, state: Any, epoch: int, tag: str = "",
        metadata: Optional[dict] = None,
    ) -> Path:
        """Crash checkpoint, always synchronous, named
        ``e{epoch}_last_at_<timestamp>{tag}``; its ``meta.json`` marks the
        epoch incomplete (``epoch_complete: false``) and carries
        ``metadata`` (callback state), never a ``val_loss``: it does not
        enter the top-k ledger."""
        self.finalize()
        name = f"e{epoch}_last_at_{timestamp_dirname(jitter=False)}{tag}"
        path = self.ckpt_dir / name
        path.mkdir(parents=True)
        _write(path, _to_host(state.state_dict()))
        meta = {"epoch": int(epoch), "epoch_complete": False}
        meta.update(metadata or {})
        meta.pop("val_loss", None)
        (path / "meta.json").write_text(json.dumps(meta))
        return path

    # ------------------------------------------------------------------ #
    def restore(self, path: str | Path) -> Dict[str, Any]:
        """``{"params", "opt_state", "step"}`` of a checkpoint (``last``
        included), tensors on the host; ``TrainState.load_state_dict``
        takes it."""
        self.finalize()
        return load_state(path)

    def restore_best(self) -> Dict[str, Any]:
        best = resolve_best_checkpoint(self.ckpt_dir)
        if best is None:
            raise FileNotFoundError(f"no checkpoints under {self.ckpt_dir}")
        return self.restore(best)

    @staticmethod
    def read_meta(path: str | Path) -> Optional[dict]:
        """``meta.json`` of a checkpoint (epoch/step/val_loss + extras);
        an emergency checkpoint without one carries only its epoch, parsed
        from its ``e{epoch}_last_at_...`` name, and is incomplete. None for
        unrecognisable paths."""
        path = _resolve(path)
        meta_file = path / "meta.json"
        if meta_file.exists():
            try:
                return json.loads(meta_file.read_text())
            except (OSError, json.JSONDecodeError):
                return None
        m = re.match(r"e(\d+)_last_at_", path.name)
        if m:
            return {"epoch": int(m.group(1)), "epoch_complete": False}
        return None


def restore_trainable_params(
    ckpt_path, trainable: Mapping[str, torch.Tensor], model_cfg: dict,
    trainer_cfg: Optional[dict] = None,
) -> Dict[str, torch.Tensor]:
    """The trainable parameters of a params-only file (``{"params":
    {name: tensor}}`` or the bare mapping) or of a training checkpoint
    (``{"params", "opt_state", "step"}``). ``trainable`` names every leaf
    (real or ``meta`` tensors: only names, shapes and dtypes are read). For
    a training checkpoint the optimizer is rebuilt from the configs, as the
    Trainer builds it, and the stored state must fit it. Returns the
    tensors in ``trainable``'s dtypes on the ``trainable`` tensors' device
    (the host for ``meta`` ones)."""
    trainer_cfg = trainer_cfg or {}
    payload = load_state(ckpt_path)
    if isinstance(payload, Mapping) and "opt_state" in payload:
        tx = make_optimizer(
            build_schedule(
                model_cfg.get("lr_scheduler"),
                float(model_cfg.get("learning_rate", 1e-3)),
            ),
            weight_decay=float(model_cfg.get("weight_decay", 0.0)),
            betas=tuple(model_cfg.get("betas", (0.9, 0.95))),
            gradient_clip_val=trainer_cfg.get("gradient_clip_val", 1.0),
            gradient_clip_algorithm=trainer_cfg.get(
                "gradient_clip_algorithm", "value"
            ),
            accumulate_grad_batches=int(
                trainer_cfg.get("accumulate_grad_batches", 1) or 1
            ),
            mu_dtype=model_cfg.get("adam_mu_dtype"),
            nu_dtype=model_cfg.get("adam_nu_dtype"),
        )
        skeleton = tx.init({k: v.to("meta") for k, v in trainable.items()})
        skeleton.load_state_dict(payload["opt_state"])
    params = payload["params"] if "params" in payload else payload
    out = {k: torch.empty_like(v, device="meta") for k, v in trainable.items()}
    copy_leaves(out, params, "params")  # names and shapes
    return {k: params[k].to(device="cpu" if v.is_meta else v.device,
                            dtype=v.dtype)
            for k, v in trainable.items()}


@torch.no_grad()
def load_trainable_(system, ckpt_path, model_cfg: dict,
                    trainer_cfg: Optional[dict] = None) -> None:
    """Restore the trainable parameters of ``system`` (``split_params``:
    sampler, bridge, an unfrozen encoder) from ``ckpt_path``, in place."""
    from vaura_tpu_torch.train.steps import split_params

    trainable, _ = split_params(system)
    restored = restore_trainable_params(ckpt_path, trainable, model_cfg,
                                        trainer_cfg)
    for k, t in trainable.items():
        t.copy_(restored[k])


@torch.no_grad()
def load_base_(system, path) -> None:
    """Load the base weights of ``system`` (all but its LoRA adapters) from
    ``path``, in place: a reference checkpoint (a Lightning ``.ckpt``, or a
    directory holding one; converted), or a checkpoint of this package,
    either a whole tree (``{"params": {name: tensor}}`` or the bare mapping,
    as ``CheckpointManager.save_frozen`` writes it) or a training run's
    checkpoint (its trainable parameters). Every sampler parameter must be
    there; a name the system lacks raises ``ValueError`` (a LoRA run's
    checkpoint holds adapters, not a base), as does an orbax tree of the
    JAX package (``load_state``)."""
    from vaura_tpu_torch.utils.reference_ckpt import (
        is_reference_checkpoint,
        resolve_ckpt,
    )

    if is_reference_checkpoint(path):
        from vaura_tpu_torch.models.convert import convert_vaura_checkpoint

        system.load_state_dicts(convert_vaura_checkpoint(
            str(resolve_ckpt(path))))
        return
    payload = load_state(path)
    params = payload["params"] if "params" in payload else payload
    own = {k: v for k, v in system.named_parameters()
           if not k.startswith("lora_sampler.")}
    unknown = sorted(set(params) - set(own))
    if unknown:
        raise ValueError(
            f"{path} holds parameters this system does not have "
            f"({unknown[:3]}...): not a base checkpoint of this model (a LoRA "
            "run's checkpoint holds its adapters, not the base)")
    missing = sorted(k for k in own if k.startswith("sampler.")
                     and k not in params)
    if missing:
        raise ValueError(f"{path} lacks sampler parameters ({missing[:3]}...)")
    copy_leaves({k: own[k] for k in params}, params, "params")


def lora_base_checkpoint(hparams: Optional[dict],
                         checkpoints_dir: Optional[Path]) -> Optional[Path]:
    """Where the base weights of a LoRA run are: the run's ``frozen/`` save
    (``Trainer.fit`` writes it, and with LoRA it holds the base sampler the
    adapters trained over), else, for a run without one, the
    ``finetune.init_from`` its ``hparams.yaml`` carries, an outside path
    that may have moved or been overwritten since; None when neither
    exists."""
    if checkpoints_dir is not None and (
            Path(checkpoints_dir) / "frozen" / STATE_FILE).exists():
        return Path(checkpoints_dir) / "frozen"
    init_from = ((hparams or {}).get("finetune") or {}).get("init_from")
    return Path(init_from) if init_from else None
