"""Dataset/DataLoader/DataModule core (numpy only).

Counterpart of ``vaura_tpu/data/core.py``, kept as the port's own copy so
that both packages draw the same batches: datasets yield numpy dicts of
fixed shapes, the loader collates on the host and prefetches batches on
background threads or processes, and datamodules expose the
``setup()`` + ``{train,val,test,predict}_dataloader()`` surface. The caller
moves a batch to the device.

Per-worker seeding mirrors the reference's ``worker_init_fn`` numpy reseed
(``vggsound_datamodule.py:140-142``): each epoch derives per-item seeds from
(base seed, epoch, index) so results are reproducible regardless of thread
scheduling.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np


class Dataset:
    """Map-style dataset: ``__len__`` + ``__getitem__(idx) -> dict``."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> dict:
        raise NotImplementedError


def default_collate(items: List[dict]) -> dict:
    """Stack numpy-able leaves on a new batch axis; lists of
    strings/objects stay lists (meta)."""
    assert items
    out: Dict[str, Any] = {}
    first = items[0]
    for key, value in first.items():
        vals = [it[key] for it in items]
        if isinstance(value, dict):
            out[key] = default_collate(vals)
        elif isinstance(value, np.ndarray) or (
            np.isscalar(value) and not isinstance(value, (str, bytes))
        ):
            out[key] = np.stack([np.asarray(v) for v in vals])
        else:
            out[key] = vals
    return out


class DataLoader:
    """Batched iteration with deterministic shuffling and parallel
    prefetch. ``drop_last=True`` by default: fixed batch shapes, as the JAX
    package's loader gives them.

    ``worker_type``:
      - ``"thread"`` (default): background threads. Right choice when the
        per-item cost is dominated by the native media decoder
        (``data/media.py`` releases the GIL) or numpy.
      - ``"process"``: ``multiprocessing`` workers (the reference's torch
        ``num_workers`` semantics). Right choice for GIL-bound Python
        transforms. Batches are collated in the worker and shipped back
        whole.

    In-flight work is bounded by ``num_workers + prefetch`` batches in
    both modes (backpressure — workers cannot race arbitrarily far ahead
    of the consumer).
    """

    def __init__(
        self,
        dataset: Dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = True,
        num_workers: int = 0,
        prefetch: int = 2,
        collate_fn: Callable[[List[dict]], dict] = default_collate,
        worker_type: str = "thread",
    ):
        assert worker_type in ("thread", "process"), worker_type
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = max(prefetch, 1)
        self.collate_fn = collate_fn
        self.worker_type = worker_type
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> List[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(order)
        batches = []
        end = n - (n % self.batch_size) if self.drop_last else n
        for i in range(0, end, self.batch_size):
            batches.append(order[i : i + self.batch_size])
        return batches

    def _load_batch(self, idxs: np.ndarray) -> dict:
        return self.collate_fn([self.dataset[int(i)] for i in idxs])

    def __iter__(self) -> Iterator[dict]:
        batches = self._index_batches()
        if self.num_workers <= 0:
            for idxs in batches:
                yield self._load_batch(idxs)
            return
        if self.worker_type == "process":
            yield from self._iter_processes(batches)
        else:
            yield from self._iter_threads(batches)

    def _iter_threads(self, batches: List[np.ndarray]) -> Iterator[dict]:
        """Thread workers pull batch indices from a queue and publish
        results in order; a semaphore bounds in-flight batches to
        ``num_workers + prefetch``."""
        results: Dict[int, dict] = {}
        results_lock = threading.Condition()
        work: "queue.Queue" = queue.Queue()
        for i, idxs in enumerate(batches):
            work.put((i, idxs))
        stop = threading.Event()
        inflight = threading.BoundedSemaphore(self.num_workers + self.prefetch)

        def worker():
            while not stop.is_set():
                if not inflight.acquire(timeout=1.0):
                    continue
                try:
                    i, idxs = work.get_nowait()
                except queue.Empty:
                    inflight.release()
                    return
                batch = self._load_batch(idxs)
                with results_lock:
                    results[i] = batch
                    results_lock.notify_all()

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()
        try:
            for i in range(len(batches)):
                with results_lock:
                    while i not in results:
                        results_lock.wait(timeout=60.0)
                    batch = results.pop(i)
                inflight.release()
                yield batch
        finally:
            stop.set()

    def _iter_processes(self, batches: List[np.ndarray]) -> Iterator[dict]:
        """Multiprocessing workers (torch ``num_workers`` analogue). The
        work queue is fed incrementally — at most ``num_workers +
        prefetch`` batches are in flight — so worker memory stays
        bounded. Uses fork when available (no dataset pickling); spawn
        otherwise (dataset/collate_fn must pickle)."""
        method = "fork" if "fork" in mp.get_all_start_methods() else "spawn"
        ctx = mp.get_context(method)
        work_q = ctx.Queue()
        result_q = ctx.Queue()
        n_workers = min(self.num_workers, len(batches))
        procs = [
            ctx.Process(
                target=_process_worker,
                args=(self.dataset, self.collate_fn, work_q, result_q),
                daemon=True,
            )
            for _ in range(n_workers)
        ]
        for p in procs:
            p.start()
        try:
            feed = 0
            window = n_workers + self.prefetch
            while feed < min(window, len(batches)):
                work_q.put((feed, np.asarray(batches[feed])))
                feed += 1
            pending: Dict[int, dict] = {}
            for i in range(len(batches)):
                while i not in pending:
                    j, payload = result_q.get(timeout=300.0)
                    if isinstance(payload, _WorkerError):
                        raise RuntimeError(
                            f"DataLoader worker failed on batch {j}:\n"
                            f"{payload.traceback}"
                        )
                    pending[j] = payload
                if feed < len(batches):
                    work_q.put((feed, np.asarray(batches[feed])))
                    feed += 1
                yield pending.pop(i)
        finally:
            for _ in procs:
                work_q.put(None)
            for p in procs:
                p.join(timeout=10.0)
                if p.is_alive():
                    p.terminate()


class _WorkerError:
    """Picklable error marker carrying the worker's traceback."""

    def __init__(self, tb: str):
        self.traceback = tb


def _process_worker(dataset, collate_fn, work_q, result_q) -> None:
    """Top-level (picklable under spawn) process-worker loop."""
    while True:
        item = work_q.get()
        if item is None:
            return
        i, idxs = item
        try:
            batch = collate_fn([dataset[int(k)] for k in idxs])
            result_q.put((i, batch))
        except BaseException:  # noqa: BLE001 — ship any failure to parent
            import traceback

            result_q.put((i, _WorkerError(traceback.format_exc())))


class DataModule:
    """Reference LightningDataModule surface (SURVEY.md §2.2)."""

    def setup(self, stage: Optional[str] = None) -> None:
        raise NotImplementedError

    def train_dataloader(self) -> DataLoader:
        raise NotImplementedError

    def val_dataloader(self) -> DataLoader:
        raise NotImplementedError

    def test_dataloader(self) -> DataLoader:
        raise NotImplementedError

    def predict_dataloader(self) -> DataLoader:
        raise NotImplementedError
