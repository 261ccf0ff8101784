"""Batched, prefetching data loader with deterministic resume.

The port's copy of ``opticalflow_tpu.data.loader``: a thread pool fetches
samples and a background thread assembles batches into a bounded queue, so
host decode overlaps the step.  With ``device=`` the producer thread also
moves each batch to the card: the stacked arrays are pinned
(``pin_memory()``) and copied with ``non_blocking=True`` on the current
stream, which orders the copy before the steps queued after it, and the
host does not wait for it.  Batches keep the JAX layout (NHWC ``images`` and
``flow``, (B, H, W) masks) that ``train.trainer.batch_to_device`` takes.

Determinism: sample order is a per-epoch permutation from a counter-based
seed, and ``state()``/``restore()`` capture (epoch, position) — what exact
resume needs.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch

__all__ = ["Loader", "Subset", "train_val_split", "process_shard"]


class Subset:
    """Index-remapped view of a dataset (deterministic train/val splits)."""

    def __init__(self, dataset, indices):
        self.ds = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.ds[self.indices[i]]

    def get(self, i, epoch=0):
        if hasattr(self.ds, "get"):
            return self.ds.get(self.indices[i], epoch=epoch)
        return self.ds[self.indices[i]]


def train_val_split(dataset, val_frac: float, seed: int = 0):
    """Deterministic (seeded-shuffle) split into (train, val) Subsets."""
    n = len(dataset)
    idx = np.arange(n)
    np.random.default_rng(seed).shuffle(idx)
    n_val = max(1, int(round(n * val_frac))) if val_frac > 0 else 0
    if n_val == 0 or n_val >= n:
        return Subset(dataset, idx), None
    return Subset(dataset, idx[n_val:]), Subset(dataset, idx[:n_val])


def process_shard(dataset, process_id: int, process_count: int) -> Subset:
    """Disjoint per-process stride-slice for multi-process training,
    truncated to a common length so every process runs the same number of
    (collective) steps per epoch regardless of ``len % process_count``."""
    n = len(dataset)
    idx = list(range(process_id, n, process_count))[: n // process_count]
    return Subset(dataset, idx)


class _ProducerError:
    """Envelope carrying a prefetch-thread exception to the consumer."""

    def __init__(self, err: BaseException):
        self.err = err


def _collate(samples):
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out


def _to_device(batch, device: torch.device):
    """Stacked arrays → tensors on ``device``: pinned, then copied without
    blocking the host (other values pass through)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v)
            if device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=True)
        else:
            out[k] = v
    return out


class Loader:
    """Iterate dicts of stacked numpy arrays (or, with ``device``, tensors
    on that device) over an indexable dataset.

    Datasets exposing ``get(idx, epoch)`` (deterministic augmentation) are
    used that way; plain ``__getitem__`` otherwise.
    """

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 4,
                 prefetch: int = 2, seed: int = 0,
                 device: Optional[torch.device | str] = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.device = None if device is None else torch.device(device)
        self.epoch = 0
        self._start_batch = 0

    # ------------------------------------------------------------ state
    def state(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "batch": self._start_batch,
                "seed": self.seed}

    def restore(self, state: Dict[str, int]) -> None:
        self.epoch = int(state["epoch"])
        self._start_batch = int(state["batch"])
        self.seed = int(state.get("seed", self.seed))

    def __len__(self) -> int:
        n = len(self.ds) // self.batch_size
        if not self.drop_last and len(self.ds) % self.batch_size:
            n += 1
        return n

    # --------------------------------------------------------- iteration
    def _order(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(idx)
        return idx

    def _fetch(self, idx: int, epoch: int):
        if hasattr(self.ds, "get"):
            return self.ds.get(int(idx), epoch=epoch)
        return self.ds[int(idx)]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        epoch = self.epoch
        order = self._order(epoch)
        nb = len(self)
        start = self._start_batch
        # _start_batch keeps counting from the (possibly restored) offset as
        # batches are consumed, so state() always reports the ABSOLUTE epoch
        # position: a state() taken after restore({batch: 5}) and one batch
        # says 6, not 1.  The offset clears when the epoch completes
        # (below); an abandoned iterator leaves (epoch, position) where it
        # stopped.

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # stop-aware put: if the consumer abandoned the iterator the
            # queue may stay full forever — don't strand the thread on it
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(start, nb):
                        if stop.is_set():
                            return
                        lo = b * self.batch_size
                        ids = order[lo:lo + self.batch_size]
                        samples = list(pool.map(
                            lambda i: self._fetch(i, epoch), ids))
                        batch = _collate(samples)
                        if self.device is not None:
                            batch = _to_device(batch, self.device)
                        if not put(batch):
                            return
                put(None)   # stop-aware: the consumer may have left already
            except BaseException as e:   # fetch/collate/copy fault
                # a dead producer must not strand the consumer on q.get()
                # forever — hand the exception over to be re-raised
                put(_ProducerError(e))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, _ProducerError):
                    raise batch.err
                self._start_batch += 1
                yield batch
        finally:
            stop.set()
        self.epoch = epoch + 1
        self._start_batch = 0
