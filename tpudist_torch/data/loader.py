"""Batched, prefetching data loader and the device prefetcher.

``DataLoader`` is the port's copy of ``tpudist/data/loader.py``: a thread
pool assembles each batch into one numpy buffer (PIL's decode and the
native kernels release the GIL), and a bounded queue lets batch N+1
assemble while step N trains. A failing sample is retried, then skipped within a
per-epoch budget, as in tpudist, and the ``decode_fail`` fault point
(``faults.decode_should_fail``) fails a load inside that retry loop.
``set_cursor`` continues an interrupted epoch mid-way (the sampler's
cursor) with the interrupted attempt's meters, and ``set_skip_windows``
replays an epoch minus the doctor's poisoned windows.

``DevicePrefetcher`` is the counterpart of ``tpudist.dist.DevicePrefetcher``
(``--device_prefetch``): it hands out batches already on the device, and
``poke()`` stages the next one (a copy into pinned host memory and a
``non_blocking`` host-to-device copy on the current stream) while the
step just launched runs on the card.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from tpudist_torch import faults


class DataLoader:
    def __init__(self, dataset, batch_size: int, sampler=None,
                 transform: Optional[Callable] = None,
                 num_workers: int = 4, prefetch: int = 2,
                 drop_last: bool = True, round_up_to: Optional[int] = None,
                 seed: int = 0, retries: int = 2,
                 retry_backoff: float = 0.05, skip_budget: int = 0):
        """``transform(sample, rng) -> np.ndarray`` runs in the worker
        threads, with the per-sample generator ``default_rng((seed, epoch,
        index))``. ``sampler`` yields dataset indices (None = sequential).
        With ``drop_last=False``, ``round_up_to=k`` pads the final partial
        batch by wrapping to a multiple of k.

        A failing read, decode or transform is retried ``retries`` times
        with linear ``retry_backoff`` seconds, then the sample is skipped:
        counted in ``samples_skipped`` and its slot refilled with the next
        loadable sample of the same batch. Past ``skip_budget`` distinct
        skipped samples in one epoch the loader raises (0 = the first
        persistent failure raises). ``samples_retried`` counts loads that a
        retry healed; both meters restart every epoch."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.transform = transform
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        self.round_up_to = round_up_to
        self.seed = seed
        self.epoch = 0
        self.retries = max(0, retries)
        self.retry_backoff = max(0.0, retry_backoff)
        self.skip_budget = max(0, skip_budget)
        self.samples_skipped = 0
        self.samples_retried = 0
        self._stats_lock = threading.Lock()
        self._failed_keys: set[int] = set()   # distinct bad samples, per epoch
        # The meters an interrupted attempt of this epoch had counted:
        # the next __iter__ starts from them.
        self._carry_skipped = 0
        self._carry_retried = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def set_cursor(self, consumed: int, samples_skipped: int = 0,
                   samples_retried: int = 0) -> None:
        """Continue this epoch at global position ``consumed`` (the
        sampler's cursor; call after ``set_epoch``), with the meters
        starting at the interrupted attempt's counts."""
        if self.sampler is not None:
            self.sampler.set_cursor(consumed)
        self._carry_skipped = max(0, int(samples_skipped))
        self._carry_retried = max(0, int(samples_retried))

    def set_skip_windows(self, windows) -> None:
        """The doctor's rollback replay: cut the poisoned global-position
        windows out of this epoch's order (the sampler's
        ``set_skip_windows``; call after ``set_epoch``)."""
        if self.sampler is not None and hasattr(self.sampler,
                                                "set_skip_windows"):
            self.sampler.set_skip_windows(windows)

    def _index_batches(self) -> list[np.ndarray]:
        if self.sampler is not None:
            idx = np.fromiter(iter(self.sampler), dtype=np.int64)
        else:
            idx = np.arange(len(self.dataset))
        n_full = len(idx) // self.batch_size
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(n_full)]
        rest = idx[n_full * self.batch_size:]
        if not self.drop_last and len(rest):
            if self.round_up_to and len(rest) % self.round_up_to:
                pad = self.round_up_to - len(rest) % self.round_up_to
                rest = np.concatenate([rest, idx[:pad]])
            batches.append(rest)
        return batches

    def __len__(self) -> int:
        return len(self._index_batches())

    def _load_sample(self, ds_index: int):
        """One sample through read → decode → transform, retried; the last
        error is re-raised once the retries are spent. An armed
        ``decode_fail`` point fails the attempt before the read."""
        last_err = None
        for attempt in range(self.retries + 1):
            try:
                if faults.decode_should_fail(ds_index):
                    raise IOError(
                        f"injected decode failure (sample {ds_index})")
                sample, label = self.dataset[ds_index]
                if self.transform is not None:
                    rng = np.random.default_rng(
                        (self.seed, self.epoch, ds_index))
                    sample = self.transform(sample, rng)
                sample = np.asarray(sample, dtype=np.float32)
                if attempt:
                    with self._stats_lock:
                        self.samples_retried += 1
                return sample, label
            except Exception as e:           # noqa: BLE001 — re-raised below
                last_err = e
                if attempt < self.retries and self.retry_backoff > 0:
                    time.sleep(self.retry_backoff * (attempt + 1))
        raise last_err

    def _fill(self, batch_idx: np.ndarray, pos: int):
        """The sample for slot ``pos``: its own, or else the next loadable
        one of the batch. Each distinct bad sample is charged to the skip
        budget once an epoch, and a known-bad one is not loaded again."""
        last_err = None
        for k in range(len(batch_idx)):
            cand = int(batch_idx[(pos + k) % len(batch_idx)])
            with self._stats_lock:
                if cand in self._failed_keys:
                    continue
            try:
                return self._load_sample(cand)
            except Exception as e:           # noqa: BLE001 — counted below
                last_err = e
                with self._stats_lock:
                    if cand not in self._failed_keys:
                        self._failed_keys.add(cand)
                        self.samples_skipped += 1
                    skipped = self.samples_skipped
                if skipped > self.skip_budget:
                    raise RuntimeError(
                        f"data-path corruption budget exceeded: {skipped} "
                        f"sample(s) still failing after {self.retries} "
                        f"retries (budget {self.skip_budget}); last error "
                        f"on sample {cand}: {e}") from e
        raise RuntimeError(f"no loadable sample in the batch: all "
                           f"{len(batch_idx)} candidates failed") from last_err

    def _assemble(self, batch_idx: np.ndarray):
        images = None
        labels = np.empty((len(batch_idx),), dtype=np.int64)
        cursor = iter(range(len(batch_idx)))
        lock = threading.Lock()
        errors: list[BaseException] = []

        def worker():
            nonlocal images
            while True:
                with lock:
                    pos = next(cursor, None)
                if pos is None or errors:
                    return
                try:
                    sample, label = self._fill(batch_idx, pos)
                except Exception as e:       # noqa: BLE001 — re-raised below
                    errors.append(e)
                    return
                with lock:
                    if images is None:
                        images = np.empty((len(batch_idx),) + sample.shape,
                                          np.float32)
                images[pos] = sample
                labels[pos] = label

        threads = [threading.Thread(target=worker)
                   for _ in range(min(self.num_workers, len(batch_idx)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return images, labels

    def __iter__(self) -> Iterator:
        batches = self._index_batches()
        with self._stats_lock:               # the meters are per epoch
            self.samples_skipped = self._carry_skipped
            self.samples_retried = self._carry_retried
            self._carry_skipped = self._carry_retried = 0
            self._failed_keys = set()
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            for b in batches:
                if stop.is_set():
                    return
                try:
                    batch = self._assemble(b)
                except BaseException as e:   # noqa: BLE001 — crosses threads
                    put(e)                   # fail loudly on the consumer side
                    return
                if not put(batch):
                    return
            put(None)

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


def to_device(images: np.ndarray, labels: np.ndarray, device: torch.device):
    """A host batch on ``device``: through pinned memory and a
    ``non_blocking`` copy on the current stream when it is a CUDA card."""
    imgs, lbls = torch.from_numpy(images), torch.from_numpy(labels)
    if device.type != "cuda":
        return imgs.to(device), lbls.to(device)
    return (imgs.pin_memory().to(device, non_blocking=True),
            lbls.pin_memory().to(device, non_blocking=True))


class DevicePrefetcher:
    """Iterate ``loader`` with batch N+1 staged on the device while step
    N runs: the trainer calls ``poke()`` right after launching a step."""

    def __init__(self, loader, device: torch.device):
        self.loader = loader
        self.device = device
        self.last_local_bs = 0
        self._it = None
        self._next = None
        self._poked = False

    def __len__(self) -> int:
        return len(self.loader)

    def _stage(self) -> None:
        item = next(self._it, None)
        self._next = None if item is None else (
            *to_device(*item, self.device), len(item[1]))

    def poke(self) -> float:
        """Stage the next batch now; returns the host seconds it took."""
        t0 = time.time()
        if not self._poked:
            self._stage()
            self._poked = True
        return time.time() - t0

    def __iter__(self):
        self._it = iter(self.loader)
        self._stage()
        while self._next is not None:
            images, labels, self.last_local_bs = self._next
            self._next, self._poked = None, False
            yield images, labels
            if not self._poked:
                self._stage()
