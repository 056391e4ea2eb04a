"""Batched, prefetching data loader and the device prefetcher.

``DataLoader`` is the port's copy of ``tpudist/data/loader.py``: a thread
pool assembles each batch into one numpy buffer (numpy's generators and
PIL release the GIL), and a bounded queue lets batch N+1 assemble while
step N trains. The retry/skip path for failing samples comes with the
ImageFolder data.

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
from typing import Iterator, Optional

import numpy as np
import torch


class DataLoader:
    def __init__(self, dataset, batch_size: int, sampler=None,
                 num_workers: int = 4, prefetch: int = 2,
                 drop_last: bool = True, round_up_to: Optional[int] = None):
        """``sampler`` yields dataset indices (None = sequential). With
        ``drop_last=False``, ``round_up_to=k`` pads the final partial batch
        by wrapping to a multiple of k."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        self.round_up_to = round_up_to
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

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

    def _assemble(self, batch_idx: np.ndarray):
        labels = np.empty((len(batch_idx),), dtype=np.int64)
        first, labels[0] = self.dataset[int(batch_idx[0])]
        images = np.empty((len(batch_idx),) + np.shape(first), np.float32)
        images[0] = first
        cursor = iter(range(1, len(batch_idx)))
        lock = threading.Lock()
        errors: list[BaseException] = []

        def worker():
            while True:
                with lock:
                    pos = next(cursor, None)
                if pos is None or errors:
                    return
                try:
                    images[pos], labels[pos] = self.dataset[
                        int(batch_idx[pos])]
                except BaseException as e:   # noqa: BLE001 — re-raised below
                    errors.append(e)
                    return

        threads = [threading.Thread(target=worker)
                   for _ in range(min(self.num_workers, len(batch_idx) - 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return images, labels

    def __iter__(self) -> Iterator:
        batches = self._index_batches()
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
