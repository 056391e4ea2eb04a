"""Per-process data sharding: the port's copy of the ordering of
``tpudist/data/sampler.py`` (torch ``DistributedSampler`` semantics).

Pad the index list to a multiple of ``num_replicas`` by repeating from
the front, shuffle deterministically by (seed, epoch), then each replica
takes a strided slice.

``set_cursor`` is tpudist's mid-epoch continuation: the epoch's global
order (the permutation before any rank takes its slice) does not depend
on the world, and global step ``j`` consumes its positions ``[j*B,
(j+1)*B)`` (B the global batch). So an emergency checkpoint's count of
consumed positions lets a resumed run, at the same or another world,
drop them and stride the rest over its ranks: no sample replayed, none
dropped. ``set_epoch`` clears the cursor.

``set_skip_windows`` is the doctor's rollback replay: it cuts the
poisoned ``[start, end)`` windows out of the epoch's global order, each
window indexing the order its predecessors already cut, and the cursor
then counts positions of what remains. ``set_epoch`` clears them too.
"""

from __future__ import annotations

import numpy as np


class ShardedSampler:
    def __init__(self, dataset_len: int, num_replicas: int, rank: int,
                 shuffle: bool = True, seed: int = 0, pad: bool = True):
        assert 0 <= rank < num_replicas
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.pad = pad
        self.epoch = 0
        self.cursor = 0
        self.skip_windows: list[tuple[int, int]] = []
        self.num_samples = -(-dataset_len // num_replicas)   # ceil
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle for ``epoch``; clears the cursor and the skip
        windows."""
        self.epoch = epoch
        self.cursor = 0
        self.skip_windows = []

    def set_skip_windows(self, windows) -> None:
        """Cut the poisoned ``[start, end)`` positions out of this epoch's
        global order (before the padding and the stride, like the
        cursor), in order: each window indexes the order as the earlier
        ones left it. Call after ``set_epoch``."""
        self.skip_windows = [
            (max(0, int(a)), int(b)) for a, b in windows if int(b) > int(a)]

    def set_cursor(self, consumed: int) -> None:
        """Skip the first ``consumed`` positions of this epoch's global
        order and stride the rest over (rank, num_replicas), which may
        differ from the world that consumed them. Call after
        ``set_epoch``."""
        self.cursor = min(max(0, int(consumed)), self.dataset_len)

    def global_order(self) -> np.ndarray:
        """The epoch's world-size-independent global sample order."""
        idx = np.arange(self.dataset_len)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(idx)
        return idx

    def _apply_skip_windows(self, idx: np.ndarray) -> np.ndarray:
        for a, b in self.skip_windows:
            idx = np.concatenate([idx[:a], idx[b:]])
        return idx

    def indices(self) -> np.ndarray:
        # The windows are positions of the whole order; the cursor counts
        # positions of what they leave.
        idx = self._apply_skip_windows(self.global_order())[self.cursor:]
        if self.pad:
            total = -(-len(idx) // self.num_replicas) * self.num_replicas
            if total > len(idx):
                idx = np.concatenate([idx, idx[: total - len(idx)]])
            return idx[self.rank:total:self.num_replicas]
        return idx[self.rank::self.num_replicas]

    def __iter__(self):
        return iter(self.indices())

    def __len__(self) -> int:
        if self.cursor or self.skip_windows:
            remaining = len(self._apply_skip_windows(
                np.arange(self.dataset_len)))
            remaining = max(0, remaining - self.cursor)
            if self.pad:
                return -(-remaining // self.num_replicas) if remaining else 0
            return max(0, -(-(remaining - self.rank) // self.num_replicas))
        return self.num_samples if self.pad else len(self.indices())
