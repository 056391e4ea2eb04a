"""Per-process data sharding: the port's copy of the ordering of
``tpudist/data/sampler.py`` (torch ``DistributedSampler`` semantics).

Pad the index list to a multiple of ``num_replicas`` by repeating from
the front, shuffle deterministically by (seed, epoch), then each replica
takes a strided slice. The elastic cursor and the doctor's skip windows
come with those planes.
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
        self.num_samples = -(-dataset_len // num_replicas)   # ceil
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def global_order(self) -> np.ndarray:
        """The epoch's world-size-independent global sample order."""
        idx = np.arange(self.dataset_len)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(idx)
        return idx

    def indices(self) -> np.ndarray:
        idx = self.global_order()
        if self.pad:
            if self.total_size > len(idx):
                idx = np.concatenate([idx, idx[: self.total_size - len(idx)]])
            return idx[self.rank:self.total_size:self.num_replicas]
        return idx[self.rank::self.num_replicas]

    def __iter__(self):
        return iter(self.indices())

    def __len__(self) -> int:
        return self.num_samples if self.pad else len(self.indices())
