"""Synthetic dataset: the port's copy of ``tpudist/data/synthetic.py``."""

from __future__ import annotations

import numpy as np


class SyntheticDataset:
    """Index-addressable fake ImageFolder: image i is deterministic in
    (seed, i), so runs are reproducible and loss decrease is testable."""

    def __init__(self, num_samples: int = 1024, image_size: int = 224,
                 num_classes: int = 1000, seed: int = 0):
        self.num_samples = num_samples
        self.image_size = image_size
        self.num_classes = num_classes
        self.seed = seed

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, index: int):
        rng = np.random.default_rng((self.seed, index))
        img = rng.standard_normal(
            (self.image_size, self.image_size, 3)).astype(np.float32)
        label = int(rng.integers(0, self.num_classes))
        # Plant a weak class-dependent signal so training can learn it.
        img[:4, :4, :] += label % 7
        return img, label
