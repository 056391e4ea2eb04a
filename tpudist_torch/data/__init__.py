"""Input pipeline: counterpart of ``tpudist/data`` (synthetic data so far).

``build_train_val_loaders`` is the synthetic branch of
``tpudist/data/pipeline.py::build_train_val_loaders`` on one process: the
same dataset sizes, seeds, samplers and batch boundaries. ImageFolder
data and the ``native/`` decode path come later.
"""

from __future__ import annotations

from tpudist_torch.data.loader import DataLoader, DevicePrefetcher  # noqa: F401
from tpudist_torch.data.sampler import ShardedSampler
from tpudist_torch.data.synthetic import SyntheticDataset


def build_train_val_loaders(cfg, rank: int = 0, world: int = 1):
    if cfg.data and not cfg.synthetic:
        raise NotImplementedError("--data: ImageFolder data is not in the "
                                  "port yet; pass --synthetic")
    host_batch = cfg.batch_size // world
    seed = cfg.seed if cfg.seed is not None else 0
    n_train = cfg.synthetic_size or max(host_batch * world * 4, 256)
    train_ds = SyntheticDataset(n_train, cfg.image_size, cfg.num_classes,
                                seed)
    val_ds = SyntheticDataset(max(n_train // 2, host_batch), cfg.image_size,
                              cfg.num_classes, seed + 1)
    train_sampler = ShardedSampler(len(train_ds), world, rank, shuffle=True,
                                   seed=seed)
    val_sampler = ShardedSampler(len(val_ds), world, rank, shuffle=False,
                                 seed=seed)
    train_loader = DataLoader(train_ds, host_batch, sampler=train_sampler,
                              num_workers=cfg.workers, drop_last=True)
    # Val sees every sample: the last partial batch is kept (one device,
    # so no rounding up).
    val_loader = DataLoader(val_ds, host_batch, sampler=val_sampler,
                            num_workers=cfg.workers, drop_last=False,
                            round_up_to=1)
    return train_loader, val_loader
