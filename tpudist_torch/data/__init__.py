"""Input pipeline: counterpart of ``tpudist/data``.

``build_train_val_loaders`` is ``tpudist/data/pipeline.py::
build_train_val_loaders`` for one card a rank: synthetic data, or an
ImageFolder root (``--data DIR`` with ``DIR/train`` and ``DIR/val``)
through tpudist's transforms, with the same samplers, per-sample
generators, batch boundaries and retry/skip loader. Each split takes the
fastest path this host has, as tpudist's does:

- native JPEG: the dataset yields raw bytes, decoded and cropped by
  ``csrc/jpeg.cc`` (built only where ``jpeglib.h`` is found; bytes that
  are not a JPEG it decodes go through PIL);
- native crop over PIL decode: PIL decodes, ``csrc/transforms.cc`` crops,
  resizes, flips and normalizes;
- the PIL stack (``transforms.py``): where the host has no ``g++``, and
  for the train split under ``--auto-augment`` or ``--random-erase``,
  which the native kernels do not do.

Each loader carries the path it took and why (``data_path``), which the
trainer logs.
"""

from __future__ import annotations

import io
import os
from functools import partial

from tpudist_torch.data import autoaugment, native, transforms
from tpudist_torch.data.imagefolder import ImageFolder
from tpudist_torch.data.loader import DataLoader, DevicePrefetcher  # noqa: F401
from tpudist_torch.data.sampler import ShardedSampler
from tpudist_torch.data.synthetic import SyntheticDataset

# The ways a split can read its images, fastest first.
JPEG = "native JPEG"
CROP = "native crop over PIL decode"
PIL_STACK = "PIL stack"


def choose_paths(cfg, use_native: bool = True) -> dict[str, tuple[str, str]]:
    """``{"train": (path, why), "val": (path, why)}`` for ImageFolder data
    on this host. ``use_native=False`` takes the PIL stack for both splits
    (the tests and the loader benchmark use it; the CLI does not)."""
    if not use_native:
        why = "the native kernels were turned off by the caller"
        return {"train": (PIL_STACK, why), "val": (PIL_STACK, why)}
    if not native.available():
        why = "no g++ on this host to build csrc/transforms.cc"
        return {"train": (PIL_STACK, why), "val": (PIL_STACK, why)}
    if native.jpeg_available():
        best = (JPEG, f"jpeglib.h at {native.jpeg_header()}")
    else:
        best = (CROP, "no jpeglib.h on this host")
    augments = [flag for flag, on in (
        ("--auto-augment", bool(cfg.auto_augment)),
        ("--random-erase", cfg.random_erase > 0.0)) if on]
    train = best if not augments else (
        PIL_STACK, f"{' and '.join(augments)} run on PIL only")
    return {"train": train, "val": best}


def build_train_val_loaders(cfg, rank: int = 0, world: int = 1,
                            use_native: bool = True):
    """The train and val loaders of rank ``rank`` of ``world``."""
    host_batch = cfg.batch_size // world
    seed = cfg.seed if cfg.seed is not None else 0
    if cfg.synthetic or not cfg.data:
        n_train = cfg.synthetic_size or max(host_batch * world * 4, 256)
        train_ds = SyntheticDataset(n_train, cfg.image_size,
                                    cfg.num_classes, seed)
        val_ds = SyntheticDataset(max(n_train // 2, host_batch),
                                  cfg.image_size, cfg.num_classes, seed + 1)
        train_tf = val_tf = None
        paths = {"train": ("synthetic", "--synthetic"),
                 "val": ("synthetic", "--synthetic")}
    else:
        paths = choose_paths(cfg, use_native)
        aa = autoaugment.build(cfg.auto_augment)
        size, resize = cfg.image_size, cfg.val_resize
        train_tf = {
            JPEG: partial(_native_jpeg_train_tf, size=size),
            CROP: partial(_native_train_tf, size=size),
            PIL_STACK: partial(_train_tf, size=size, aa=aa,
                               random_erase=cfg.random_erase),
        }[paths["train"][0]]
        val_tf = {
            JPEG: partial(_native_jpeg_val_tf, size=size, resize=resize),
            CROP: partial(_native_val_tf, size=size, resize=resize),
            PIL_STACK: partial(_val_tf, size=size, resize=resize),
        }[paths["val"][0]]
        raw = {split: ImageFolder.raw_loader if p == JPEG else None
               for split, (p, _) in paths.items()}
        train_ds = ImageFolder(os.path.join(cfg.data, "train"),
                               loader=raw["train"])
        val_ds = ImageFolder(os.path.join(cfg.data, "val"),
                             loader=raw["val"])
    train_sampler = ShardedSampler(len(train_ds), world, rank, shuffle=True,
                                   seed=seed)
    val_sampler = ShardedSampler(len(val_ds), world, rank, shuffle=False,
                                 seed=seed)
    degrade = dict(retries=cfg.data_retries,
                   retry_backoff=cfg.data_retry_backoff,
                   skip_budget=cfg.data_skip_budget, seed=seed)
    train_loader = DataLoader(train_ds, host_batch, sampler=train_sampler,
                              transform=train_tf, num_workers=cfg.workers,
                              drop_last=True, **degrade)
    # Val sees every sample: the last partial batch is kept (one card a
    # rank, so no rounding up).
    val_loader = DataLoader(val_ds, host_batch, sampler=val_sampler,
                            transform=val_tf, num_workers=cfg.workers,
                            drop_last=False, round_up_to=1, **degrade)
    train_loader.data_path = paths["train"]
    val_loader.data_path = paths["val"]
    return train_loader, val_loader


def _train_tf(img, rng, size, aa=None, random_erase=0.0):
    return transforms.train_transform(img, size, rng, aa=aa,
                                      random_erase=random_erase)


def _val_tf(img, rng, size, resize):
    return transforms.val_transform(img, size, resize)


def _native_train_tf(img, rng, size):
    return native.train_transform(img, size, rng)


def _native_val_tf(img, rng, size, resize):
    return native.val_transform(img, size, resize)


def _pil_decode(data):
    from PIL import Image
    return Image.open(io.BytesIO(data)).convert("RGB")


def _native_jpeg_train_tf(data, rng, size):
    out = native.decode_train_transform(data, size, rng)
    if out is not None:
        return out
    return native.train_transform(_pil_decode(data), size, rng)


def _native_jpeg_val_tf(data, rng, size, resize):
    out = native.decode_val_transform(data, size, resize)
    if out is not None:
        return out
    return native.val_transform(_pil_decode(data), size, resize)
