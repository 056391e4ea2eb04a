"""RandAugment / TrivialAugmentWide: the port's copy of
``tpudist/data/autoaugment.py`` (torchvision ``autoaugment.py`` semantics).

Implemented over PIL, the backend torchvision's functional ops use for PIL
inputs, so the photometric ops (posterize/solarize/equalize/autocontrast/
brightness/color/contrast/sharpness) are bit-identical to torchvision's;
the geometric ops use PIL affine transforms with nearest resampling.
Magnitudes are drawn from an explicit ``np.random.Generator``, the same
draws in the same order as tpudist's.

- RandAugment: ``num_ops`` sequential ops, fixed ``magnitude`` bin (default
  2 ops @ bin 9 of 31, torchvision's defaults); signed magnitudes flip with
  p=0.5.
- TrivialAugmentWide: ONE op, uniformly random bin in [0, 30], wider ranges.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Dict, Tuple

import numpy as np

_NUM_BINS = 31


def _affine(img, coeffs):
    from PIL import Image
    return img.transform(img.size, Image.AFFINE, coeffs, Image.NEAREST)


def _apply_op(img, name: str, mag: float):
    from PIL import ImageEnhance, ImageOps
    if name == "Identity":
        return img
    if name == "ShearX":
        # Top-left-anchored coeffs (1, level, 0, 0, 1, 0): the official
        # AutoAugment PIL implementation, which torchvision reproduces by
        # passing center=[0, 0] to F.affine for the shear ops.
        return _affine(img, (1.0, mag, 0.0, 0.0, 1.0, 0.0))
    if name == "ShearY":
        return _affine(img, (1.0, 0.0, 0.0, mag, 1.0, 0.0))
    if name == "TranslateX":
        return _affine(img, (1.0, 0.0, mag, 0.0, 1.0, 0.0))
    if name == "TranslateY":
        return _affine(img, (1.0, 0.0, 0.0, 0.0, 1.0, mag))
    if name == "Rotate":
        from PIL import Image
        return img.rotate(mag, Image.NEAREST)
    if name == "Brightness":
        return ImageEnhance.Brightness(img).enhance(1.0 + mag)
    if name == "Color":
        return ImageEnhance.Color(img).enhance(1.0 + mag)
    if name == "Contrast":
        return ImageEnhance.Contrast(img).enhance(1.0 + mag)
    if name == "Sharpness":
        return ImageEnhance.Sharpness(img).enhance(1.0 + mag)
    if name == "Posterize":
        return ImageOps.posterize(img, int(mag))
    if name == "Solarize":
        # float threshold passes through (torchvision hands PIL the raw
        # linspace value; int() would shift odd magnitude bins by one level)
        return ImageOps.solarize(img, mag)
    if name == "AutoContrast":
        return ImageOps.autocontrast(img)
    if name == "Equalize":
        return ImageOps.equalize(img)
    raise ValueError(f"unknown augmentation op '{name}'")


@lru_cache(maxsize=None)
def _randaugment_space(width: int, height: int) -> Dict[str, Tuple[np.ndarray, bool]]:
    """torchvision RandAugment._augmentation_space (31 bins). Translate
    magnitudes are per-axis like torchvision's (X from width =
    its ``image_size[1]``, Y from height = ``image_size[0]`` of the
    (height, width) tuple) — identical for the trainer's square crops,
    different for non-square images via the standalone API."""
    bins = _NUM_BINS
    return {
        "Identity": (np.zeros(bins), False),
        "ShearX": (np.linspace(0.0, 0.3, bins), True),
        "ShearY": (np.linspace(0.0, 0.3, bins), True),
        "TranslateX": (np.linspace(0.0, 150.0 / 331.0 * width, bins), True),
        "TranslateY": (np.linspace(0.0, 150.0 / 331.0 * height, bins), True),
        "Rotate": (np.linspace(0.0, 30.0, bins), True),
        "Brightness": (np.linspace(0.0, 0.9, bins), True),
        "Color": (np.linspace(0.0, 0.9, bins), True),
        "Contrast": (np.linspace(0.0, 0.9, bins), True),
        "Sharpness": (np.linspace(0.0, 0.9, bins), True),
        "Posterize": (8 - np.round(np.arange(bins) / ((bins - 1) / 4)), False),
        "Solarize": (np.linspace(255.0, 0.0, bins), False),
        "AutoContrast": (np.zeros(bins), False),
        "Equalize": (np.zeros(bins), False),
    }


@lru_cache(maxsize=None)
def _trivial_wide_space(size: int) -> Dict[str, Tuple[np.ndarray, bool]]:
    """torchvision TrivialAugmentWide._augmentation_space (31 bins)."""
    bins = _NUM_BINS
    return {
        "Identity": (np.zeros(bins), False),
        "ShearX": (np.linspace(0.0, 0.99, bins), True),
        "ShearY": (np.linspace(0.0, 0.99, bins), True),
        "TranslateX": (np.linspace(0.0, 32.0, bins), True),
        "TranslateY": (np.linspace(0.0, 32.0, bins), True),
        "Rotate": (np.linspace(0.0, 135.0, bins), True),
        "Brightness": (np.linspace(0.0, 0.99, bins), True),
        "Color": (np.linspace(0.0, 0.99, bins), True),
        "Contrast": (np.linspace(0.0, 0.99, bins), True),
        "Sharpness": (np.linspace(0.0, 0.99, bins), True),
        "Posterize": (8 - np.round(np.arange(bins) / ((bins - 1) / 6)), False),
        "Solarize": (np.linspace(255.0, 0.0, bins), False),
        "AutoContrast": (np.zeros(bins), False),
        "Equalize": (np.zeros(bins), False),
    }


def _pick(space, name, bin_idx, rng):
    mags, signed = space[name]
    mag = float(mags[bin_idx])
    if signed and rng.random() < 0.5:
        mag = -mag
    return mag


def rand_augment(img, rng: np.random.Generator, num_ops: int = 2,
                 magnitude: int = 9):
    """torchvision ``RandAugment(num_ops=2, magnitude=9)``."""
    space = _randaugment_space(*img.size)
    names = list(space)
    for _ in range(num_ops):
        name = names[int(rng.integers(0, len(names)))]
        img = _apply_op(img, name, _pick(space, name, magnitude, rng))
    return img


def trivial_augment_wide(img, rng: np.random.Generator):
    """torchvision ``TrivialAugmentWide()`` — one op, random magnitude bin."""
    space = _trivial_wide_space(min(img.size))
    names = list(space)
    name = names[int(rng.integers(0, len(names)))]
    bin_idx = int(rng.integers(0, _NUM_BINS))
    return _apply_op(img, name, _pick(space, name, bin_idx, rng))


def build(policy: str) -> Callable | None:
    """'' → None; 'ra' → RandAugment; 'ta_wide' → TrivialAugmentWide."""
    if not policy:
        return None
    if policy == "ra":
        return rand_augment
    if policy == "ta_wide":
        return trivial_augment_wide
    raise ValueError(f"unknown --auto-augment policy '{policy}' "
                     f"(expected '', 'ra', or 'ta_wide')")
