"""Image transforms: the port's copy of ``tpudist/data/transforms.py``.

The reference's torchvision stacks, without torchvision:

- train: RandomResizedCrop(224) → RandomHorizontalFlip → ToTensor → Normalize
- val:   Resize(256) → CenterCrop(224) → ToTensor → Normalize

with the ImageNet mean/std. Output is NHWC float32, normalized, as
tpudist's loader hands it to the step (the trainer permutes it to the
model's layout on the card). Randomness is an explicit
``np.random.Generator``, so a sample's augmentation is reproducible given
(seed, epoch, index) and draws the same numbers as tpudist's in the same
order: crop box, flip, auto-augment, erase.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def _to_pil(img):
    from PIL import Image
    if isinstance(img, np.ndarray):
        return Image.fromarray(img)
    return img


def random_resized_crop(img, size: int, rng: np.random.Generator,
                        scale: Tuple[float, float] = (0.08, 1.0),
                        ratio: Tuple[float, float] = (3 / 4, 4 / 3)):
    """torchvision RandomResizedCrop: sample area/aspect 10 times, fall back to
    a center crop clamped to the valid ratio range."""
    from PIL import Image
    img = _to_pil(img)
    w, h = img.size
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            i = int(rng.integers(0, h - ch + 1))
            j = int(rng.integers(0, w - cw + 1))
            return img.resize((size, size), Image.BILINEAR,
                              box=(j, i, j + cw, i + ch))
    # Fallback: center crop at the nearest valid aspect ratio.
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    i, j = (h - ch) // 2, (w - cw) // 2
    return img.resize((size, size), Image.BILINEAR, box=(j, i, j + cw, i + ch))


def resize_shorter(img, size: int):
    """torchvision Resize(int): scale so the SHORTER edge == size."""
    from PIL import Image
    img = _to_pil(img)
    w, h = img.size
    if w <= h:
        nw, nh = size, max(1, int(round(h * size / w)))
    else:
        nh, nw = size, max(1, int(round(w * size / h)))
    return img.resize((nw, nh), Image.BILINEAR)


def center_crop(img, size: int):
    img = _to_pil(img)
    w, h = img.size
    j = (w - size) // 2
    i = (h - size) // 2
    return img.crop((j, i, j + size, i + size))


def to_normalized_array(img, mean: np.ndarray = IMAGENET_MEAN,
                        std: np.ndarray = IMAGENET_STD) -> np.ndarray:
    """ToTensor + Normalize, but NHWC instead of NCHW."""
    arr = np.asarray(img, dtype=np.float32)
    if arr.ndim == 2:                       # grayscale → 3-channel
        arr = np.stack([arr] * 3, axis=-1)
    if arr.shape[-1] == 4:                  # drop alpha
        arr = arr[..., :3]
    arr = arr / 255.0
    return (arr - mean) / std


def random_erasing(arr: np.ndarray, rng: np.random.Generator,
                   scale=(0.02, 0.33), ratio=(0.3, 3.3)) -> np.ndarray:
    """torchvision ``RandomErasing(value=0)`` body (the caller rolls the
    apply-probability): sample an erase box 10 times (area/aspect like
    RandomResizedCrop), zero it; give up silently if none fits."""
    h, w = arr.shape[:2]
    area = h * w
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        eh = int(round(math.sqrt(target * aspect)))
        ew = int(round(math.sqrt(target / aspect)))
        if eh < h and ew < w:
            i = int(rng.integers(0, h - eh + 1))
            j = int(rng.integers(0, w - ew + 1))
            arr = arr.copy()
            arr[i:i + eh, j:j + ew] = 0.0
            return arr
    return arr


def train_transform(img, size: int, rng: np.random.Generator,
                    aa=None, random_erase: float = 0.0) -> np.ndarray:
    """The reference's train stack; ``aa`` is an
    optional auto-augment policy fn applied after the flip, before
    normalization — where torchvision's recipes slot RandAugment/
    TrivialAugmentWide. ``random_erase`` is the RandomErasing probability
    (applied after normalization, on the array, like torchvision's
    tensor-stage placement)."""
    img = random_resized_crop(img, size, rng)
    if rng.random() < 0.5:                  # RandomHorizontalFlip
        img = img.transpose(0)              # PIL FLIP_LEFT_RIGHT == 0
    if aa is not None:
        img = aa(img, rng)
    arr = to_normalized_array(img)
    if random_erase > 0.0 and rng.random() < random_erase:
        arr = random_erasing(arr, rng)
    return arr


def val_transform(img, size: int, resize: int) -> np.ndarray:
    """The reference's val stack."""
    return to_normalized_array(center_crop(resize_shorter(img, resize), size))
