"""ImageFolder dataset: the port's copy of ``tpudist/data/imagefolder.py``.

torchvision's ``ImageFolder`` contract without torchvision:
``root/class_x/xxx.png`` → (image, class_index), classes sorted
alphabetically, each class's files (found through ``os.walk``) sorted.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp")


class ImageFolder:
    """``root/<class>/<image>`` dataset with torchvision's class ordering
    (sorted) and sample ordering (per-class, sorted)."""

    def __init__(self, root: str, loader: Optional[Callable] = None):
        self.root = root
        self.classes = sorted(e.name for e in os.scandir(root) if e.is_dir())
        if not self.classes:
            raise FileNotFoundError(f"no class directories under {root}")
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: list[tuple[str, int]] = []
        for c in self.classes:
            cdir = os.path.join(root, c)
            for dirpath, _, filenames in sorted(os.walk(cdir)):
                for fn in sorted(filenames):
                    if fn.lower().endswith(IMG_EXTENSIONS):
                        self.samples.append((os.path.join(dirpath, fn),
                                             self.class_to_idx[c]))
        self.loader = loader or self._pil_loader

    @staticmethod
    def _pil_loader(path: str):
        from PIL import Image
        with open(path, "rb") as f:
            img = Image.open(f)
            return img.convert("RGB")

    @staticmethod
    def raw_loader(path: str) -> bytes:
        """Raw file bytes — for transforms that decode natively (the
        ``data/native.py`` JPEG kernels); their PIL fallback decodes any
        non-JPEG bytes."""
        with open(path, "rb") as f:
            return f.read()

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int):
        path, target = self.samples[index]
        return self.loader(path), target
