"""VGG 11/13/16/19 and their ``_bn`` variants (torchvision ``vgg.py``
configs A/B/D/E).

Counterpart of ``tpudist/models/vgg.py``. Module names are the flax
tree's, which are torchvision's ``features.N``/``classifier.N`` indices
with ``_`` (``features_0.weight`` is ``features_0/kernel``).

- Each conv is 3x3 with a bias (init 0) and the kaiming fan_out weights;
  in the ``_bn`` variants its BatchNorm runs with the ReLU fused
  (``act="relu"``: the fused_norm kernels in train mode), in the plain
  ones a ReLU follows the conv.
- The trunk is NCHW laid out channels_last; the 7x7 adaptive pool and
  the NCHW flatten feed the classifier: Linear N(0, 0.01) weights, zero
  biases, ReLU and dropout 0.5 between them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpudist_torch.models.layers import (BatchNorm, Conv2d, DenseTorch,
                                         Dropout, adaptive_avg_pool,
                                         reset_parameters)

CFGS: dict[str, list] = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
          "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
          512, "M", 512, 512, 512, 512, "M"],
}


class VGG(nn.Module):
    """torchvision-architecture VGG over NHWC images; ``dtype`` is the
    compute dtype, ``fused_bn`` and ``sync_batchnorm`` as in ``ResNet``."""

    def __init__(self, cfg, batch_norm: bool = False,
                 num_classes: int = 1000, *, dtype=None,
                 dropout: float = 0.5, fused_bn: bool = True,
                 sync_batchnorm: bool = False, device=None):
        super().__init__()
        self.dtype = dtype
        bn = dict(dtype=dtype, fused=fused_bn, device=device,
                  axis_name="data" if sync_batchnorm else None)
        # The forward's plan: ("conv" | "bn" | "relu" | "pool", module).
        self.plan: list[tuple[str, str | None]] = []
        idx, features = 0, 3       # torchvision's Sequential index
        for v in cfg:
            if v == "M":
                self.plan.append(("pool", None))
                idx += 1
                continue
            name = f"features_{idx}"
            self.add_module(name, Conv2d(features, int(v), 3, 1,
                                         use_bias=True, dtype=dtype,
                                         device=device))
            self.plan.append(("conv", name))
            idx += 1
            if batch_norm:
                name = f"features_{idx}"
                self.add_module(name, BatchNorm(int(v), **bn))
                self.plan.append(("bn", name))
                idx += 1
            else:
                self.plan.append(("relu", None))
            idx += 1
            features = int(v)
        fc = dict(dtype=dtype, device=device, kernel_init=("normal", 0.01),
                  bias_init="zeros")
        self.classifier_0 = DenseTorch(features * 7 * 7, 4096, **fc)
        self.classifier_3 = DenseTorch(4096, 4096, **fc)
        self.classifier_6 = DenseTorch(4096, num_classes, **fc)
        self.drop_1 = Dropout(dropout)
        self.drop_2 = Dropout(dropout)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``(B, H, W, 3)`` images; returns ``(B, num_classes)``
        logits in the compute dtype."""
        x = x.to(self.dtype or x.dtype).permute(0, 3, 1, 2)
        for kind, name in self.plan:
            if kind == "pool":
                x = F.max_pool2d(x, 2, 2)
            elif kind == "relu":
                x = F.relu(x)
            elif kind == "bn":
                x = getattr(self, name)(x, act="relu")
            else:
                x = getattr(self, name)(x)
        x = torch.flatten(adaptive_avg_pool(x, (7, 7)), 1)  # NCHW order
        x = self.drop_1(F.relu(self.classifier_0(x)))
        x = self.drop_2(F.relu(self.classifier_3(x)))
        return self.classifier_6(x)


def _vgg(cfg: str, batch_norm: bool):
    def ctor(num_classes: int = 1000, *, dtype=None,
             sync_batchnorm: bool = False, fused_bn: bool = True,
             dropout: float = 0.5, device=None) -> VGG:
        return VGG(CFGS[cfg], batch_norm, num_classes, dtype=dtype,
                   dropout=dropout, fused_bn=fused_bn,
                   sync_batchnorm=sync_batchnorm, device=device)
    return ctor


vgg11 = _vgg("A", False)
vgg13 = _vgg("B", False)
vgg16 = _vgg("D", False)
vgg19 = _vgg("E", False)
vgg11_bn = _vgg("A", True)
vgg13_bn = _vgg("B", True)
vgg16_bn = _vgg("D", True)
vgg19_bn = _vgg("E", True)
