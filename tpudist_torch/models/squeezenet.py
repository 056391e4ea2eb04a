"""SqueezeNet 1.0 and 1.1 (torchvision ``squeezenet.py``).

Counterpart of ``tpudist/models/squeezenet.py``. Module names are the
flax tree's: the stem conv ``features_0``, the Fire modules
``features_N`` (torchvision's indices) with ``squeeze``, ``expand1x1``
and ``expand3x3`` convs, and the classifier conv ``classifier_1``. Every
conv has a bias (init 0) and the kaiming fan_out weights, but the
classifier's N(0, 0.01). No BatchNorm: ReLUs, ``max_pool_ceil`` (3x3/s2,
ceil mode), a dropout (0.5) over the NHWC feature map as tpudist draws
it, the 1x1 classifier conv, a ReLU and the global mean.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpudist_torch.models.layers import (Conv2d, Dropout, global_avg_pool,
                                         max_pool_ceil, reset_parameters)


class Fire(nn.Module):
    """A 1x1 squeeze, then a 1x1 and a 3x3 expand side by side, each with
    its ReLU; the two expands joined along the channels."""

    def __init__(self, in_features: int, squeeze: int, expand: int, *,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(use_bias=True, dtype=dtype, device=device)
        self.squeeze = Conv2d(in_features, squeeze, 1, 1, padding=0, **kw)
        self.expand1x1 = Conv2d(squeeze, expand, 1, 1, padding=0, **kw)
        self.expand3x3 = Conv2d(squeeze, expand, 3, 1, padding=1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(x)),
                          F.relu(self.expand3x3(x))], dim=1)


# (index, squeeze, expand) of each Fire module, and where the pools sit.
_FIRES = {"1_0": ((3, 16, 64), (4, 16, 64), (5, 32, 128), "pool",
                  (7, 32, 128), (8, 48, 192), (9, 48, 192), (10, 64, 256),
                  "pool", (12, 64, 256)),
          "1_1": ((3, 16, 64), (4, 16, 64), "pool", (6, 32, 128),
                  (7, 32, 128), "pool", (9, 48, 192), (10, 48, 192),
                  (11, 64, 256), (12, 64, 256))}


class SqueezeNet(nn.Module):
    """torchvision-architecture SqueezeNet over NHWC images."""

    def __init__(self, version: str = "1_0", num_classes: int = 1000, *,
                 dtype=None, dropout: float = 0.5, device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        # 1.0: a 7x7/s2 stem of 96; 1.1: a 3x3/s2 stem of 64.
        stem = (96, 7) if version == "1_0" else (64, 3)
        self.features_0 = Conv2d(3, stem[0], stem[1], 2, padding=0,
                                 use_bias=True, **kw)
        self.layout = []
        c = stem[0]
        for item in _FIRES[version]:
            if item == "pool":
                self.layout.append(None)
                continue
            i, squeeze, expand = item
            self.add_module(f"features_{i}", Fire(c, squeeze, expand, **kw))
            self.layout.append(f"features_{i}")
            c = 2 * expand
        self.drop = Dropout(dropout)
        self.classifier_1 = Conv2d(c, num_classes, 1, 1, padding=0,
                                   use_bias=True, init=("normal", 0.01),
                                   **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``(B, H, W, 3)`` images; returns ``(B, num_classes)``
        logits in the compute dtype."""
        x = x.to(self.dtype or x.dtype).permute(0, 3, 1, 2)
        x = max_pool_ceil(F.relu(self.features_0(x)), 3, 2)
        for name in self.layout:
            x = (max_pool_ceil(x, 3, 2) if name is None
                 else getattr(self, name)(x))
        # The mask over the NHWC view, as tpudist draws it.
        x = self.drop(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return global_avg_pool(F.relu(self.classifier_1(x)))


def _ctor(version: str):
    def ctor(num_classes: int = 1000, *, dtype=None,
             sync_batchnorm: bool = False, fused_bn: bool = True,
             dropout: float = 0.5, device=None) -> SqueezeNet:
        return SqueezeNet(version, num_classes, dtype=dtype,
                          dropout=dropout, device=device)
    return ctor


squeezenet1_0 = _ctor("1_0")
squeezenet1_1 = _ctor("1_1")
