"""AlexNet (torchvision ``alexnet.py``).

Counterpart of ``tpudist/models/alexnet.py``. Module names are the flax
tree's, torchvision's ``nn.Sequential`` indices with ``_``: the convs
``features_0/3/6/8/10`` (flax ``nn.Conv``'s init: lecun-normal kernels,
zero biases) and the Linears ``classifier_1/4/6`` (torch's default
init). No BatchNorm, so no kernel of the port: ReLUs, 3x3/s2 max pools
(no padding, floor), the adaptive average pool to 6x6, the flatten in
NCHW order (so the Linear weights are torchvision's) and two dropouts
(0.5) ahead of the first two Linears.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpudist_torch.models.layers import (Conv2d, DenseTorch, Dropout,
                                         adaptive_avg_pool, reset_parameters)


class AlexNet(nn.Module):
    """torchvision-architecture AlexNet over NHWC images."""

    def __init__(self, num_classes: int = 1000, *, dtype=None,
                 dropout: float = 0.5, device=None):
        super().__init__()
        self.dtype = dtype
        conv = dict(use_bias=True, init="lecun", dtype=dtype, device=device)
        self.features_0 = Conv2d(3, 64, 11, 4, padding=2, **conv)
        self.features_3 = Conv2d(64, 192, 5, 1, padding=2, **conv)
        self.features_6 = Conv2d(192, 384, 3, 1, padding=1, **conv)
        self.features_8 = Conv2d(384, 256, 3, 1, padding=1, **conv)
        self.features_10 = Conv2d(256, 256, 3, 1, padding=1, **conv)
        fc = dict(dtype=dtype, device=device)
        self.drop_0 = Dropout(dropout)
        self.classifier_1 = DenseTorch(256 * 6 * 6, 4096, **fc)
        self.drop_3 = Dropout(dropout)
        self.classifier_4 = DenseTorch(4096, 4096, **fc)
        self.classifier_6 = DenseTorch(4096, num_classes, **fc)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``(B, H, W, 3)`` images; returns ``(B, num_classes)``
        logits in the compute dtype."""
        x = x.to(self.dtype or x.dtype).permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.features_0(x)), 3, 2)
        x = F.max_pool2d(F.relu(self.features_3(x)), 3, 2)
        x = F.relu(self.features_6(x))
        x = F.relu(self.features_8(x))
        x = F.max_pool2d(F.relu(self.features_10(x)), 3, 2)
        x = adaptive_avg_pool(x, (6, 6)).reshape(x.shape[0], -1)
        x = F.relu(self.classifier_1(self.drop_0(x)))
        x = F.relu(self.classifier_4(self.drop_3(x)))
        return self.classifier_6(x)


def alexnet(num_classes: int = 1000, *, dtype=None,
            sync_batchnorm: bool = False, fused_bn: bool = True,
            dropout: float = 0.5, device=None) -> AlexNet:
    """tpudist's ``alexnet``: ``sync_batchnorm`` and ``fused_bn`` are
    accepted and ignored (it has no BatchNorm)."""
    return AlexNet(num_classes, dtype=dtype, dropout=dropout, device=device)
