"""Inception v3 (torchvision ``inception.py``; 299 px input).

Counterpart of ``tpudist/models/inception.py``. Module names are the flax
tree's (``Mixed_5b.branch5x5_1.conv.weight`` as torchvision's).

- Every conv is a ``BasicConv2d`` (conv → BN eps 1e-3 → ReLU fused, the
  truncated-normal init of std 0.1): 94 fused sites, 96 with the aux
  head. The C blocks factorise 7x7 into 1x7 and 7x1, the E blocks split
  into 1x3 and 3x1 branches and concatenate them.
- The branch concatenations are channels_last; the stride-1 average
  pools count the padding, as torch's and flax's do.
- ``aux_logits`` defaults to True, as in tpudist (whose trainer never sets
  it): a train-mode forward returns ``AuxOutputs`` (the logits, then the
  aux head's), and the loss adds 0.4 × the aux head's
  (``aux_loss_weight``). The aux head needs the 17x17 grid of a 299 px
  input. Eval mode returns the logits alone; without the aux head the
  model runs from 75 px.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from tpudist_torch.models.layers import (AuxOutputs, BasicConv2d,
                                         DenseTorch, Dropout, avg_pool_padded,
                                         global_avg_pool, reset_parameters)


def _avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    # avg_pool2d(3, stride=1, padding=1) counts the padding in the mean
    # (layers.avg_pool_padded: torch's CUDA backward of it over a
    # channels_last input is wrong)
    return avg_pool_padded(x, 3, 1, 1)


class InceptionA(nn.Module):
    def __init__(self, in_features: int, pool_features: int, *, conv):
        super().__init__()
        self.branch1x1 = conv(in_features, 64)
        self.branch5x5_1 = conv(in_features, 48)
        self.branch5x5_2 = conv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = conv(in_features, 64)
        self.branch3x3dbl_2 = conv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = conv(96, 96, 3, padding=1)
        self.branch_pool = conv(in_features, pool_features)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_same(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_features: int, *, conv):
        super().__init__()
        self.branch3x3 = conv(in_features, 384, 3, 2)
        self.branch3x3dbl_1 = conv(in_features, 64)
        self.branch3x3dbl_2 = conv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = conv(96, 96, 3, 2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_features: int, c7: int, *, conv):
        super().__init__()
        self.branch1x1 = conv(in_features, 192)
        self.branch7x7_1 = conv(in_features, c7)
        self.branch7x7_2 = conv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = conv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = conv(in_features, c7)
        self.branch7x7dbl_2 = conv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = conv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = conv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = conv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = conv(in_features, 192)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_same(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_features: int, *, conv):
        super().__init__()
        self.branch3x3_1 = conv(in_features, 192)
        self.branch3x3_2 = conv(192, 320, 3, 2)
        self.branch7x7x3_1 = conv(in_features, 192)
        self.branch7x7x3_2 = conv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = conv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = conv(192, 192, 3, 2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, in_features: int, *, conv):
        super().__init__()
        self.branch1x1 = conv(in_features, 320)
        self.branch3x3_1 = conv(in_features, 384)
        self.branch3x3_2a = conv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = conv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = conv(in_features, 448)
        self.branch3x3dbl_2 = conv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = conv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = conv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = conv(in_features, 192)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        bp = self.branch_pool(_avg_pool_same(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionAux(nn.Module):
    def __init__(self, in_features: int, num_classes: int, *, conv,
                 dtype=None, device=None):
        super().__init__()
        self.conv0 = conv(in_features, 128)
        self.conv1 = conv(128, 768, 5)
        # torchvision: self.fc.stddev = 0.001 → truncated-normal init
        self.fc = DenseTorch(768, num_classes, dtype=dtype, device=device,
                             kernel_init=("trunc_normal", 0.001))

    def forward(self, x):
        x = self.conv1(self.conv0(F.avg_pool2d(x, 5, 3)))
        return self.fc(global_avg_pool(x))


class Inception3(nn.Module):
    """torchvision-architecture Inception v3 over NHWC images; ``dtype``
    is the compute dtype, ``fused_bn`` and ``sync_batchnorm`` as in
    ``ResNet``."""

    aux_loss_weight = 0.4

    def __init__(self, num_classes: int = 1000, *, aux_logits: bool = True,
                 dtype=None, dropout: float = 0.5, fused_bn: bool = True,
                 sync_batchnorm: bool = False, device=None):
        super().__init__()
        self.dtype = dtype
        self.aux_logits = bool(aux_logits)
        bn = dict(fused=fused_bn, axis_name="data" if sync_batchnorm else None)
        conv = partial(BasicConv2d, stddev=0.1, bn=bn, dtype=dtype,
                       device=device)
        self.Conv2d_1a_3x3 = conv(3, 32, 3, 2)
        self.Conv2d_2a_3x3 = conv(32, 32, 3)
        self.Conv2d_2b_3x3 = conv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = conv(64, 80)
        self.Conv2d_4a_3x3 = conv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, conv=conv)
        self.Mixed_5c = InceptionA(256, 64, conv=conv)
        self.Mixed_5d = InceptionA(288, 64, conv=conv)
        self.Mixed_6a = InceptionB(288, conv=conv)
        self.Mixed_6b = InceptionC(768, 128, conv=conv)
        self.Mixed_6c = InceptionC(768, 160, conv=conv)
        self.Mixed_6d = InceptionC(768, 160, conv=conv)
        self.Mixed_6e = InceptionC(768, 192, conv=conv)
        if self.aux_logits:
            self.AuxLogits = InceptionAux(768, num_classes, conv=conv,
                                          dtype=dtype, device=device)
        self.Mixed_7a = InceptionD(768, conv=conv)
        self.Mixed_7b = InceptionE(1280, conv=conv)
        self.Mixed_7c = InceptionE(2048, conv=conv)
        self.drop = Dropout(dropout)
        # torchvision's init loop gives a Linear without a stddev 0.1
        self.fc = DenseTorch(2048, num_classes, dtype=dtype, device=device,
                             kernel_init=("trunc_normal", 0.1))

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor):
        """``x``: ``(B, H, W, 3)`` images; returns ``(B, num_classes)``
        logits in the compute dtype, or ``AuxOutputs`` in train mode with
        the aux head."""
        x = x.to(self.dtype or x.dtype).permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = getattr(self, name)(x)
        heads = self.aux_logits and self.training
        aux = (self.AuxLogits(x),) if heads else ()
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        logits = self.fc(self.drop(global_avg_pool(x)))
        return AuxOutputs(logits, aux) if heads else logits


def inception_v3(num_classes: int = 1000, *, dtype=None,
                 sync_batchnorm: bool = False, fused_bn: bool = True,
                 aux_logits: bool = True, dropout: float = 0.5,
                 device=None) -> Inception3:
    return Inception3(num_classes, aux_logits=aux_logits, dtype=dtype,
                      dropout=dropout, fused_bn=fused_bn,
                      sync_batchnorm=sync_batchnorm, device=device)
