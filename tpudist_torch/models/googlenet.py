"""GoogLeNet, Inception v1 (torchvision ``googlenet.py``).

Counterpart of ``tpudist/models/googlenet.py``. Module names are the flax
tree's (``inception3a.branch2_0.conv.weight`` is torchvision's
``inception3a.branch2.0.conv.weight``).

- Every conv is a ``BasicConv2d`` (conv → BN eps 1e-3 → ReLU fused, the
  truncated-normal init of std 0.01): 57 fused sites, and 2 more in each
  aux head. As torchvision's, the "5x5" branch runs a 3x3 conv.
- The branches concatenate along the channels (channels_last in,
  channels_last out); the pools are torch's ``ceil_mode`` max pools
  (``layers.max_pool_ceil``).
- ``aux_logits`` defaults to False, as tpudist's and torchvision's
  released model (its parameter count 6,624,904 leaves the heads out);
  tpudist's trainer never sets it. With it set, a train-mode forward
  returns ``AuxOutputs`` (the logits, then aux1's and aux2's), and the
  loss adds 0.3 × each head's (``aux_loss_weight``); eval mode returns
  the logits alone.
"""

from __future__ import annotations

from functools import partial

import torch
from torch import nn

from tpudist_torch.models.layers import (AuxOutputs, BasicConv2d,
                                         DenseTorch, Dropout,
                                         adaptive_avg_pool, global_avg_pool,
                                         max_pool_ceil, reset_parameters)


class Inception(nn.Module):
    def __init__(self, in_features: int, ch1x1: int, ch3x3red: int,
                 ch3x3: int, ch5x5red: int, ch5x5: int, pool_proj: int, *,
                 conv):
        super().__init__()
        self.branch1 = conv(in_features, ch1x1, 1)
        self.branch2_0 = conv(in_features, ch3x3red, 1)
        self.branch2_1 = conv(ch3x3red, ch3x3, 3, padding=1)
        self.branch3_0 = conv(in_features, ch5x5red, 1)
        # torchvision's quirk: kernel 3 in the "5x5" branch
        self.branch3_1 = conv(ch5x5red, ch5x5, 3, padding=1)
        self.branch4_1 = conv(in_features, pool_proj, 1)
        self.features = ch1x1 + ch3x3 + ch5x5 + pool_proj

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1(x)
        b2 = self.branch2_1(self.branch2_0(x))
        b3 = self.branch3_1(self.branch3_0(x))
        b4 = self.branch4_1(max_pool_ceil(x, 3, 1, padding=1))
        return torch.cat([b1, b2, b3, b4], dim=1)


class InceptionAux(nn.Module):
    def __init__(self, in_features: int, num_classes: int, *, conv,
                 dtype=None, device=None):
        super().__init__()
        self.conv = conv(in_features, 128, 1)
        fc = dict(dtype=dtype, device=device,
                  kernel_init=("trunc_normal", 0.01))
        self.fc1 = DenseTorch(128 * 4 * 4, 1024, **fc)
        self.fc2 = DenseTorch(1024, num_classes, **fc)
        self.drop = Dropout(0.7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(adaptive_avg_pool(x, (4, 4)))
        x = torch.relu(self.fc1(torch.flatten(x, 1)))      # NCHW order
        return self.fc2(self.drop(x))


class GoogLeNet(nn.Module):
    """torchvision-architecture GoogLeNet over NHWC images; ``dtype`` is
    the compute dtype, ``fused_bn`` and ``sync_batchnorm`` as in
    ``ResNet``."""

    aux_loss_weight = 0.3

    def __init__(self, num_classes: int = 1000, *, aux_logits: bool = False,
                 dtype=None, dropout: float = 0.2, fused_bn: bool = True,
                 sync_batchnorm: bool = False, device=None):
        super().__init__()
        self.dtype = dtype
        self.aux_logits = bool(aux_logits)
        bn = dict(fused=fused_bn, axis_name="data" if sync_batchnorm else None)
        conv = partial(BasicConv2d, stddev=0.01, bn=bn, dtype=dtype,
                       device=device)
        inc = partial(Inception, conv=conv)
        self.conv1 = conv(3, 64, 7, 2, padding=3)
        self.conv2 = conv(64, 64, 1)
        self.conv3 = conv(64, 192, 3, padding=1)
        self.inception3a = inc(192, 64, 96, 128, 16, 32, 32)
        self.inception3b = inc(256, 128, 128, 192, 32, 96, 64)
        self.inception4a = inc(480, 192, 96, 208, 16, 48, 64)
        self.inception4b = inc(512, 160, 112, 224, 24, 64, 64)
        self.inception4c = inc(512, 128, 128, 256, 24, 64, 64)
        self.inception4d = inc(512, 112, 144, 288, 32, 64, 64)
        self.inception4e = inc(528, 256, 160, 320, 32, 128, 128)
        self.inception5a = inc(832, 256, 160, 320, 32, 128, 128)
        self.inception5b = inc(832, 384, 192, 384, 48, 128, 128)
        if self.aux_logits:
            aux = partial(InceptionAux, num_classes=num_classes, conv=conv,
                          dtype=dtype, device=device)
            self.aux1 = aux(512)
            self.aux2 = aux(528)
        self.drop = Dropout(dropout)
        self.fc = DenseTorch(1024, num_classes, dtype=dtype, device=device,
                             kernel_init=("trunc_normal", 0.01))

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor):
        """``x``: ``(B, H, W, 3)`` images; returns ``(B, num_classes)``
        logits in the compute dtype, or ``AuxOutputs`` in train mode with
        the aux heads."""
        x = x.to(self.dtype or x.dtype).permute(0, 3, 1, 2)
        x = max_pool_ceil(self.conv1(x), 3, 2)
        x = max_pool_ceil(self.conv3(self.conv2(x)), 3, 2)
        x = self.inception3b(self.inception3a(x))
        x = self.inception4a(max_pool_ceil(x, 3, 2))
        aux = []
        heads = self.aux_logits and self.training
        if heads:
            aux.append(self.aux1(x))
        x = self.inception4d(self.inception4c(self.inception4b(x)))
        if heads:
            aux.append(self.aux2(x))
        x = max_pool_ceil(self.inception4e(x), 2, 2)
        x = self.inception5b(self.inception5a(x))
        logits = self.fc(self.drop(global_avg_pool(x)))
        return AuxOutputs(logits, tuple(aux)) if heads else logits


def googlenet(num_classes: int = 1000, *, dtype=None,
              sync_batchnorm: bool = False, fused_bn: bool = True,
              aux_logits: bool = False, dropout: float = 0.2,
              device=None) -> GoogLeNet:
    return GoogLeNet(num_classes, aux_logits=aux_logits, dtype=dtype,
                     dropout=dropout, fused_bn=fused_bn,
                     sync_batchnorm=sync_batchnorm, device=device)
