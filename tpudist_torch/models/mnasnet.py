"""MnasNet 0.5 / 0.75 / 1.0 / 1.3 (torchvision ``mnasnet.py``).

Counterpart of ``tpudist/models/mnasnet.py``. Module names are the flax
tree's: the stem ``stem``/``stem_bn``, the separable stem ``sep_dw``/
``sep_pw`` (each with its ``_bn``), the blocks ``stack{s}_{j}`` with
``expand``, ``dw`` and ``project`` convs and their ``_bn``s, the head
``head``/``head_bn`` and ``classifier_1``.

- Every BatchNorm has torchvision's momentum ``1 − 0.9997`` and is
  followed by a ReLU applied outside it (or by nothing), as tpudist's:
  no BatchNorm asks for the fused epilogue, so the model reaches no
  kernel of the port.
- Widths round to multiples of 8 (``_round8``, torchvision's
  ``_round_to_multiple_of``); the classifier's weights are
  U(±sqrt(3 / out)) (kaiming-uniform over fan_out, sigmoid gain) with a
  zero bias, behind a dropout of 0.2.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from tpudist_torch.models.layers import (DenseTorch, Dropout, add_conv_bn,
                                         conv_bn, global_avg_pool,
                                         reset_parameters)

_BN_MOMENTUM = 1 - 0.9997
# (kernel, stride, expand ratio, repeats) of the six stacks (mnasnet.py
# ``_stack``); their widths are depths[2:].
_STACKS = ((3, 2, 3, 3), (5, 2, 3, 3), (5, 2, 6, 3), (3, 1, 6, 2),
           (5, 2, 6, 4), (3, 1, 6, 1))


def _round8(val: float, round_up_bias: float = 0.9) -> int:
    new_val = max(8, int(val + 4) // 8 * 8)
    return new_val if new_val >= round_up_bias * val else new_val + 8


class _InvRes(nn.Module):
    """1x1 expand → k×k depthwise → 1x1 linear projection, each a conv
    and its BatchNorm, ReLUs after the first two; the skip when the
    stride is 1 and the widths match."""

    def __init__(self, inp: int, out: int, kernel: int, strides: int,
                 expand: int, *, bn: dict, dtype=None, device=None):
        super().__init__()
        mid = inp * expand
        kw = dict(bn=bn, dtype=dtype, device=device)
        self.skip = strides == 1 and inp == out
        add_conv_bn(self, "expand", inp, mid, 1, 1, **kw)
        add_conv_bn(self, "dw", mid, mid, kernel, strides, groups=mid, **kw)
        add_conv_bn(self, "project", mid, out, 1, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_bn(self, "expand", x, True)
        y = conv_bn(self, "dw", y, True)
        y = conv_bn(self, "project", y, False)
        return x + y if self.skip else y


class MnasNet(nn.Module):
    """torchvision-architecture MnasNet over NHWC images."""

    def __init__(self, alpha: float = 1.0, num_classes: int = 1000, *,
                 dtype=None, dropout: float = 0.2,
                 sync_batchnorm: bool = False, device=None):
        super().__init__()
        self.dtype = dtype
        bn = dict(momentum=_BN_MOMENTUM,
                  axis_name="data" if sync_batchnorm else None)
        kw = dict(bn=bn, dtype=dtype, device=device)
        depths = [_round8(d * alpha)
                  for d in (32, 16, 24, 40, 80, 96, 192, 320)]
        add_conv_bn(self, "stem", 3, depths[0], 3, 2, **kw)
        add_conv_bn(self, "sep_dw", depths[0], depths[0], 3, 1,
                    groups=depths[0], **kw)
        add_conv_bn(self, "sep_pw", depths[0], depths[1], 1, 1, **kw)
        self.blocks = []
        c = depths[1]
        for si, ((k, s, e, r), out) in enumerate(zip(_STACKS, depths[2:])):
            for j in range(r):
                name = f"stack{si}_{j}"
                self.add_module(name, _InvRes(c, out, k, s if j == 0 else 1,
                                              e, **kw))
                self.blocks.append(name)
                c = out
        add_conv_bn(self, "head", c, 1280, 1, 1, **kw)
        self.drop = Dropout(dropout)
        self.classifier_1 = DenseTorch(
            1280, num_classes, dtype=dtype, device=device,
            kernel_init=("uniform", math.sqrt(3.0 / num_classes)),
            bias_init="zeros")

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``(B, H, W, 3)`` images; returns ``(B, num_classes)``
        logits in the compute dtype."""
        x = x.to(self.dtype or x.dtype).permute(0, 3, 1, 2)
        x = conv_bn(self, "stem", x, True)
        x = conv_bn(self, "sep_dw", x, True)
        x = conv_bn(self, "sep_pw", x, False)
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = global_avg_pool(conv_bn(self, "head", x, True))
        return self.classifier_1(self.drop(x))


def _mnasnet(alpha: float):
    def ctor(num_classes: int = 1000, *, dtype=None,
             sync_batchnorm: bool = False, fused_bn: bool = True,
             dropout: float = 0.2, device=None) -> MnasNet:
        return MnasNet(alpha, num_classes, dtype=dtype, dropout=dropout,
                       sync_batchnorm=sync_batchnorm, device=device)
    return ctor


mnasnet0_5 = _mnasnet(0.5)
mnasnet0_75 = _mnasnet(0.75)
mnasnet1_0 = _mnasnet(1.0)
mnasnet1_3 = _mnasnet(1.3)
