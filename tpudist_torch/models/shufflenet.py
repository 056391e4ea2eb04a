"""ShuffleNetV2 x0.5 / x1.0 / x1.5 / x2.0 (torchvision
``shufflenetv2.py``).

Counterpart of ``tpudist/models/shufflenet.py``. Module names are the
flax tree's: ``conv1``/``conv1_bn``, the units ``stage{2,3,4}_{j}`` with
``b1_dw``, ``b1_conv`` (the stride-2 unit's first branch), ``b2_conv1``,
``b2_dw`` and ``b2_conv2``, each beside its ``_bn``, then ``conv5``/
``conv5_bn`` and ``fc``.

- Every BatchNorm is followed by a ReLU applied outside it (or by
  nothing, after a depthwise conv), as tpudist's: no BatchNorm asks for
  the fused epilogue, so the model reaches no kernel of the port.
- A stride-1 unit splits its channels in two halves and transforms the
  second; a stride-2 unit transforms all of them in both branches. The
  halves are joined along the channels and shuffled in two groups
  (torch's ``view(B, 2, C/2, H, W).transpose(1, 2)``), on the NHWC view.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpudist_torch.models.layers import (DenseTorch, add_conv_bn, conv_bn,
                                         global_avg_pool, reset_parameters)


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """Channel ``g·(C/groups) + i`` moves to ``i·groups + g``, on the NHWC
    view of an NCHW channels_last tensor; returns the same layout."""
    b, c, h, w = x.shape
    xh = x.permute(0, 2, 3, 1).reshape(b, h, w, groups, c // groups)
    return xh.transpose(3, 4).reshape(b, h, w, c).permute(0, 3, 1, 2)


class ShuffleUnit(nn.Module):
    def __init__(self, inp: int, out: int, strides: int = 1, *, bn: dict,
                 dtype=None, device=None):
        super().__init__()
        self.strides = strides
        branch = out // 2
        kw = dict(bn=bn, dtype=dtype, device=device)
        if strides == 1:
            cin = inp // 2
        else:
            cin = inp
            add_conv_bn(self, "b1_dw", inp, inp, 3, strides, groups=inp,
                        **kw)
            add_conv_bn(self, "b1_conv", inp, branch, 1, 1, **kw)
        add_conv_bn(self, "b2_conv1", cin, branch, 1, 1, **kw)
        add_conv_bn(self, "b2_dw", branch, branch, 3, strides,
                    groups=branch, **kw)
        add_conv_bn(self, "b2_conv2", branch, branch, 1, 1, **kw)

    def _branch2(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_bn(self, "b2_conv1", x, True)
        y = conv_bn(self, "b2_dw", y, False)
        return conv_bn(self, "b2_conv2", y, True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.strides == 1:
            half = x.shape[1] // 2
            out = torch.cat([x[:, :half], self._branch2(x[:, half:])], dim=1)
        else:
            b1 = conv_bn(self, "b1_dw", x, False)
            b1 = conv_bn(self, "b1_conv", b1, True)
            out = torch.cat([b1, self._branch2(x)], dim=1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(nn.Module):
    """torchvision-architecture ShuffleNetV2 over NHWC images.
    ``stages_out``: the widths of conv1, stages 2–4 and conv5."""

    def __init__(self, stages_repeats, stages_out, num_classes: int = 1000,
                 *, dtype=None, sync_batchnorm: bool = False, device=None):
        super().__init__()
        self.dtype = dtype
        bn = dict(axis_name="data" if sync_batchnorm else None)
        kw = dict(bn=bn, dtype=dtype, device=device)
        add_conv_bn(self, "conv1", 3, stages_out[0], 3, 2, **kw)
        self.units = []
        c = stages_out[0]
        for si, (repeats, out) in enumerate(
                zip(stages_repeats, stages_out[1:4]), start=2):
            for j in range(repeats):
                name = f"stage{si}_{j}"
                self.add_module(name, ShuffleUnit(c, out, 2 if j == 0 else 1,
                                                  **kw))
                self.units.append(name)
                c = out
        add_conv_bn(self, "conv5", c, stages_out[4], 1, 1, **kw)
        self.fc = DenseTorch(stages_out[4], num_classes, dtype=dtype,
                             device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``(B, H, W, 3)`` images; returns ``(B, num_classes)``
        logits in the compute dtype."""
        x = x.to(self.dtype or x.dtype).permute(0, 3, 1, 2)
        x = F.max_pool2d(conv_bn(self, "conv1", x, True), 3, 2, 1)
        for name in self.units:
            x = getattr(self, name)(x)
        return self.fc(global_avg_pool(conv_bn(self, "conv5", x, True)))


def _shufflenet(stages_out):
    def ctor(num_classes: int = 1000, *, dtype=None,
             sync_batchnorm: bool = False, fused_bn: bool = True,
             device=None) -> ShuffleNetV2:
        return ShuffleNetV2((4, 8, 4), stages_out, num_classes, dtype=dtype,
                            sync_batchnorm=sync_batchnorm, device=device)
    return ctor


shufflenet_v2_x0_5 = _shufflenet((24, 48, 96, 192, 1024))
shufflenet_v2_x1_0 = _shufflenet((24, 116, 232, 464, 1024))
shufflenet_v2_x1_5 = _shufflenet((24, 176, 352, 704, 1024))
shufflenet_v2_x2_0 = _shufflenet((24, 244, 488, 976, 2048))
