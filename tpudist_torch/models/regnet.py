"""RegNetX and RegNetY (torchvision ``regnet.py``).

Counterpart of ``tpudist/models/regnet.py``. Widths come from the paper's
quantized linear rule (``block_params``: the ramp ``w_0 + w_a·i``
snapped to powers of ``w_m`` times ``w_0``, quantized to multiples of 8,
grouped into stages, group widths made compatible as torchvision's
``_adjust_widths_groups_compatibilty`` does). RegNetY adds squeeze-excite
(squeeze width ``round(0.25 · block input width)``).

- The stem is a 3x3/s2 conv-BN-ReLU to 32 channels; each
  ResBottleneckBlock is 1x1 (``f_a``) → 3x3 grouped, stride on it
  (``f_b``) → [SE, ``f_se``] → 1x1 (``f_c``), with a projection
  (``proj``) on any width or stride change and a ReLU after the residual
  add. The blocks are mobilenet's ``ConvBNAct`` and ``SqueezeExcite``.
- The stem, ``f_a`` and ``f_b`` fuse their ReLU into the BatchNorm (33
  fused sites in regnet_y_400mf); ``f_c`` and ``proj`` have no
  activation, and the ``relu(x + y)`` after them stays unfused, as in
  tpudist.
- Convs kaiming fan_out, the Linear N(0, 0.01) with a zero bias.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpudist_torch.models.layers import (DenseTorch, global_avg_pool,
                                         reset_parameters)
from tpudist_torch.models.mobilenet import (ConvBNAct, SqueezeExcite,
                                            _make_divisible)


def block_params(depth: int, w_0: int, w_a: float, w_m: float,
                 group_width: int) -> tuple[list[int], list[int], list[int]]:
    """torchvision ``BlockParams.from_init_params``: per-stage (widths,
    depths, group widths)."""
    quant = 8
    widths_cont = np.arange(depth) * w_a + w_0
    block_capacity = np.round(np.log(widths_cont / w_0) / math.log(w_m))
    block_widths = (np.round(w_0 * np.power(w_m, block_capacity) / quant)
                    * quant).astype(int).tolist()
    splits = [w != wp for w, wp in zip(block_widths + [0], [0] + block_widths)]
    stage_widths = [w for w, t in zip(block_widths, splits[:-1]) if t]
    split_idx = [d for d, t in enumerate(splits) if t]
    stage_depths = np.diff(split_idx).astype(int).tolist()
    # The bottleneck multiplier is 1 in every torchvision regnet; widths
    # round up with _make_divisible, as torchvision's.
    gws = [min(group_width, w) for w in stage_widths]
    stage_widths = [_make_divisible(w, g) for w, g in zip(stage_widths, gws)]
    return stage_widths, stage_depths, gws


class ResBottleneckBlock(nn.Module):
    def __init__(self, w_in: int, w_out: int, group_width: int,
                 strides: int = 1, se_ratio: float = 0.0, *, bn: dict,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(bn=bn, dtype=dtype, device=device)
        self.f_a = ConvBNAct(w_in, w_out, 1, 1, act="relu", **kw)
        self.f_b = ConvBNAct(w_out, w_out, 3, strides,
                             groups=w_out // group_width, act="relu", **kw)
        self.f_se = (SqueezeExcite(w_out, int(round(se_ratio * w_in)),
                                   act="relu", gate="sigmoid", dtype=dtype,
                                   device=device)
                     if se_ratio > 0.0 else None)
        self.f_c = ConvBNAct(w_out, w_out, 1, 1, act=None, **kw)
        self.has_proj = w_in != w_out or strides != 1
        if self.has_proj:
            self.proj = ConvBNAct(w_in, w_out, 1, strides, act=None, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.f_b(self.f_a(x))
        if self.f_se is not None:
            y = self.f_se(y)
        y = self.f_c(y)
        if self.has_proj:
            x = self.proj(x)
        return F.relu(x + y)


class RegNet(nn.Module):
    """torchvision-architecture RegNet over NHWC images; ``dtype`` is the
    compute dtype, ``fused_bn`` and ``sync_batchnorm`` as in ``ResNet``."""

    def __init__(self, depth: int, w_0: int, w_a: float, w_m: float,
                 group_width: int, se_ratio: float = 0.0,
                 num_classes: int = 1000, *, dtype=None,
                 fused_bn: bool = True, sync_batchnorm: bool = False,
                 device=None):
        super().__init__()
        self.dtype = dtype
        bn = dict(fused=fused_bn, axis_name="data" if sync_batchnorm else None)
        kw = dict(bn=bn, dtype=dtype, device=device)
        self.stem = ConvBNAct(3, 32, 3, 2, act="relu", **kw)
        self.block_names = []
        w_in = 32
        for s, (w, d, g) in enumerate(zip(*block_params(
                depth, w_0, w_a, w_m, group_width))):
            for i in range(d):
                name = f"block{s + 1}_{i}"
                self.add_module(name, ResBottleneckBlock(
                    w_in, w, g, 2 if i == 0 else 1, se_ratio, **kw))
                self.block_names.append(name)
                w_in = w
        self.fc = DenseTorch(w_in, num_classes, dtype=dtype, device=device,
                             kernel_init=("normal", 0.01), bias_init="zeros")

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``(B, H, W, 3)`` images; returns ``(B, num_classes)``
        logits in the compute dtype."""
        x = self.stem(x.to(self.dtype or x.dtype).permute(0, 3, 1, 2))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.fc(global_avg_pool(x))


# depth, w_0, w_a, w_m, group_width, SE ratio: torchvision's
# regnet_{x,y}_* BlockParams.
_VARIANTS = {
    "regnet_y_400mf": (16, 48, 27.89, 2.09, 8, 0.25),
    "regnet_y_800mf": (14, 56, 38.84, 2.4, 16, 0.25),
    "regnet_y_1_6gf": (27, 48, 20.71, 2.65, 24, 0.25),
    "regnet_y_3_2gf": (21, 80, 42.63, 2.66, 24, 0.25),
    "regnet_y_8gf": (17, 192, 76.82, 2.19, 56, 0.25),
    "regnet_y_16gf": (18, 200, 106.23, 2.48, 112, 0.25),
    "regnet_y_32gf": (20, 232, 115.89, 2.53, 232, 0.25),
    "regnet_x_400mf": (22, 24, 24.48, 2.54, 16, 0.0),
    "regnet_x_800mf": (16, 56, 35.73, 2.28, 16, 0.0),
    "regnet_x_1_6gf": (18, 80, 34.01, 2.25, 24, 0.0),
    "regnet_x_3_2gf": (25, 88, 26.31, 2.25, 48, 0.0),
    "regnet_x_8gf": (23, 80, 49.56, 2.88, 120, 0.0),
    "regnet_x_16gf": (22, 216, 55.59, 2.1, 128, 0.0),
    "regnet_x_32gf": (23, 320, 69.86, 2.0, 168, 0.0),
}


def _ctor(name: str):
    depth, w_0, w_a, w_m, gw, se = _VARIANTS[name]

    def build(num_classes: int = 1000, *, dtype=None,
              sync_batchnorm: bool = False, fused_bn: bool = True,
              device=None) -> RegNet:
        return RegNet(depth, w_0, w_a, w_m, gw, se, num_classes, dtype=dtype,
                      fused_bn=fused_bn, sync_batchnorm=sync_batchnorm,
                      device=device)
    build.__name__ = name
    return build


for _n in _VARIANTS:
    globals()[_n] = _ctor(_n)
