"""EfficientNet B0–B7 and EfficientNetV2 S/M/L (torchvision
``efficientnet.py``).

Counterpart of ``tpudist/models/efficientnet.py``. Module names are the
flax tree's: the stem ``features_0``, the blocks ``features_{s}_{i}``
(MBConv: ``expand``, ``dw``, ``se``, ``project``; FusedMBConv: ``fused``,
``project``), the head conv ``features_{n}`` and ``classifier_1``, each
conv block a ``conv`` and a ``bn`` (``mobilenet.ConvBNAct``).

- Every activation is SiLU (the squeeze-excite gate a sigmoid), applied
  after a plain BatchNorm: the fused epilogue implements a ReLU only, so
  as in tpudist no BatchNorm asks for it and the model reaches no kernel
  of the port.
- B0–B7 scale the B0 table's widths (``_make_divisible``) and depths
  (``ceil``); the squeeze width comes from a block's unexpanded input
  (``max(1, c_in // 4)``). b5–b7's BatchNorms have eps 1e-3 and momentum
  0.01, the others torch's defaults; V2's eps 1e-3 and momentum 0.1.
- Stochastic depth (row mode) on each residual block, its rate ramping
  with the block's index: ``0.2 · block / blocks``; the first block
  draws nothing. Then the classifier's dropout (0.2–0.5 by variant) and
  a Linear with U(±1/sqrt(classes)) weights and a zero bias.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from tpudist_torch.models.layers import (DenseTorch, Dropout,
                                         global_avg_pool, reset_parameters,
                                         stochastic_depth)
from tpudist_torch.models.mobilenet import (ConvBNAct, SqueezeExcite,
                                            _make_divisible)

# B0 base table: expand ratio, kernel, stride, c_in, c_out, repeats
# (torchvision ``_efficientnet_conf``). Variants scale widths/depths.
_BASE = (
    (1, 3, 1, 32, 16, 1),
    (6, 3, 2, 16, 24, 2),
    (6, 5, 2, 24, 40, 2),
    (6, 3, 2, 40, 80, 3),
    (6, 5, 1, 80, 112, 3),
    (6, 5, 2, 112, 192, 4),
    (6, 3, 1, 192, 320, 1),
)

# width_mult, depth_mult, classifier dropout (torchvision efficientnet_bX).
_VARIANTS = {
    "efficientnet_b0": (1.0, 1.0, 0.2),
    "efficientnet_b1": (1.0, 1.1, 0.2),
    "efficientnet_b2": (1.1, 1.2, 0.3),
    "efficientnet_b3": (1.2, 1.4, 0.3),
    "efficientnet_b4": (1.4, 1.8, 0.4),
    "efficientnet_b5": (1.6, 2.2, 0.4),
    "efficientnet_b6": (1.8, 2.6, 0.5),
    "efficientnet_b7": (2.0, 3.1, 0.5),
}

# V2 stage tables: block kind, expand ratio, kernel, stride, c_in, c_out,
# repeats (torchvision ``_efficientnet_conf("efficientnet_v2_*")``); no
# multipliers, the head fixed at 1280.
_V2_TABLES = {
    "efficientnet_v2_s": (
        ("fused", 1, 3, 1, 24, 24, 2),
        ("fused", 4, 3, 2, 24, 48, 4),
        ("fused", 4, 3, 2, 48, 64, 4),
        ("mb", 4, 3, 2, 64, 128, 6),
        ("mb", 6, 3, 1, 128, 160, 9),
        ("mb", 6, 3, 2, 160, 256, 15),
    ),
    "efficientnet_v2_m": (
        ("fused", 1, 3, 1, 24, 24, 3),
        ("fused", 4, 3, 2, 24, 48, 5),
        ("fused", 4, 3, 2, 48, 80, 5),
        ("mb", 4, 3, 2, 80, 160, 7),
        ("mb", 6, 3, 1, 160, 176, 14),
        ("mb", 6, 3, 2, 176, 304, 18),
        ("mb", 6, 3, 1, 304, 512, 5),
    ),
    "efficientnet_v2_l": (
        ("fused", 1, 3, 1, 32, 32, 4),
        ("fused", 4, 3, 2, 32, 64, 7),
        ("fused", 4, 3, 2, 64, 96, 7),
        ("mb", 4, 3, 2, 96, 192, 10),
        ("mb", 6, 3, 1, 192, 224, 19),
        ("mb", 6, 3, 2, 224, 384, 25),
        ("mb", 6, 3, 1, 384, 640, 7),
    ),
}
_V2_DROPOUT = {"efficientnet_v2_s": 0.2, "efficientnet_v2_m": 0.3,
               "efficientnet_v2_l": 0.4}


class MBConv(nn.Module):
    """[1x1 expand] → k×k depthwise → SE → 1x1 project, the residual with
    stochastic depth when the stride is 1 and the widths match."""

    def __init__(self, inp: int, expanded: int, out: int, squeeze: int,
                 kernel: int = 3, strides: int = 1, sd_prob: float = 0.0, *,
                 bn: dict, dtype=None, device=None):
        super().__init__()
        kw = dict(bn=bn, dtype=dtype, device=device)
        self.sd_prob = sd_prob
        self.skip = strides == 1 and inp == out
        self.has_expand = expanded != inp
        if self.has_expand:
            self.expand = ConvBNAct(inp, expanded, 1, 1, act="silu", **kw)
        self.dw = ConvBNAct(expanded, expanded, kernel, strides,
                            groups=expanded, act="silu", **kw)
        self.se = SqueezeExcite(expanded, squeeze, act="silu",
                                gate="sigmoid", dtype=dtype, device=device)
        self.project = ConvBNAct(expanded, out, 1, 1, act=None, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.expand(x) if self.has_expand else x
        y = self.project(self.se(self.dw(y)))
        if self.skip:
            return x + stochastic_depth(y, self.sd_prob, self.training)
        return y


class FusedMBConv(nn.Module):
    """EfficientNetV2's early block: the 1x1 expand and the depthwise conv
    fused into one k×k conv, then the 1x1 project (at expand ratio 1 the
    one k×k conv does both); no squeeze-excite; the residual as MBConv's."""

    def __init__(self, inp: int, expanded: int, out: int, kernel: int = 3,
                 strides: int = 1, sd_prob: float = 0.0, *, bn: dict,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(bn=bn, dtype=dtype, device=device)
        self.sd_prob = sd_prob
        self.skip = strides == 1 and inp == out
        self.has_project = expanded != inp
        if self.has_project:
            self.fused = ConvBNAct(inp, expanded, kernel, strides,
                                   act="silu", **kw)
            self.project = ConvBNAct(expanded, out, 1, 1, act=None, **kw)
        else:
            self.fused = ConvBNAct(inp, out, kernel, strides, act="silu",
                                   **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.fused(x)
        if self.has_project:
            y = self.project(y)
        if self.skip:
            return x + stochastic_depth(y, self.sd_prob, self.training)
        return y


class _EfficientNet(nn.Module):
    """The stem, the blocks ``features_{s}_{i}`` in order, the head conv,
    the global mean, the dropout and the classifier."""

    def _build(self, stem: int, blocks: list, head_in: int, head: int,
               num_classes: int, dropout: float, bn: dict, dtype,
               device) -> None:
        """``blocks``: ``(name, module)`` pairs; the head conv takes the
        next ``features_`` index after the last stage's."""
        kw = dict(bn=bn, dtype=dtype, device=device)
        self.dtype = dtype
        self.features_0 = ConvBNAct(3, stem, 3, 2, act="silu", **kw)
        self.blocks = []
        for name, block in blocks:
            self.add_module(name, block)
            self.blocks.append(name)
        last_stage = int(blocks[-1][0].split("_")[1])
        self.head_name = f"features_{last_stage + 1}"
        self.add_module(self.head_name,
                        ConvBNAct(head_in, head, 1, 1, act="silu", **kw))
        self.drop = Dropout(dropout)
        self.classifier_1 = DenseTorch(
            head, num_classes, dtype=dtype, device=device,
            kernel_init=("uniform", math.sqrt(1.0 / num_classes)),
            bias_init="zeros")

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``(B, H, W, 3)`` images; returns ``(B, num_classes)``
        logits in the compute dtype."""
        x = x.to(self.dtype or x.dtype).permute(0, 3, 1, 2)
        x = self.features_0(x)
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = global_avg_pool(getattr(self, self.head_name)(x))
        return self.classifier_1(self.drop(x))


class EfficientNet(_EfficientNet):
    """torchvision-architecture EfficientNet B0–B7 over NHWC images."""

    def __init__(self, width_mult: float, depth_mult: float,
                 num_classes: int = 1000, *, dropout: float = 0.2,
                 stochastic_depth_prob: float = 0.2, bn_epsilon: float = 1e-5,
                 bn_momentum: float = 0.1, dtype=None,
                 sync_batchnorm: bool = False, device=None):
        super().__init__()
        bn = dict(epsilon=bn_epsilon, momentum=bn_momentum,
                  axis_name="data" if sync_batchnorm else None)
        kw = dict(bn=bn, dtype=dtype, device=device)

        def adjc(c):
            return _make_divisible(c * width_mult)

        def adjd(n):
            return int(math.ceil(n * depth_mult))

        total = sum(adjd(n) for *_, n in _BASE)
        blocks, block_id = [], 0
        for s, (ratio, k, stride, c_in, c_out, n) in enumerate(_BASE):
            c_in, c_out = adjc(c_in), adjc(c_out)
            for i in range(adjd(n)):
                blocks.append((f"features_{s + 1}_{i}", MBConv(
                    c_in, _make_divisible(c_in * ratio), c_out,
                    max(1, c_in // 4), k, stride if i == 0 else 1,
                    stochastic_depth_prob * block_id / total, **kw)))
                c_in = c_out
                block_id += 1
        self._build(adjc(_BASE[0][3]), blocks, c_in, 4 * c_in, num_classes,
                    dropout, bn, dtype, device)


class EfficientNetV2(_EfficientNet):
    """torchvision-architecture EfficientNetV2 over NHWC images."""

    def __init__(self, table, num_classes: int = 1000, *,
                 dropout: float = 0.2, stochastic_depth_prob: float = 0.2,
                 dtype=None, sync_batchnorm: bool = False, device=None):
        super().__init__()
        bn = dict(epsilon=1e-3, axis_name="data" if sync_batchnorm else None)
        kw = dict(bn=bn, dtype=dtype, device=device)
        total = sum(n for *_, n in table)
        blocks, block_id = [], 0
        for s, (kind, ratio, k, stride, c_in, c_out, n) in enumerate(table):
            for i in range(n):
                args = (c_in, c_in * ratio, c_out)
                more = (k, stride if i == 0 else 1,
                        stochastic_depth_prob * block_id / total)
                blocks.append((f"features_{s + 1}_{i}", FusedMBConv(
                    *args, *more, **kw) if kind == "fused" else MBConv(
                    *args, max(1, c_in // 4), *more, **kw)))
                c_in = c_out
                block_id += 1
        self._build(table[0][4], blocks, table[-1][5], 1280, num_classes,
                    dropout, bn, dtype, device)


def _ctor(name: str):
    width, depth, dropout = _VARIANTS[name]
    # torchvision gives b5/b6/b7 BN eps 1e-3, momentum 0.01; b0–b4 keep
    # BatchNorm2d's defaults.
    eps, mom = ((1e-3, 0.01) if name in ("efficientnet_b5", "efficientnet_b6",
                                         "efficientnet_b7") else (1e-5, 0.1))

    def build(num_classes: int = 1000, *, dtype=None,
              sync_batchnorm: bool = False, fused_bn: bool = True,
              device=None) -> EfficientNet:
        return EfficientNet(width, depth, num_classes, dropout=dropout,
                            bn_epsilon=eps, bn_momentum=mom, dtype=dtype,
                            sync_batchnorm=sync_batchnorm, device=device)
    build.__name__ = name
    return build


def _ctor_v2(name: str):
    def build(num_classes: int = 1000, *, dtype=None,
              sync_batchnorm: bool = False, fused_bn: bool = True,
              device=None) -> EfficientNetV2:
        return EfficientNetV2(_V2_TABLES[name], num_classes,
                              dropout=_V2_DROPOUT[name], dtype=dtype,
                              sync_batchnorm=sync_batchnorm, device=device)
    build.__name__ = name
    return build


efficientnet_b0 = _ctor("efficientnet_b0")
efficientnet_b1 = _ctor("efficientnet_b1")
efficientnet_b2 = _ctor("efficientnet_b2")
efficientnet_b3 = _ctor("efficientnet_b3")
efficientnet_b4 = _ctor("efficientnet_b4")
efficientnet_b5 = _ctor("efficientnet_b5")
efficientnet_b6 = _ctor("efficientnet_b6")
efficientnet_b7 = _ctor("efficientnet_b7")
efficientnet_v2_s = _ctor_v2("efficientnet_v2_s")
efficientnet_v2_m = _ctor_v2("efficientnet_v2_m")
efficientnet_v2_l = _ctor_v2("efficientnet_v2_l")
