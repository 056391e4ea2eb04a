"""MobileNetV2 and MobileNetV3 large/small (torchvision
``mobilenetv2.py`` / ``mobilenetv3.py``).

Counterpart of ``tpudist/models/mobilenet.py``. Module names are the
flax tree's: flat ``features_{i}`` blocks with ``expand``, ``dw``, ``se``
and ``project`` children, each a ``conv`` and a ``bn``.

- ``ConvBNAct`` fuses its activation into the BatchNorm only when it is
  a ReLU (``act="relu"``: the fused_norm kernels in train mode), as
  tpudist does: MobileNetV3's ReLU blocks (11 sites in
  mobilenet_v3_large) and regnet. ``relu6`` and ``hardswish`` follow a
  plain BatchNorm, so mobilenet_v2 reaches no kernel.
- Depthwise convs are grouped convs (``groups`` = channels); squeeze-
  excite is a global mean, two 1x1 convs with biases and a gate
  (``hardsigmoid`` = relu6(x + 3)/6, as torchvision's).
- MobileNetV3's BatchNorm has eps 1e-3 and momentum 0.01; the classifier
  Linears N(0, 0.01) with zero biases; dropout 0.2.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpudist_torch.models.layers import (BatchNorm, Conv2d, DenseTorch,
                                         Dropout, global_avg_pool,
                                         reset_parameters)


def _make_divisible(v: float, divisor: int = 8,
                    min_value: int | None = None) -> int:
    """torchvision ``_make_divisible``: round to the nearest multiple,
    never dropping more than 10 %."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_max(F.relu(x), 6.0)


def hardswish(x: torch.Tensor) -> torch.Tensor:
    return x * relu6(x + 3.0) / 6.0


def hardsigmoid(x: torch.Tensor) -> torch.Tensor:
    return relu6(x + 3.0) / 6.0


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu(approximate=False)``: the exact erf GELU."""
    return F.gelu(x)


ACTS = {"relu": F.relu, "relu6": relu6, "hardswish": hardswish,
        "hardsigmoid": hardsigmoid, "sigmoid": torch.sigmoid,
        "silu": F.silu, "gelu": gelu}


class ConvBNAct(nn.Module):
    """A bias-free kaiming conv, BatchNorm, and ``act`` (a name in
    ``ACTS``, or None): ``"relu"`` is fused into the BatchNorm."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 strides: int = 1, *, groups: int = 1,
                 act: str | None = "relu6", bn: dict, dtype=None,
                 device=None):
        super().__init__()
        self.act = act
        self.conv = Conv2d(in_features, features, kernel, strides,
                           groups=groups, dtype=dtype, device=device)
        self.bn = BatchNorm(features, dtype=dtype, device=device, **bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.act == "relu":
            return self.bn(x, act="relu")
        x = self.bn(x)
        return x if self.act is None else ACTS[self.act](x)


class SqueezeExcite(nn.Module):
    """torchvision's SE block: the global mean, a 1x1 reduce, ``act``, a
    1x1 expand and the ``gate`` scale (MobileNetV3: relu/hardsigmoid;
    regnet: relu/sigmoid). Both 1x1 convs carry biases (init 0) and the
    kaiming fan_out weights."""

    def __init__(self, channels: int, squeeze: int, *, act: str = "relu",
                 gate: str = "hardsigmoid", dtype=None, device=None):
        super().__init__()
        self.act, self.gate = act, gate
        kw = dict(use_bias=True, dtype=dtype, device=device)
        self.fc1 = Conv2d(channels, squeeze, 1, 1, **kw)
        self.fc2 = Conv2d(squeeze, channels, 1, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.fc2(ACTS[self.act](self.fc1(s)))
        return x * ACTS[self.gate](s)


class InvertedResidual(nn.Module):
    """V2/V3 inverted residual: [1x1 expand] → depthwise → [SE] → 1x1
    linear projection, with the skip when the stride is 1 and the widths
    match."""

    def __init__(self, in_features: int, expanded: int, out: int,
                 kernel: int = 3, strides: int = 1, *, use_se: bool = False,
                 act: str = "relu6", bn: dict, dtype=None, device=None):
        super().__init__()
        kw = dict(bn=bn, dtype=dtype, device=device)
        self.skip = strides == 1 and in_features == out
        self.has_expand = expanded != in_features
        if self.has_expand:
            self.expand = ConvBNAct(in_features, expanded, 1, 1, act=act,
                                    **kw)
        self.dw = ConvBNAct(expanded, expanded, kernel, strides,
                            groups=expanded, act=act, **kw)
        self.se = (SqueezeExcite(expanded, _make_divisible(expanded // 4, 8),
                                 dtype=dtype, device=device)
                   if use_se else None)
        self.project = ConvBNAct(expanded, out, 1, 1, act=None, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.expand(x) if self.has_expand else x
        y = self.dw(y)
        if self.se is not None:
            y = self.se(y)
        y = self.project(y)
        return x + y if self.skip else y


# t (expand ratio), c (out), n (repeats), s (stride): torchvision mobilenetv2
_V2_CFG = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]

# kernel, expanded, out, SE, activation, stride: torchvision mobilenetv3
_V3_LARGE = [
    (3, 16, 16, False, "RE", 1), (3, 64, 24, False, "RE", 2),
    (3, 72, 24, False, "RE", 1), (5, 72, 40, True, "RE", 2),
    (5, 120, 40, True, "RE", 1), (5, 120, 40, True, "RE", 1),
    (3, 240, 80, False, "HS", 2), (3, 200, 80, False, "HS", 1),
    (3, 184, 80, False, "HS", 1), (3, 184, 80, False, "HS", 1),
    (3, 480, 112, True, "HS", 1), (3, 672, 112, True, "HS", 1),
    (5, 672, 160, True, "HS", 2), (5, 960, 160, True, "HS", 1),
    (5, 960, 160, True, "HS", 1),
]
_V3_SMALL = [
    (3, 16, 16, True, "RE", 2), (3, 72, 24, False, "RE", 2),
    (3, 88, 24, False, "RE", 1), (5, 96, 40, True, "HS", 2),
    (5, 240, 40, True, "HS", 1), (5, 240, 40, True, "HS", 1),
    (5, 120, 48, True, "HS", 1), (5, 144, 48, True, "HS", 1),
    (5, 288, 96, True, "HS", 2), (5, 576, 96, True, "HS", 1),
    (5, 576, 96, True, "HS", 1),
]


class _MobileNet(nn.Module):
    """The blocks ``features_0`` … ``features_n`` in order, then the
    global mean; the subclasses add the classifier."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_parameters(self, generator)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype or x.dtype).permute(0, 3, 1, 2)
        for i in range(self.n_features):
            x = getattr(self, f"features_{i}")(x)
        return global_avg_pool(x)


class MobileNetV2(_MobileNet):
    """torchvision-architecture MobileNetV2 over NHWC images."""

    def __init__(self, num_classes: int = 1000, *, width_mult: float = 1.0,
                 dtype=None, dropout: float = 0.2, fused_bn: bool = True,
                 sync_batchnorm: bool = False, device=None):
        super().__init__()
        self.dtype = dtype
        bn = dict(fused=fused_bn, axis_name="data" if sync_batchnorm else None)
        kw = dict(bn=bn, dtype=dtype, device=device)
        c_in = _make_divisible(32 * width_mult)
        self.features_0 = ConvBNAct(3, c_in, 3, 2, **kw)
        i = 1
        for t, c, n, s in _V2_CFG:
            c_out = _make_divisible(c * width_mult)
            for j in range(n):
                self.add_module(f"features_{i}", InvertedResidual(
                    c_in, c_in * t, c_out, 3, s if j == 0 else 1, **kw))
                c_in = c_out
                i += 1
        c_last = _make_divisible(1280 * max(width_mult, 1.0))
        self.add_module(f"features_{i}", ConvBNAct(c_in, c_last, 1, 1, **kw))
        self.n_features = i + 1
        self.drop = Dropout(dropout)
        self.classifier_1 = DenseTorch(c_last, num_classes, dtype=dtype,
                                       device=device,
                                       kernel_init=("normal", 0.01),
                                       bias_init="zeros")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``(B, H, W, 3)`` images; returns ``(B, num_classes)``
        logits in the compute dtype."""
        return self.classifier_1(self.drop(self.trunk(x)))


class MobileNetV3(_MobileNet):
    """torchvision-architecture MobileNetV3 over NHWC images."""

    def __init__(self, cfg, last_channel: int, num_classes: int = 1000, *,
                 dtype=None, dropout: float = 0.2, fused_bn: bool = True,
                 sync_batchnorm: bool = False, device=None):
        super().__init__()
        self.dtype = dtype
        # torchvision V3 BN: eps 0.001, momentum 0.01
        bn = dict(fused=fused_bn, epsilon=1e-3, momentum=0.01,
                  axis_name="data" if sync_batchnorm else None)
        kw = dict(bn=bn, dtype=dtype, device=device)
        self.features_0 = ConvBNAct(3, 16, 3, 2, act="hardswish", **kw)
        c_in = 16
        for i, (k, exp, out, se, nl, s) in enumerate(cfg, start=1):
            self.add_module(f"features_{i}", InvertedResidual(
                c_in, exp, out, k, s, use_se=se,
                act="hardswish" if nl == "HS" else "relu", **kw))
            c_in = out
        n = len(cfg) + 1
        self.add_module(f"features_{n}", ConvBNAct(c_in, 6 * c_in, 1, 1,
                                                   act="hardswish", **kw))
        self.n_features = n + 1
        fc = dict(dtype=dtype, device=device, kernel_init=("normal", 0.01),
                  bias_init="zeros")
        self.classifier_0 = DenseTorch(6 * c_in, last_channel, **fc)
        self.drop = Dropout(dropout)
        self.classifier_3 = DenseTorch(last_channel, num_classes, **fc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``(B, H, W, 3)`` images; returns ``(B, num_classes)``
        logits in the compute dtype."""
        x = hardswish(self.classifier_0(self.trunk(x)))
        return self.classifier_3(self.drop(x))


def _ctor(build):
    def ctor(num_classes: int = 1000, *, dtype=None,
             sync_batchnorm: bool = False, fused_bn: bool = True,
             dropout: float = 0.2, device=None):
        return build(num_classes=num_classes, dtype=dtype, dropout=dropout,
                     fused_bn=fused_bn, sync_batchnorm=sync_batchnorm,
                     device=device)
    return ctor


mobilenet_v2 = _ctor(MobileNetV2)
mobilenet_v3_large = _ctor(lambda **kw: MobileNetV3(_V3_LARGE, 1280, **kw))
mobilenet_v3_small = _ctor(lambda **kw: MobileNetV3(_V3_SMALL, 1024, **kw))
