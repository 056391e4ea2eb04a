"""DenseNet 121/161/169/201 (torchvision ``densenet.py``).

Counterpart of ``tpudist/models/densenet.py``. Module names are the flax
tree's: torchvision's ``features.denseblock1.denselayer1.norm1`` is
``denseblock1_denselayer1.norm1``, ``features.transition1.norm``
``transition1_norm``.

- Every BatchNorm is a BN+ReLU epilogue (``act="relu"``): norm0, norm1
  and norm2 of each dense layer, each transition's norm and norm5, 121
  sites in densenet121; in train mode they run the fused_norm kernels.
- A dense layer concatenates its input and its new features along the
  channels (``torch.cat`` of two channels_last tensors is channels_last),
  so each BatchNorm reads contiguous ``(N·H·W, C)`` rows without a copy.
- Convs are bias-free with kaiming fan_out weights; the classifier keeps
  torch.nn.Linear's default init.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpudist_torch.models.layers import (BatchNorm, Conv2d, DenseTorch,
                                         global_avg_pool, reset_parameters)


class DenseLayer(nn.Module):
    def __init__(self, in_features: int, growth_rate: int, bn_size: int, *,
                 bn: dict, dtype=None, device=None):
        super().__init__()
        inner = bn_size * growth_rate
        conv = dict(dtype=dtype, device=device)
        self.norm1 = BatchNorm(in_features, **bn)
        self.conv1 = Conv2d(in_features, inner, 1, 1, **conv)
        self.norm2 = BatchNorm(inner, **bn)
        self.conv2 = Conv2d(inner, growth_rate, 3, 1, **conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(self.norm1(x, act="relu"))
        y = self.conv2(self.norm2(y, act="relu"))
        return torch.cat([x, y], dim=1)


class DenseNet(nn.Module):
    """torchvision-architecture DenseNet over NHWC images; ``dtype`` is
    the compute dtype, ``fused_bn`` and ``sync_batchnorm`` as in
    ``ResNet``."""

    def __init__(self, block_config, growth_rate: int = 32,
                 num_init_features: int = 64, bn_size: int = 4,
                 num_classes: int = 1000, *, dtype=None,
                 fused_bn: bool = True, sync_batchnorm: bool = False,
                 device=None):
        super().__init__()
        self.dtype = dtype
        bn = dict(dtype=dtype, fused=fused_bn, device=device,
                  axis_name="data" if sync_batchnorm else None)
        conv = dict(dtype=dtype, device=device)
        self.conv0 = Conv2d(3, num_init_features, 7, 2, **conv)
        self.norm0 = BatchNorm(num_init_features, **bn)
        # The forward's plan: dense layers, then each transition.
        self.plan: list[tuple[str, str]] = []
        features = num_init_features
        for bi, num_layers in enumerate(block_config):
            for li in range(num_layers):
                name = f"denseblock{bi + 1}_denselayer{li + 1}"
                self.add_module(name, DenseLayer(
                    features, growth_rate, bn_size, bn=bn, **conv))
                self.plan.append(("layer", name))
                features += growth_rate
            if bi != len(block_config) - 1:
                t = f"transition{bi + 1}"
                self.add_module(f"{t}_norm", BatchNorm(features, **bn))
                self.add_module(f"{t}_conv", Conv2d(features, features // 2,
                                                    1, 1, **conv))
                self.plan.append(("transition", t))
                features //= 2
        self.norm5 = BatchNorm(features, **bn)
        self.classifier = DenseTorch(features, num_classes, **conv)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``(B, H, W, 3)`` images; returns ``(B, num_classes)``
        logits in the compute dtype."""
        x = x.to(self.dtype or x.dtype).permute(0, 3, 1, 2)
        x = self.norm0(self.conv0(x), act="relu")
        x = F.max_pool2d(x, 3, 2, 1)
        for kind, name in self.plan:
            if kind == "layer":
                x = getattr(self, name)(x)
                continue
            x = getattr(self, f"{name}_norm")(x, act="relu")
            x = F.avg_pool2d(getattr(self, f"{name}_conv")(x), 2, 2)
        x = self.norm5(x, act="relu")
        return self.classifier(global_avg_pool(x))


def _densenet(block_config, growth_rate: int = 32,
              num_init_features: int = 64):
    def ctor(num_classes: int = 1000, *, dtype=None,
             sync_batchnorm: bool = False, fused_bn: bool = True,
             device=None) -> DenseNet:
        return DenseNet(block_config, growth_rate, num_init_features,
                        num_classes=num_classes, dtype=dtype,
                        fused_bn=fused_bn, sync_batchnorm=sync_batchnorm,
                        device=device)
    return ctor


densenet121 = _densenet([6, 12, 24, 16])
densenet169 = _densenet([6, 12, 32, 32])
densenet201 = _densenet([6, 12, 48, 32])
densenet161 = _densenet([6, 12, 36, 24], growth_rate=48,
                        num_init_features=96)
