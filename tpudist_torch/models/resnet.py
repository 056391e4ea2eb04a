"""ResNet family (torchvision-architecture resnet18 … wide_resnet101_2).

Counterpart of ``tpudist/models/resnet.py``: BasicBlock/Bottleneck (with
ResNeXt/WideResNet's groups and base width), stage widths ``width·2^i``,
7x7/s2 stem (direct or space-to-depth), max pool, global average pool, fc.

- Images are NHWC at the public API; the trunk runs on NCHW tensors laid
  out channels_last (the same memory), so every BatchNorm epilogue sees
  contiguous ``(N·H·W, C)`` rows.
- Every BN+ReLU and BN+add+ReLU epilogue goes through
  ``layers.BatchNorm``'s fused branch in train mode (``fused_bn=True``);
  ``downsample_bn`` has no activation and always takes the plain path.
- Parameter and buffer names mirror the flax tree (``layer1_0.conv1.weight``
  is ``layer1_0/conv1/kernel``; ``layer1_0.bn1.mean`` is the batch_stats
  leaf ``layer1_0/bn1/mean``), so ``compat.jax_params`` is a transpose per
  leaf.

``remat`` comes later.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpudist_torch.models.layers import (BatchNorm, Conv2d, DenseTorch,
                                         global_avg_pool, reset_parameters)


class _StemConvS2D(Conv2d):
    """The 7x7/stride-2 stem conv, direct or via space-to-depth.

    The parameter is the original ``(F, C, 7, 7)`` kernel either way. With
    ``s2d`` the input's 2x2 pixel blocks are packed into channels (H, W, C
    → H/2, W/2, 4C) and the same kernel, front-padded with one zero tap and
    folded to ``(F, 4C, 4, 4)``, runs at stride 1 with padding (2, 1):
    exact up to float summation order (tpudist's ``_StemConvS2D``).
    Takes NHWC images, returns an NCHW channels_last activation."""

    def __init__(self, in_features: int, features: int, *, s2d: bool = False,
                 dtype=None, device=None):
        super().__init__(in_features, features, 7, 2, padding=3, dtype=dtype,
                         device=device)
        self.s2d = bool(s2d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        n, h, w, c = x.shape
        if not self.s2d or h % 2 or w % 2:            # odd inputs: direct
            return super().forward(x.permute(0, 3, 1, 2))
        xs = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        xs = xs.reshape(n, h // 2, w // 2, 4 * c).permute(0, 3, 1, 2)
        k = F.pad(self.weight.permute(2, 3, 1, 0), (0, 0, 0, 0, 1, 0, 1, 0))
        k = k.reshape(4, 2, 4, 2, c, -1).permute(0, 2, 1, 3, 4, 5)
        k = k.reshape(4, 4, 4 * c, -1).permute(3, 2, 0, 1)
        xs = F.pad(xs.to(dt), (2, 1, 2, 1))
        return F.conv2d(xs, k.to(dtype=dt, memory_format=torch.channels_last))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_features: int, features: int, strides: int = 1, *,
                 groups: int = 1, base_width: int = 64, dtype=None,
                 fused: bool = True, axis_name: str | None = None,
                 device=None):
        super().__init__()
        if groups != 1 or base_width != 64:
            raise ValueError("BasicBlock only supports groups=1 and "
                             "base_width=64")
        conv = dict(dtype=dtype, device=device)
        bn = dict(dtype=dtype, fused=fused, axis_name=axis_name,
                  device=device)
        self.conv1 = Conv2d(in_features, features, 3, strides, **conv)
        self.bn1 = BatchNorm(features, **bn)
        self.conv2 = Conv2d(features, features, 3, 1, **conv)
        self.bn2 = BatchNorm(features, **bn)
        self.downsample = strides != 1 or in_features != features
        if self.downsample:
            self.downsample_conv = Conv2d(in_features, features, 1, strides,
                                          **conv)
            self.downsample_bn = BatchNorm(features, **bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn1(self.conv1(x), act="relu")
        y = self.conv2(y)
        residual = x
        if self.downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return self.bn2(y, act="relu", residual=residual)


class Bottleneck(nn.Module):
    """torchvision Bottleneck incl. the ResNeXt/WideResNet generalization:
    inner width = int(features·base_width/64)·groups, grouped 3x3."""
    expansion = 4

    def __init__(self, in_features: int, features: int, strides: int = 1, *,
                 groups: int = 1, base_width: int = 64, dtype=None,
                 fused: bool = True, axis_name: str | None = None,
                 device=None):
        super().__init__()
        conv = dict(dtype=dtype, device=device)
        bn = dict(dtype=dtype, fused=fused, axis_name=axis_name,
                  device=device)
        width = int(features * (base_width / 64.0)) * groups
        out = features * self.expansion
        self.conv1 = Conv2d(in_features, width, 1, 1, **conv)
        self.bn1 = BatchNorm(width, **bn)
        self.conv2 = Conv2d(width, width, 3, strides, groups=groups, **conv)
        self.bn2 = BatchNorm(width, **bn)
        self.conv3 = Conv2d(width, out, 1, 1, **conv)
        self.bn3 = BatchNorm(out, **bn)
        self.downsample = strides != 1 or in_features != out
        if self.downsample:
            self.downsample_conv = Conv2d(in_features, out, 1, strides,
                                          **conv)
            self.downsample_bn = BatchNorm(out, **bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn1(self.conv1(x), act="relu")
        y = self.bn2(self.conv2(y), act="relu")
        y = self.conv3(y)
        residual = x
        if self.downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return self.bn3(y, act="relu", residual=residual)


class ResNet(nn.Module):
    """torchvision-architecture ResNet over NHWC images.

    ``dtype`` is the compute dtype (bf16 under the AMP policy); parameters
    stay f32. ``fused_bn`` routes the train-mode BN epilogues through the
    fused_norm kernels (``--fused-bn on``) or the plain epilogue (off);
    ``sync_batchnorm`` makes every BatchNorm SyncBN (``axis_name="data"``,
    the reference's ``convert_sync_batchnorm``), which takes the plain
    epilogue."""

    def __init__(self, stage_sizes, block, num_classes: int = 1000, *,
                 width: int = 64, dtype=None, s2d_stem: bool = False,
                 fused_bn: bool = True, groups: int = 1,
                 base_width: int = 64, sync_batchnorm: bool = False,
                 device=None):
        super().__init__()
        self.dtype = dtype
        axis = "data" if sync_batchnorm else None
        self.conv1 = _StemConvS2D(3, width, s2d=s2d_stem, dtype=dtype,
                                  device=device)
        self.bn1 = BatchNorm(width, dtype=dtype, fused=fused_bn,
                             axis_name=axis, device=device)
        self.block_names = []
        in_features = width
        for i, num_blocks in enumerate(stage_sizes):
            features = width * (2 ** i)
            for j in range(num_blocks):
                name = f"layer{i + 1}_{j}"
                self.add_module(name, block(
                    in_features, features, 2 if i > 0 and j == 0 else 1,
                    groups=groups, base_width=base_width, dtype=dtype,
                    fused=fused_bn, axis_name=axis, device=device))
                self.block_names.append(name)
                in_features = features * block.expansion
        self.fc = DenseTorch(in_features, num_classes, dtype=dtype,
                             device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The flax init, drawn from ``generator`` (a CPU generator):
        kaiming-normal (fan_out) convs, U(±1/√fan_in) fc, unit BN scales,
        zero BN biases, running mean 0 and var 1."""
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``(B, H, W, 3)`` images; returns ``(B, num_classes)``
        logits in the compute dtype."""
        x = x.to(self.dtype or x.dtype)
        x = self.bn1(self.conv1(x), act="relu")
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.fc(global_avg_pool(x))


def _resnet(stage_sizes, block, groups: int = 1, width_per_group: int = 64):
    def ctor(num_classes: int = 1000, *, dtype=None,
             sync_batchnorm: bool = False, remat: bool = False,
             fused_bn: bool = True, width: int = 64, s2d_stem: bool = False,
             device=None) -> ResNet:
        if remat:
            raise NotImplementedError("remat: block checkpointing is not in "
                                      "the port yet")
        return ResNet(stage_sizes, block, num_classes, width=width,
                      dtype=dtype, s2d_stem=s2d_stem, fused_bn=fused_bn,
                      groups=groups, base_width=width_per_group,
                      sync_batchnorm=sync_batchnorm, device=device)
    return ctor


resnet18 = _resnet([2, 2, 2, 2], BasicBlock)
resnet34 = _resnet([3, 4, 6, 3], BasicBlock)
resnet50 = _resnet([3, 4, 6, 3], Bottleneck)
resnet101 = _resnet([3, 4, 23, 3], Bottleneck)
resnet152 = _resnet([3, 8, 36, 3], Bottleneck)
# ResNeXt / WideResNet (torchvision resnet.py resnext50_32x4d/wide_resnet50_2)
resnext50_32x4d = _resnet([3, 4, 6, 3], Bottleneck, groups=32,
                          width_per_group=4)
resnext101_32x8d = _resnet([3, 4, 23, 3], Bottleneck, groups=32,
                           width_per_group=8)
wide_resnet50_2 = _resnet([3, 4, 6, 3], Bottleneck, width_per_group=128)
wide_resnet101_2 = _resnet([3, 4, 23, 3], Bottleneck, width_per_group=128)
