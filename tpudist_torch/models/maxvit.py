"""MaxViT-T (torchvision ``maxvit.py``).

Counterpart of ``tpudist/models/maxvit.py``. Module names are the flax
tree's: the stem ``stem_0``/``stem_0_bn``/``stem_1``, the layers
``block_{s}_{i}_{mbconv,window,grid}`` and the head ``classifier_2``/
``_3``/``_5``. Activations of the attention halves stay NHWC.

- Each layer: a pre-norm MBConv (BatchNorm → 1x1 expand to 4x the output
  → BatchNorm → exact GELU → 3x3 depthwise (the stride) → BatchNorm →
  GELU → squeeze-excite (SiLU, sigmoid gate, ``out // 4``) → 1x1
  projection with a bias; on a stride or width change the shortcut is a
  3x3/s2 average pool (pads counted) and a 1x1 conv with a bias), then
  relative-position attention over contiguous 7x7 windows
  (``_window_partition``), then over 7x7 dilated grids
  (``_grid_partition``), each as LayerNorm (eps 1e-6) → attention →
  residual, LayerNorm → 4x MLP (exact GELU) → residual.
- BatchNorm: eps 1e-3 and momentum 0.99 (torch's convention: the batch
  statistic's weight; tpudist keeps torchvision's port of the TF
  setting). Every BatchNorm is plain (its GELU outside it), so as in
  tpudist no BatchNorm asks for the fused epilogue and the model reaches
  no kernel of the port.
- The attention: packed qkv (qkv-major here, as torchvision's), K scaled
  by ``dim ** -0.5`` (torchvision's), the relative-position bias table
  (``swin._rel_pos_index``), softmax and the merge Linear in the compute
  dtype; biased attention never takes the flash kernels.
- Stochastic depth (row mode): layer ``k`` of 11 at rate
  ``linspace(0, 0.2, 11)[k]`` on its MBConv and on both residuals of its
  window and grid halves, one keep per image across its windows.
- Linears, the bias tables: truncated normal std 0.02, zero biases;
  convs kaiming fan_out.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tpudist_torch.models.layers import (TRUNC02, BatchNorm, Conv2d,
                                         DeviceConstants, LayerNorm,
                                         add_conv_bn, avg_pool_padded,
                                         conv_bn, dense, draw_init,
                                         reset_parameters, stochastic_depth)
from tpudist_torch.models.mobilenet import SqueezeExcite, gelu
from tpudist_torch.models.swin import _rel_pos_index


def _window_partition(x: torch.Tensor, p: int):
    """(B, H, W, C) → (B·nh·nw, p·p, C): contiguous p×p windows."""
    b, h, w, c = x.shape
    nh, nw = h // p, w // p
    x = x.reshape(b, nh, p, nw, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * nh * nw, p * p, c), (b, nh, nw)


def _window_reverse(x: torch.Tensor, p: int, dims) -> torch.Tensor:
    b, nh, nw = dims
    x = x.reshape(b, nh, nw, p, p, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, nh * p, nw * p, -1)


def _grid_partition(x: torch.Tensor, p: int):
    """(B, H, W, C) → (B·gh·gw, p·p, C): p×p dilated windows; token
    (i, j) of group (a, b) sits at (i·gh + a, j·gw + b), gh = H / p."""
    b, h, w, c = x.shape
    gh, gw = h // p, w // p
    x = x.reshape(b, p, gh, p, gw, c).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b * gh * gw, p * p, c), (b, gh, gw)


def _grid_reverse(x: torch.Tensor, p: int, dims) -> torch.Tensor:
    b, gh, gw = dims
    x = x.reshape(b, gh, gw, p, p, -1).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, p * gh, p * gw, -1)


class RelPosAttention(nn.Module):
    """torchvision's ``RelativePositionalMultiHeadAttention`` over
    ``(N, L, C)`` partitions."""

    def __init__(self, dim: int, head_dim: int, partition: int, *,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dim, self.head_dim, self.partition = dim, head_dim, partition
        self.heads = dim // head_dim
        self.to_qkv = dense(dim, 3 * self.heads * head_dim, **kw)
        self.merge = dense(self.heads * head_dim, dim, **kw)
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (2 * partition - 1) ** 2, self.heads, dtype=torch.float32,
            device=device))
        self.consts = DeviceConstants()

    @torch.no_grad()
    def reset_own(self, generator: torch.Generator) -> None:
        w = torch.empty(self.relative_position_bias_table.shape)
        draw_init(w, TRUNC02, generator)
        self.relative_position_bias_table.copy_(w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        l, heads, hd = x.shape[1], self.heads, self.head_dim
        q, k, v = self.to_qkv(x).view(-1, l, 3, heads, hd).unbind(2)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # (N, heads, L, d)
        k = k * self.dim ** -0.5
        attn = q @ k.transpose(-2, -1)
        idx = self.consts.get(
            "idx", lambda: _rel_pos_index(self.partition).reshape(-1),
            x.device)
        bias = self.relative_position_bias_table[idx].reshape(l, l, heads)
        attn = torch.softmax(attn + bias.permute(2, 0, 1).to(attn.dtype),
                             dim=-1)
        y = (attn @ v).transpose(1, 2).reshape(-1, l, heads * hd)
        return self.merge(y)


class MaxVitMBConv(nn.Module):
    """The pre-norm MBConv with its shortcut and stochastic depth; NCHW
    channels_last in and out."""

    def __init__(self, inp: int, out: int, strides: int = 1,
                 sd_prob: float = 0.0, *, bn: dict, dtype=None, device=None):
        super().__init__()
        mid = 4 * out
        kw = dict(bn=bn, dtype=dtype, device=device)
        self.strides, self.sd_prob = strides, sd_prob
        self.pre_norm = BatchNorm(inp, dtype=dtype, device=device, **bn)
        add_conv_bn(self, "conv_a", inp, mid, 1, 1, **kw)
        add_conv_bn(self, "conv_b", mid, mid, 3, strides, groups=mid, **kw)
        self.squeeze_excitation = SqueezeExcite(
            mid, out // 4, act="silu", gate="sigmoid", dtype=dtype,
            device=device)
        conv = dict(use_bias=True, dtype=dtype, device=device)
        self.conv_c = Conv2d(mid, out, 1, 1, **conv)
        self.has_proj = strides == 2 or inp != out
        if self.has_proj:
            self.proj = Conv2d(inp, out, 1, 1, **conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pre_norm(x)
        y = gelu(conv_bn(self, "conv_a", y, False))
        y = gelu(conv_bn(self, "conv_b", y, False))
        y = self.conv_c(self.squeeze_excitation(y))
        if self.has_proj:
            if self.strides == 2:
                x = avg_pool_padded(x, 3, 2, 1)
            x = self.proj(x)
        return x + stochastic_depth(y, self.sd_prob, self.training)


class PartitionAttention(nn.Module):
    """LayerNorm → relative attention → residual, LayerNorm → MLP (4x,
    exact GELU) → residual, over window or grid partitions of an NHWC
    map (torchvision's ``PartitionAttentionLayer``)."""

    def __init__(self, dim: int, head_dim: int, partition: int, *,
                 grid: bool = False, sd_prob: float = 0.0, dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.partition, self.grid, self.sd_prob = partition, grid, sd_prob
        self.attn_norm = LayerNorm(dim, **kw)
        self.attn = RelPosAttention(dim, head_dim, partition, **kw)
        self.mlp_norm = LayerNorm(dim, **kw)
        self.mlp_0 = dense(dim, 4 * dim, **kw)
        self.mlp_2 = dense(4 * dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:      # (B, H, W, C)
        part, rev = ((_grid_partition, _grid_reverse) if self.grid
                     else (_window_partition, _window_reverse))
        xw, dims = part(x, self.partition)

        def drop(y):
            # One keep per image across its windows (torchvision masks
            # dim 0 of its (B, nW, L, C) partitions).
            return stochastic_depth(y, self.sd_prob, self.training,
                                    rows=dims[0])

        xw = xw + drop(self.attn(self.attn_norm(xw)))
        y = self.mlp_2(gelu(self.mlp_0(self.mlp_norm(xw))))
        return rev(xw + drop(y), self.partition, dims)


class MaxVit(nn.Module):
    """torchvision-architecture MaxViT over NHWC images; each stage's map
    must be a multiple of the partition (224 px for maxvit_t)."""

    def __init__(self, num_classes: int = 1000, *, stem_channels: int = 64,
                 block_channels=(64, 128, 256, 512), block_layers=(2, 2, 5, 2),
                 head_dim: int = 32, partition: int = 7,
                 stochastic_depth_prob: float = 0.2, dtype=None,
                 sync_batchnorm: bool = False, device=None):
        super().__init__()
        self.dtype, self.partition = dtype, partition
        bn = dict(epsilon=1e-3, momentum=0.99,
                  axis_name="data" if sync_batchnorm else None)
        kw = dict(dtype=dtype, device=device)
        add_conv_bn(self, "stem_0", 3, stem_channels, 3, 2, bn=bn, **kw)
        self.stem_1 = Conv2d(stem_channels, stem_channels, 3, 1,
                             use_bias=True, **kw)
        sd = np.linspace(0.0, stochastic_depth_prob, sum(block_layers))
        self.layers, li, c = [], 0, stem_channels
        for s, (ch, n) in enumerate(zip(block_channels, block_layers)):
            for i in range(n):
                p, name = float(sd[li]), f"block_{s}_{i}"
                self.add_module(f"{name}_mbconv", MaxVitMBConv(
                    c, ch, 2 if i == 0 else 1, p, bn=bn, **kw))
                for part in ("window", "grid"):
                    self.add_module(f"{name}_{part}", PartitionAttention(
                        ch, head_dim, partition, grid=part == "grid",
                        sd_prob=p, **kw))
                self.layers.append(name)
                li, c = li + 1, ch
        self.classifier_2 = LayerNorm(c, **kw)
        self.classifier_3 = dense(c, c, **kw)
        self.classifier_5 = dense(c, num_classes, use_bias=False, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``(B, H, W, 3)`` images; returns ``(B, num_classes)``
        logits in the compute dtype."""
        x = x.to(self.dtype or x.dtype).permute(0, 3, 1, 2)
        x = self.stem_1(gelu(conv_bn(self, "stem_0", x, False)))
        for name in self.layers:
            x = getattr(self, f"{name}_mbconv")(x)
            h, w = x.shape[2:]
            if h % self.partition or w % self.partition:
                raise ValueError(
                    f"maxvit {name}: feature map {h}x{w} is not divisible "
                    f"by the partition size {self.partition}; use an input "
                    f"that reduces to multiples of {self.partition} (224 "
                    f"for the canonical config)")
            xh = x.permute(0, 2, 3, 1)                       # NHWC view
            xh = getattr(self, f"{name}_window")(xh)
            xh = getattr(self, f"{name}_grid")(xh)
            x = xh.permute(0, 3, 1, 2)
        x = self.classifier_2(x.permute(0, 2, 3, 1).mean(dim=(1, 2)))
        return self.classifier_5(torch.tanh(self.classifier_3(x)))


def maxvit_t(num_classes: int = 1000, *, dtype=None,
             sync_batchnorm: bool = False, fused_bn: bool = True,
             device=None) -> MaxVit:
    return MaxVit(num_classes, dtype=dtype, sync_batchnorm=sync_batchnorm,
                  device=device)
