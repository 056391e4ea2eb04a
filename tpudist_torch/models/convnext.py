"""ConvNeXt tiny/small/base/large (torchvision ``convnext.py``).

Counterpart of ``tpudist/models/convnext.py``. Module names are the flax
tree's: the stem ``features_0_conv``/``features_0_norm``, the blocks
``features_{s}_{i}`` (``dwconv``, ``norm``, ``mlp_fc1``, ``mlp_fc2`` and
the parameter ``layer_scale``), the downsamplers ``features_{s}_norm``/
``features_{s}_conv`` and the head ``classifier_0``/``classifier_2``.

- Activations stay NHWC; a conv runs on the NCHW view of that memory
  (channels_last), so no block permutes a copy.
- A block: the 7x7 depthwise conv (bias), LayerNorm (eps 1e-6), the 4x
  MLP with exact GELU, ``layer_scale`` (shape (C,), init 1e-6;
  torchvision stores (C, 1, 1)), row-mode stochastic depth and the
  residual. The rate ramps over ``blocks − 1``: ``p · block /
  (blocks − 1)``.
- Every conv and Linear: truncated normal std 0.02, zero bias. No
  BatchNorm: the model reaches no kernel of the port, and
  ``sync_batchnorm`` is accepted and ignored, as tpudist's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpudist_torch.models.layers import (TRUNC02, Conv2d, LayerNorm,
                                         conv_nhwc, dense, reset_parameters,
                                         stochastic_depth)

# ((c_in, c_out after the downsampler or None, blocks) per stage,
# stochastic depth) of torchvision's convnext_{tiny,small,base,large}.
_VARIANTS = {
    "convnext_tiny": (((96, 192, 3), (192, 384, 3), (384, 768, 9),
                       (768, None, 3)), 0.1),
    "convnext_small": (((96, 192, 3), (192, 384, 3), (384, 768, 27),
                        (768, None, 3)), 0.4),
    "convnext_base": (((128, 256, 3), (256, 512, 3), (512, 1024, 27),
                       (1024, None, 3)), 0.5),
    "convnext_large": (((192, 384, 3), (384, 768, 3), (768, 1536, 27),
                        (1536, None, 3)), 0.5),
}


class CNBlock(nn.Module):
    def __init__(self, dim: int, sd_prob: float = 0.0,
                 layer_scale: float = 1e-6, *, dtype=None, device=None):
        super().__init__()
        self.sd_prob = sd_prob
        self.layer_scale_init = layer_scale
        self.dwconv = Conv2d(dim, dim, 7, 1, groups=dim, padding=3,
                             use_bias=True, init=TRUNC02, dtype=dtype,
                             device=device)
        self.norm = LayerNorm(dim, epsilon=1e-6, dtype=dtype, device=device)
        self.mlp_fc1 = dense(dim, 4 * dim, dtype, device)
        self.mlp_fc2 = dense(4 * dim, dim, dtype, device)
        self.layer_scale = nn.Parameter(torch.full(
            (dim,), layer_scale, dtype=torch.float32, device=device))

    @torch.no_grad()
    def reset_own(self, generator=None) -> None:
        self.layer_scale.fill_(self.layer_scale_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:      # (B, H, W, C)
        y = self.norm(conv_nhwc(self.dwconv, x))
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(y)))
        y = y * self.layer_scale.to(y.dtype)
        return x + stochastic_depth(y, self.sd_prob, self.training)


class ConvNeXt(nn.Module):
    """torchvision-architecture ConvNeXt over NHWC images."""

    def __init__(self, block_setting, stochastic_depth_prob: float = 0.0,
                 num_classes: int = 1000, *, dtype=None, device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        c0 = block_setting[0][0]
        # The 4x4/s4 patchify stem (bias) and its LayerNorm.
        self.features_0_conv = Conv2d(3, c0, 4, 4, padding=0, use_bias=True,
                                      init=TRUNC02, **kw)
        self.features_0_norm = LayerNorm(c0, epsilon=1e-6, **kw)
        total = sum(n for *_, n in block_setting)
        self.layout, block_id, feat = [], 0, 1
        for c_in, c_out, n in block_setting:
            for i in range(n):
                name = f"features_{feat}_{i}"
                self.add_module(name, CNBlock(
                    c_in, stochastic_depth_prob * block_id
                    / max(total - 1.0, 1.0), **kw))
                self.layout.append((name, True))
                block_id += 1
            feat += 1
            if c_out is not None:
                self.add_module(f"features_{feat}_norm",
                                LayerNorm(c_in, epsilon=1e-6, **kw))
                self.add_module(f"features_{feat}_conv", Conv2d(
                    c_in, c_out, 2, 2, padding=0, use_bias=True,
                    init=TRUNC02, **kw))
                self.layout.append((f"features_{feat}", False))
                feat += 1
        c_last = block_setting[-1][0]
        self.classifier_0 = LayerNorm(c_last, epsilon=1e-6, **kw)
        self.classifier_2 = dense(c_last, num_classes, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``(B, H, W, 3)`` images; returns ``(B, num_classes)``
        logits in the compute dtype."""
        x = x.to(self.dtype or x.dtype)
        x = self.features_0_norm(conv_nhwc(self.features_0_conv, x))
        for name, is_block in self.layout:
            if is_block:
                x = getattr(self, name)(x)
            else:                                   # a downsampler
                x = getattr(self, f"{name}_norm")(x)
                x = conv_nhwc(getattr(self, f"{name}_conv"), x)
        x = self.classifier_0(x.mean(dim=(1, 2)))
        return self.classifier_2(x)


def _ctor(name: str):
    setting, sd = _VARIANTS[name]

    def build(num_classes: int = 1000, *, dtype=None,
              sync_batchnorm: bool = False, fused_bn: bool = True,
              device=None) -> ConvNeXt:
        return ConvNeXt(setting, sd, num_classes, dtype=dtype, device=device)
    build.__name__ = name
    return build


convnext_tiny = _ctor("convnext_tiny")
convnext_small = _ctor("convnext_small")
convnext_base = _ctor("convnext_base")
convnext_large = _ctor("convnext_large")
