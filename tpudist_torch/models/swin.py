"""Swin Transformer v1 (tiny/small/base) and v2 (tiny/small/base)
(torchvision ``swin_transformer.py``).

Counterpart of ``tpudist/models/swin.py``. Module names are the flax
tree's: the stem ``features_0_conv``/``features_0_norm``, the blocks
``features_{1,3,5,7}_{i}`` (``norm1``, ``attn``, ``norm2``, ``mlp_0``,
``mlp_3``), the patch mergings ``features_{2,4,6}`` (``reduction``,
``norm``), ``norm`` and ``head``; the attention's ``qkv``, ``proj`` and
``relative_position_bias_table`` (v1) or ``logit_scale`` and
``cpb_mlp_0``/``cpb_mlp_2`` (v2).

- Activations stay NHWC. A block: shifted-window attention (window 7,
  v2 8; the shift alternates 0 / window // 2 and is dropped on an axis
  one window already spans), the 4x MLP with exact GELU, LayerNorm
  (eps 1e-5) before each (v1) or after each (v2, res-post-norm), row-mode
  stochastic depth on both branches (rate ``p · block / (blocks − 1)``)
  and the residuals. A feature map that is not a multiple of the window
  is padded with zeros and the pad tokens attend (v2's window 8 at 224
  px pads the 28, 14 and 7 maps), as torchvision's.
- The qkv projection is head-major (columns ``[h][q|k|v][head_dim]``),
  as tpudist's; ``compat/torch_checkpoint`` permutes torchvision's
  qkv-major packing. v2 zeroes the bias's k slice at every forward.
- v1 scores ``(q / √d)·kᵀ`` plus the relative-position bias table's
  entry for each pair (``_rel_pos_index``); v2 scores the cosine of q
  and k times ``exp(min(logit_scale, log 100))`` plus ``16·sigmoid`` of
  the continuous position bias, a 2 → 512 → heads MLP over log-spaced
  relative coordinates (``_cpb_coords``). Across a shifted window's
  seams the scores take −100 (``_shift_mask``). The softmax and the
  products run in the compute dtype: tpudist routes this biased
  attention to XLA, never to its flash kernel, and the port likewise
  launches none of its kernels (``ops/attention_dispatch`` refuses a
  bias).
- Every Linear and the patch conv: truncated normal std 0.02, zero bias;
  the bias table the same. No BatchNorm: ``sync_batchnorm`` is accepted
  and ignored, as tpudist's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpudist_torch.models.layers import (TRUNC02, Conv2d, DenseTorch,
                                         DeviceConstants, LayerNorm,
                                         conv_nhwc, dense, draw_init,
                                         reset_parameters, stochastic_depth)

LN_EPS = 1e-5


def _rel_pos_index(ws: int) -> np.ndarray:
    """(L, L) index into the (2·ws − 1)² relative-position bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]          # (2, L, L)
    return (rel[0] + ws - 1) * (2 * ws - 1) + (rel[1] + ws - 1)


def _cpb_coords(ws: int) -> np.ndarray:
    """Swin v2's continuous-position-bias inputs: ((2·ws − 1)², 2)
    relative coordinates normalised to [−1, 1], scaled by 8, then
    ``sign·log2(1 + |x|) / log2(8)``."""
    r = np.arange(-(ws - 1), ws, dtype=np.float32)
    table = np.stack(np.meshgrid(r, r, indexing="ij"), axis=-1)
    table = table / max(ws - 1, 1) * 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / 3.0
    return table.reshape(-1, 2)


def _shift_mask(h: int, w: int, ws: int, shift_h: int,
                shift_w: int) -> np.ndarray:
    """(nW, L, L) additive mask: −100 between tokens of different regions
    after the cyclic shift (a zero shift on an axis makes no seam there),
    so that one attention call serves every wrapped-around window."""
    def slices(shift):
        if shift == 0:
            return (slice(0, None),)
        return (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))

    img = np.zeros((h, w))
    cnt = 0
    for hs in slices(shift_h):
        for vs in slices(shift_w):
            img[hs, vs] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)                          # (nW, L)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask == 0, 0.0, -100.0).astype(np.float32)


class _QkvV2(DenseTorch):
    """Swin v2's qkv projection: ``nn.Dense``'s parameters, but the bias's
    k slice (each head's middle ``head_dim`` columns of the head-major
    layout) is taken as 0 at every forward, as torchvision's
    ``shifted_window_attention`` zeroes it when ``logit_scale`` is set: its
    gradient is 0."""

    def __init__(self, dim: int, num_heads: int, dtype=None, device=None):
        super().__init__(dim, 3 * dim, dtype=dtype, device=device,
                         kernel_init=TRUNC02, bias_init="zeros")
        self.num_heads = num_heads

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        keep = torch.ones(3, dtype=self.bias.dtype, device=self.bias.device)
        keep[1] = 0.0
        bias = (self.bias.view(self.num_heads, 3, -1) * keep.view(1, 3, 1)
                ).reshape(-1)
        return torch.matmul(x.to(dt), self.weight.to(dt).t()) + bias.to(dt)


class ShiftedWindowAttention(nn.Module):
    """v1: scaled dot product plus a learned relative-position bias table;
    v2: cosine attention with a learned per-head logit scale and the
    continuous position bias. Input and output ``(B, H, W, C)``."""

    def __init__(self, dim: int, num_heads: int, window: int = 7,
                 shift: int = 0, *, v2: bool = False, dtype=None,
                 device=None):
        super().__init__()
        self.num_heads, self.window, self.shift, self.v2 = \
            num_heads, window, shift, v2
        kw = dict(dtype=dtype, device=device)
        self.qkv = _QkvV2(dim, num_heads, **kw) if v2 else dense(dim, 3 * dim,
                                                                  **kw)
        self.proj = dense(dim, dim, **kw)
        f32 = dict(dtype=torch.float32, device=device)
        if v2:
            self.logit_scale = nn.Parameter(torch.full(
                (num_heads, 1, 1), math.log(10.0), **f32))
            self.cpb_mlp_0 = dense(2, 512, **kw)
            self.cpb_mlp_2 = dense(512, num_heads, use_bias=False, **kw)
        else:
            self.relative_position_bias_table = nn.Parameter(torch.zeros(
                (2 * window - 1) ** 2, num_heads, **f32))
        self.consts = DeviceConstants()

    @torch.no_grad()
    def reset_own(self, generator: torch.Generator) -> None:
        if self.v2:
            self.logit_scale.fill_(math.log(10.0))
        else:
            w = torch.empty(self.relative_position_bias_table.shape)
            draw_init(w, TRUNC02, generator)
            self.relative_position_bias_table.copy_(w)

    def _bias(self, dt, device) -> torch.Tensor:
        """(heads, L, L) relative-position bias in the compute dtype."""
        ws, l = self.window, self.window ** 2
        if self.v2:
            coords = self.consts.get("cpb", lambda: _cpb_coords(ws), device)
            table = self.cpb_mlp_2(F.relu(self.cpb_mlp_0(coords.to(dt))))
            table = 16.0 * torch.sigmoid(table)
        else:
            table = self.relative_position_bias_table
        idx = self.consts.get("idx", lambda: _rel_pos_index(ws).reshape(-1),
                              device)
        bias = table[idx].reshape(l, l, self.num_heads)
        return bias.permute(2, 0, 1).to(dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws = self.window
        pad_h, pad_w = (-h) % ws, (-w) % ws
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        hp, wp = h + pad_h, w + pad_w
        shift_h = self.shift if ws < hp else 0
        shift_w = self.shift if ws < wp else 0
        if shift_h or shift_w:
            x = torch.roll(x, (-shift_h, -shift_w), dims=(1, 2))
        nh, nw, l = hp // ws, wp // ws, ws * ws
        xw = x.reshape(b, nh, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5) \
            .reshape(b * nh * nw, l, c)

        heads, hd = self.num_heads, c // self.num_heads
        q, k, v = self.qkv(xw).view(-1, l, heads, 3, hd).unbind(3)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # (N, heads, L, d)
        if self.v2:
            qn = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True)
                      + 1e-12)
            kn = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True)
                      + 1e-12)
            scale = torch.exp(torch.clamp_max(self.logit_scale,
                                              math.log(100.0)))
            attn = (qn @ kn.transpose(-2, -1)) * scale.to(qn.dtype)
        else:
            attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
        attn = attn + self._bias(attn.dtype, x.device)[None]
        if shift_h or shift_w:
            mask = self.consts.get(
                ("mask", hp, wp, shift_h, shift_w),
                lambda: _shift_mask(hp, wp, ws, shift_h, shift_w), x.device,
                attn.dtype)
            attn = (attn.view(b, nh * nw, heads, l, l)
                    + mask[None, :, None]).view(-1, heads, l, l)
        attn = torch.softmax(attn, dim=-1)
        y = (attn @ v).transpose(1, 2).reshape(-1, l, c)
        y = self.proj(y)
        y = y.view(b, nh, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5) \
            .reshape(b, hp, wp, c)
        if shift_h or shift_w:
            y = torch.roll(y, (shift_h, shift_w), dims=(1, 2))
        return y[:, :h, :w]


class SwinBlock(nn.Module):
    """v1: ``x + sd(attn(norm1(x)))``, ``x + sd(mlp(norm2(x)))``; v2:
    ``x + sd(norm1(attn(x)))``, ``x + sd(norm2(mlp(x)))``."""

    def __init__(self, dim: int, num_heads: int, window: int = 7,
                 shift: int = 0, sd_prob: float = 0.0, *, v2: bool = False,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.v2, self.sd_prob = v2, sd_prob
        self.norm1 = LayerNorm(dim, epsilon=LN_EPS, **kw)
        self.attn = ShiftedWindowAttention(dim, num_heads, window, shift,
                                           v2=v2, **kw)
        self.norm2 = LayerNorm(dim, epsilon=LN_EPS, **kw)
        self.mlp_0 = dense(dim, 4 * dim, **kw)
        self.mlp_3 = dense(4 * dim, dim, **kw)

    def _drop(self, y: torch.Tensor) -> torch.Tensor:
        return stochastic_depth(y, self.sd_prob, self.training)

    def _mlp(self, y: torch.Tensor) -> torch.Tensor:
        return self.mlp_3(F.gelu(self.mlp_0(y)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.v2:
            x = x + self._drop(self.norm1(self.attn(x)))
            return x + self._drop(self.norm2(self._mlp(x)))
        x = x + self._drop(self.attn(self.norm1(x)))
        return x + self._drop(self._mlp(self.norm2(x)))


class PatchMerging(nn.Module):
    """Each 2x2 neighbourhood gathered into 4C channels (``x[0::2, 0::2]``,
    ``[1::2, 0::2]``, ``[0::2, 1::2]``, ``[1::2, 1::2]``), then v1:
    LayerNorm(4C) → Linear(4C → 2C, no bias); v2: the Linear first,
    LayerNorm(2C) after."""

    def __init__(self, dim: int, *, v2: bool = False, dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.v2 = v2
        self.reduction = dense(4 * dim, 2 * dim, use_bias=False, **kw)
        self.norm = LayerNorm(2 * dim if v2 else 4 * dim, epsilon=LN_EPS,
                              **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:      # (B, H, W, C)
        h, w = x.shape[1:3]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        if self.v2:
            return self.norm(self.reduction(x))
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    """torchvision-architecture Swin Transformer over NHWC images."""

    def __init__(self, embed_dim: int, depths, num_heads, window: int = 7,
                 stochastic_depth_prob: float = 0.2, v2: bool = False,
                 num_classes: int = 1000, *, dtype=None, device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.features_0_conv = Conv2d(3, embed_dim, 4, 4, padding=0,
                                      use_bias=True, init=TRUNC02, **kw)
        self.features_0_norm = LayerNorm(embed_dim, epsilon=LN_EPS, **kw)
        total = sum(depths)
        self.layout, block_id, feat, dim = [], 0, 1, embed_dim
        for s, (d, heads) in enumerate(zip(depths, num_heads)):
            for i in range(d):
                name = f"features_{feat}_{i}"
                self.add_module(name, SwinBlock(
                    dim, heads, window, 0 if i % 2 == 0 else window // 2,
                    stochastic_depth_prob * block_id / max(total - 1.0, 1.0),
                    v2=v2, **kw))
                self.layout.append(name)
                block_id += 1
            feat += 1
            if s < len(depths) - 1:
                name = f"features_{feat}"
                self.add_module(name, PatchMerging(dim, v2=v2, **kw))
                self.layout.append(name)
                dim *= 2
                feat += 1
        self.norm = LayerNorm(dim, epsilon=LN_EPS, **kw)
        self.head = dense(dim, num_classes, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``(B, H, W, 3)`` images; returns ``(B, num_classes)``
        logits in the compute dtype."""
        x = x.to(self.dtype or x.dtype)
        x = self.features_0_norm(conv_nhwc(self.features_0_conv, x))
        for name in self.layout:
            x = getattr(self, name)(x)
        return self.head(self.norm(x).mean(dim=(1, 2)))


# embed_dim, depths, heads, window, stochastic depth, v2: torchvision
# swin_{t,s,b} (window 7) and swin_v2_{t,s,b} (window 8).
_VARIANTS = {
    "swin_t": (96, (2, 2, 6, 2), (3, 6, 12, 24), 7, 0.2, False),
    "swin_s": (96, (2, 2, 18, 2), (3, 6, 12, 24), 7, 0.3, False),
    "swin_b": (128, (2, 2, 18, 2), (4, 8, 16, 32), 7, 0.5, False),
    "swin_v2_t": (96, (2, 2, 6, 2), (3, 6, 12, 24), 8, 0.2, True),
    "swin_v2_s": (96, (2, 2, 18, 2), (3, 6, 12, 24), 8, 0.3, True),
    "swin_v2_b": (128, (2, 2, 18, 2), (4, 8, 16, 32), 8, 0.5, True),
}


def _ctor(name: str):
    embed, depths, heads, window, sd, v2 = _VARIANTS[name]

    def build(num_classes: int = 1000, *, dtype=None,
              sync_batchnorm: bool = False, fused_bn: bool = True,
              device=None) -> SwinTransformer:
        return SwinTransformer(embed, depths, heads, window, sd, v2,
                               num_classes, dtype=dtype, device=device)
    build.__name__ = name
    return build


swin_t = _ctor("swin_t")
swin_s = _ctor("swin_s")
swin_b = _ctor("swin_b")
swin_v2_t = _ctor("swin_v2_t")
swin_v2_s = _ctor("swin_v2_s")
swin_v2_b = _ctor("swin_v2_b")
