"""Vision Transformer family (torchvision-architecture vit_b_16/b_32/l_16/
l_32/h_14), single-device.

Counterpart of ``tpudist/models/vit.py``. Parameter names mirror the flax
tree (``encoder_layer_3.self_attention.in_proj.weight`` is the flax path
``encoder_layer_3/self_attention/in_proj/kernel``), so the weight bridge in
``compat/jax_params.py`` is a transpose per leaf and nothing else.

What the reference does and the port keeps:
- images are NHWC at the public API; the patchify conv runs on a permuted
  NCHW view;
- the fused QKV projection is head-major: its output columns are
  ``[h][q|k|v][head_dim]``, and attention reads q, k and v as strided
  views of it;
- LayerNorm runs in f32 (epsilon 1e-6, flax's default) on the residual
  stream and its result is cast back to the compute dtype;
- GELU is the tanh approximation (flax ``nn.gelu``);
- parameters stay f32 (the master weights), as in the flax tree; each
  matmul (``layers.DenseTorch``) and the conv cast their input and weights
  to the compute dtype per op, as flax's ``nn.Dense(dtype=dt)`` and
  ``nn.Conv`` do, and add the bias after the product's rounding.

``seq_axis`` (ring attention), tensor parallelism and ``remat`` come later.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpudist_torch.models.layers import TRUNC_STD, DenseTorch as Linear
from tpudist_torch.ops.flash_attention import flash_attention
from tpudist_torch.parallel.ring_attention import attention

LN_EPS = 1e-6            # flax nn.LayerNorm's default epsilon


class PatchConv(nn.Conv2d):
    """The patchify ``nn.Conv2d`` (kernel = stride = patch, no padding)
    with f32 parameters, computed as flax's ``nn.Conv(dtype=dt)``: input
    and weight cast to ``dt``, the bias added after the conv's
    rounding."""

    def __init__(self, in_channels: int, features: int, patch: int, *,
                 dtype=None, device=None):
        super().__init__(in_channels, features, patch, stride=patch,
                         dtype=torch.float32, device=device)
        self.compute_dtype = dtype or torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return y + self.bias.to(dt).view(1, -1, 1, 1)


class MultiHeadAttention(nn.Module):
    """Self-attention with a head-major fused QKV projection."""

    def __init__(self, dim: int, num_heads: int, *, flash: bool,
                 dtype=None, device=None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"hidden {dim} not divisible by {num_heads} "
                             f"heads")
        self.num_heads = num_heads
        self.flash = bool(flash)
        kw = dict(dtype=dtype, device=device)
        self.in_proj = Linear(dim, 3 * dim, **kw)
        self.out_proj = Linear(dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, dim = x.shape
        qkv = self.in_proj(x).view(b, t, self.num_heads, 3,
                                   dim // self.num_heads)
        q, k, v = qkv.unbind(3)
        out = flash_attention(q, k, v) if self.flash else attention(q, k, v)
        return self.out_proj(out.reshape(b, t, dim))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int, *,
                 flash: bool, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        ln_kw = dict(eps=LN_EPS, dtype=torch.float32, device=device)
        self.ln_1 = nn.LayerNorm(dim, **ln_kw)
        self.self_attention = MultiHeadAttention(dim, num_heads, flash=flash,
                                                 **kw)
        self.ln_2 = nn.LayerNorm(dim, **ln_kw)
        self.mlp_0 = Linear(dim, mlp_dim, **kw)
        self.mlp_3 = Linear(mlp_dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ln_1(x.float()).to(x.dtype)      # LayerNorm in f32
        x = x + self.self_attention(y)
        y = self.ln_2(x.float()).to(x.dtype)
        y = F.gelu(self.mlp_0(y), approximate="tanh")
        return x + self.mlp_3(y)


class VisionTransformer(nn.Module):
    """torchvision-architecture ViT over NHWC images.

    ``dtype`` is the compute dtype (the flax module's ``dtype``): the conv
    and the linear layers hold f32 weights and compute in it.
    ``image_size`` fixes the token count of ``pos_embedding`` (flax infers
    it at init).
    """

    def __init__(self, patch_size: int = 16, hidden_dim: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, num_classes: int = 1000, *,
                 image_size: int = 224, pool: str = "token",
                 flash: bool = True, dtype=None, device=None):
        super().__init__()
        if pool not in ("token", "gap"):
            raise ValueError(f"pool must be 'token' or 'gap', got {pool!r}")
        if image_size % patch_size:
            raise ValueError(f"image size {image_size} is not a multiple of "
                             f"the patch size {patch_size}")
        self.patch_size = patch_size
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.pool = pool
        self.dtype = dtype or torch.float32
        kw = dict(dtype=self.dtype, device=device)
        self.conv_proj = PatchConv(3, hidden_dim, patch_size, **kw)
        tokens = (image_size // patch_size) ** 2 + (pool == "token")
        self.tokens = tokens
        f32 = dict(dtype=torch.float32, device=device)
        if pool == "token":
            self.class_token = nn.Parameter(torch.zeros(1, 1, hidden_dim,
                                                        **f32))
        self.pos_embedding = nn.Parameter(torch.zeros(1, tokens, hidden_dim,
                                                      **f32))
        self.layer_names = [f"encoder_layer_{i}" for i in range(num_layers)]
        for name in self.layer_names:
            self.add_module(name, EncoderBlock(hidden_dim, num_heads,
                                               mlp_dim, flash=flash, **kw))
        self.ln = nn.LayerNorm(hidden_dim, eps=LN_EPS, **f32)
        self.head = Linear(hidden_dim, num_classes, **kw)

    def set_flash(self, flash: bool) -> None:
        """Route every block's attention through the flash kernels or plain
        attention (the dispatch's verdict, set before the first step)."""
        for m in self.modules():
            if isinstance(m, MultiHeadAttention):
                m.flash = bool(flash)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The flax init, drawn from ``generator`` (a CPU generator, so the
        weights do not depend on the device): lecun-normal kernels, zero
        biases, unit LayerNorm scales, ``pos_embedding`` N(0, 0.02), zero
        ``class_token``."""
        def draw(p: torch.Tensor, std: float, trunc: bool) -> None:
            w = torch.empty(p.shape, dtype=torch.float32)
            if trunc:
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            else:
                nn.init.normal_(w, 0.0, std, generator=generator)
            p.copy_(w)

        for mod in self.modules():
            if isinstance(mod, (Linear, nn.Conv2d)):
                fan_in = mod.weight[0].numel()
                draw(mod.weight, math.sqrt(1.0 / fan_in) / TRUNC_STD, True)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        draw(self.pos_embedding, 0.02, False)
        if self.pool == "token":
            self.class_token.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``(B, H, W, 3)`` images; returns ``(B, num_classes)``
        logits in the compute dtype."""
        b = x.shape[0]
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = self.conv_proj(x).flatten(2).transpose(1, 2)     # [B, T, D]
        if self.pool == "token":
            cls = self.class_token.to(x.dtype).expand(b, -1, -1)
            x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embedding.to(x.dtype)
        for name in self.layer_names:
            x = getattr(self, name)(x)
        x = self.ln(x.float())
        pooled = x.mean(dim=1) if self.pool == "gap" else x[:, 0]
        return self.head(pooled.to(self.dtype))


def _vit(patch, hidden, layers, heads, mlp):
    def ctor(num_classes: int = 1000, *, image_size: int = 224,
             pool: str = "token", flash: bool = True, dtype=None,
             device=None) -> VisionTransformer:
        return VisionTransformer(patch, hidden, layers, heads, mlp,
                                 num_classes, image_size=image_size,
                                 pool=pool, flash=flash, dtype=dtype,
                                 device=device)
    return ctor


vit_b_16 = _vit(16, 768, 12, 12, 3072)
vit_b_32 = _vit(32, 768, 12, 12, 3072)
vit_l_16 = _vit(16, 1024, 24, 16, 4096)
vit_l_32 = _vit(32, 1024, 24, 16, 4096)
vit_h_14 = _vit(14, 1280, 32, 16, 5120)
