"""Building-block layers with tpudist's semantics.

Counterpart of ``tpudist/models/layers.py`` (``BatchNorm``,
``conv_kaiming``, ``DenseTorch``). The conv nets run on NCHW tensors laid
out ``torch.channels_last``: the NHWC memory tpudist works in, so a
``permute(0, 2, 3, 1)`` gives the NHWC view without a copy and the
``(N·H·W, C)`` rows the fused epilogue kernels read.

Precision follows flax's ``dtype=`` promotion: parameters stay f32 (the
master weights) and each forward casts its input and weights to the
compute dtype explicitly. ``BatchNorm`` never uses ``nn.BatchNorm2d`` or
cuDNN's BatchNorm: its statistics are tpudist's (below).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpudist_torch import dist as dist_lib
from tpudist_torch.ops import norm_dispatch
from tpudist_torch.ops.fused_norm import fused_bn_act, reference_bn_act


class BatchNorm(nn.Module):
    """torch.nn.BatchNorm2d-semantics batch normalization, tpudist's way.

    - statistics in f32: ``mean`` and ``mean_sq`` over N, H, W, and the
      biased ``var = max(mean_sq − mean², 0)`` normalises;
    - the running var takes the unbiased ``var·n/(n−1)``, with torch's
      momentum 0.1 (the weight of the new statistic);
    - SyncBN (``axis_name`` set, tpudist's ``"data"``): in train mode the
      f32 ``mean`` and ``mean_sq`` are averaged across the data-parallel
      ranks and ``n`` counts every rank's rows. The all-reduce is
      differentiable, so each rank's gradient also carries the other
      ranks' share of the statistics. Without a process group the rank is
      alone and the statistics are its own;
    - ``act="relu"`` (optionally with ``residual=``) asks for the fused
      epilogue: in train mode with ``fused`` set and no ``axis_name``,
      ``relu(x̂·scale + bias [+ residual])`` runs through the fused_norm
      kernels; eval mode (the running statistics), SyncBN and
      ``fused=False`` take the plain epilogue in the op order the call
      sites ran (f32 normalize → cast → add → relu), as tpudist's
      structural fallbacks do;
    - ``fused`` is this site's verdict: the trainer sets it on each site
      before the first step from the dispatch (``ops/norm_dispatch``),
      keyed by ``dispatch_key``, the workload a forward under
      ``norm_dispatch.record_requests()`` found here (None where the site
      asks nothing: no activation, or SyncBN). That recording forward
      takes the plain epilogue and updates no running statistic.

    Parameter and buffer names are the flax tree's (``scale``, ``bias``;
    ``batch_stats`` ``mean``, ``var``).
    """

    def __init__(self, features: int, *, momentum: float = 0.1,
                 epsilon: float = 1e-5, dtype=None, fused: bool = True,
                 axis_name: str | None = None, device=None):
        super().__init__()
        self.axis_name = axis_name
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.fused = bool(fused)
        self.dispatch_key: str | None = None
        f32 = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.ones(features, **f32))
        self.bias = nn.Parameter(torch.zeros(features, **f32))
        self.register_buffer("mean", torch.zeros(features, **f32))
        self.register_buffer("var", torch.ones(features, **f32))

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, *, act: str | None = None,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        """``x``: ``(N, C, H, W)``; returns the same shape and layout."""
        if act not in (None, "relu"):
            raise ValueError(f"BatchNorm fused act must be None or 'relu', "
                             f"got {act!r}")
        if residual is not None and act is None:
            raise ValueError("BatchNorm residual fusion requires act='relu' "
                             "(the kernels implement BN+add+ReLU)")
        xh = x.permute(0, 2, 3, 1)                       # NHWC view
        rh = None if residual is None else residual.permute(0, 2, 3, 1)
        recording = self.training and norm_dispatch.recording()
        if self.training:
            xf = xh.float()
            mean = xf.mean(dim=(0, 1, 2))
            mean_sq = xf.square().mean(dim=(0, 1, 2))
            n = math.prod(xh.shape[:-1])
            if self.axis_name is not None and dist_lib.is_initialized():
                world = dist_lib.data_rank_world()[1]
                stats = dist_lib.all_reduce_sum(torch.stack([mean, mean_sq]))
                mean, mean_sq = (stats / world).unbind(0)
                n *= world
            var = torch.clamp_min(mean_sq - mean.square(), 0.0)
            if not recording:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.copy_((1 - m) * self.mean + m * mean)
                    self.var.copy_((1 - m) * self.var
                                   + m * (var * (n / max(n - 1, 1))))
        else:
            mean, var = self.mean, self.var
        out_dt = self.dtype or x.dtype
        if recording and act == "relu" and self.axis_name is None:
            rows, channels = math.prod(xh.shape[:-1]), xh.shape[-1]
            norm_dispatch.use_fused(rows, channels, out_dt,
                                    residual=rh is not None)
            self.dispatch_key = norm_dispatch.norm_key(
                rows, channels, out_dt, rh is not None)
        if act == "relu" and self.training and self.fused \
                and self.axis_name is None and not recording:
            if x.dtype != out_dt:
                raise ValueError(f"the fused epilogue writes x's dtype "
                                 f"{x.dtype}; this BatchNorm's is {out_dt}")
            yh = fused_bn_act(xh, self.scale, self.bias, mean, var,
                              eps=self.epsilon, residual=rh)
        else:
            yh = reference_bn_act(xh, self.scale, self.bias, mean, var,
                                  eps=self.epsilon, residual=rh,
                                  out_dtype=out_dt, act=act)
        return yh.permute(0, 3, 1, 2)


class Conv2d(nn.Module):
    """``conv_kaiming``: a bias-free conv with torchvision's BN-follows
    init (flax ``variance_scaling(2.0, "fan_out", "normal")``: an
    untruncated normal of std ``sqrt(2 / (kh·kw·out))``); ``groups`` covers
    ResNeXt's grouped convs. The weight is ``(out, in/groups, kh, kw)``
    f32; the forward casts it and the input to the compute dtype
    (flax's promotion when ``dtype`` is None)."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 strides: int = 1, *, groups: int = 1, padding=None,
                 dtype=None, device=None):
        super().__init__()
        self.stride = strides
        self.padding = kernel_size // 2 if padding is None else padding
        self.groups = groups
        self.dtype = dtype
        # The forward's channels_last cast hands a 1x1 kernel's gradient
        # back with channels_last strides: the same memory order as a
        # contiguous kernel, but DDP's gradient buckets compare strides, so
        # a 1x1 master weight is laid out so too.
        layout = (torch.channels_last if kernel_size == 1
                  else torch.contiguous_format)
        self.weight = nn.Parameter(torch.empty(
            features, in_features // groups, kernel_size, kernel_size,
            dtype=torch.float32, device=device, memory_format=layout))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        out, _, kh, kw = self.weight.shape
        # Drawn on the CPU, so the weights do not depend on the device.
        w = torch.empty(self.weight.shape, dtype=torch.float32)
        w.normal_(0.0, math.sqrt(2.0 / (kh * kw * out)), generator=generator)
        self.weight.copy_(w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        w = self.weight.to(dtype=dt, memory_format=torch.channels_last)
        return F.conv2d(x.to(dt), w, None, self.stride, self.padding, 1,
                        self.groups)


class DenseTorch(nn.Module):
    """Linear layer with torch.nn.Linear's default init, U(±1/√fan_in) for
    both weight and bias, computed as tpudist does:
    ``x.astype(dt) @ W.astype(dt) + b.astype(dt)`` (the bias added after
    the product's rounding)."""

    def __init__(self, in_features: int, features: int, *, dtype=None,
                 device=None):
        super().__init__()
        self.dtype = dtype
        f32 = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.empty(features, in_features, **f32))
        self.bias = nn.Parameter(torch.empty(features, **f32))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        for p in (self.weight, self.bias):
            w = torch.empty(p.shape, dtype=torch.float32)
            w.uniform_(-bound, bound, generator=generator)
            p.copy_(w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        return torch.matmul(x.to(dt), self.weight.to(dt).t()) \
            + self.bias.to(dt)

