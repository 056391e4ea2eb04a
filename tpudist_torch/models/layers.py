"""Building-block layers with tpudist's semantics.

Counterpart of ``tpudist/models/layers.py`` (``BatchNorm``,
``conv_kaiming``, ``BasicConv2d``, ``DenseTorch``, ``adaptive_avg_pool``,
``max_pool_ceil``, ``stochastic_depth``), plus flax's ``nn.Dropout``
(``Dropout``) and ``nn.LayerNorm`` (``LayerNorm``). Dropout masks and
stochastic depth's per-sample keeps come from one seeded generator
(``dropout_seed``), as tpudist draws both from its ``"dropout"``
stream. The conv nets run on NCHW tensors laid out
``torch.channels_last``: the NHWC memory tpudist works in, so a
``permute(0, 2, 3, 1)`` gives the NHWC view without a copy and the
``(N·H·W, C)`` rows the fused epilogue kernels read.

Precision follows flax's ``dtype=`` promotion: parameters stay f32 (the
master weights) and each forward casts its input and weights to the
compute dtype explicitly. ``BatchNorm`` never uses ``nn.BatchNorm2d`` or
cuDNN's BatchNorm: its statistics are tpudist's (below).
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

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


# jax's truncated-normal initializers (lecun_normal, variance_scaling)
# draw a unit normal cut at ±2 and divide by this factor, the std of that
# truncated unit normal.
TRUNC_STD = 0.87962566103423978


def draw_init(w: torch.Tensor, init, generator: torch.Generator) -> None:
    """Fill ``w`` in place: ``("normal", std)``, ``("trunc_normal", std)``
    (cut at ±2 std), ``("uniform", bound)`` (U(±bound)) or ``"zeros"``."""
    if init == "zeros":
        w.zero_()
    elif init[0] == "normal":
        w.normal_(0.0, init[1], generator=generator)
    elif init[0] == "trunc_normal":
        nn.init.trunc_normal_(w, 0.0, init[1], -2 * init[1], 2 * init[1],
                              generator=generator)
    elif init[0] == "uniform":
        w.uniform_(-init[1], init[1], generator=generator)
    else:
        raise ValueError(f"unknown init {init!r}")


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


class Conv2d(nn.Module):
    """``conv_kaiming``: a conv with torchvision's BN-follows init (flax
    ``variance_scaling(2.0, "fan_out", "normal")``: an untruncated normal
    of std ``sqrt(2 / (kh·kw·out))``), or with ``init`` set
    ``("normal", std)``, ``("trunc_normal", std)`` (a normal of std
    ``std`` cut at ±2 std: the inception family's
    ``truncated_normal(stddev)``) or ``"lecun"`` (flax ``nn.Conv``'s
    default ``lecun_normal``: a normal cut at ±2 std, of std
    ``sqrt(1 / (kh·kw·in/groups)) / 0.8796``); ``groups`` covers
    ResNeXt's grouped and MobileNet's depthwise convs. ``kernel_size`` and
    ``padding`` are an int or ``(h, w)`` (inception's 1x7 / 7x1 factorisations); ``padding``
    defaults to ``k // 2`` on each side. ``use_bias`` adds a bias (flax's
    init: zeros) after the conv's rounding, as ``nn.Conv(dtype=dt)`` does.
    The weight is ``(out, in/groups, kh, kw)`` f32; the forward casts it
    and the input to the compute dtype (flax's promotion when ``dtype`` is
    None)."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 strides: int = 1, *, groups: int = 1, padding=None,
                 use_bias: bool = False, init=None, dtype=None,
                 device=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride = strides
        self.padding = (kh // 2, kw // 2) if padding is None \
            else _pair(padding)
        self.groups = groups
        self.init = init
        self.dtype = dtype
        # The forward's channels_last cast hands a 1x1 kernel's gradient
        # back with channels_last strides: the same memory order as a
        # contiguous kernel, but DDP's gradient buckets compare strides, so
        # a 1x1 master weight is laid out so too.
        layout = (torch.channels_last if (kh, kw) == (1, 1)
                  else torch.contiguous_format)
        self.weight = nn.Parameter(torch.empty(
            features, in_features // groups, kh, kw,
            dtype=torch.float32, device=device, memory_format=layout))
        self.bias = (nn.Parameter(torch.zeros(features, dtype=torch.float32,
                                              device=device))
                     if use_bias else None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        out, fan_in, kh, kw = self.weight.shape
        # Drawn on the CPU, so the weights do not depend on the device.
        w = torch.empty(self.weight.shape, dtype=torch.float32)
        init = self.init
        if init == "lecun":
            init = ("trunc_normal",
                    math.sqrt(1.0 / (kh * kw * fan_in)) / TRUNC_STD)
        if init is None:
            w.normal_(0.0, math.sqrt(2.0 / (kh * kw * out)),
                      generator=generator)
        else:
            draw_init(w, init, generator)
        self.weight.copy_(w)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        w = self.weight.to(dtype=dt, memory_format=torch.channels_last)
        y = F.conv2d(x.to(dt), w, None, self.stride, self.padding, 1,
                     self.groups)
        return y if self.bias is None else \
            y + self.bias.to(dt).view(1, -1, 1, 1)


def add_conv_bn(parent: nn.Module, name: str, in_features: int,
                features: int, kernel: int, strides: int = 1, *, bn: dict,
                groups: int = 1, use_bias: bool = False, dtype=None,
                device=None) -> None:
    """Register a kaiming conv ``name`` and its ``BatchNorm`` ``name_bn``
    on ``parent``: tpudist's flat flax names (``conv_kaiming(...,
    name)`` then ``norm(name=name + "_bn")``). ``bn`` holds the
    BatchNorm's keywords."""
    parent.add_module(name, Conv2d(in_features, features, kernel, strides,
                                   groups=groups, use_bias=use_bias,
                                   dtype=dtype, device=device))
    parent.add_module(f"{name}_bn", BatchNorm(features, dtype=dtype,
                                              device=device, **bn))


def conv_bn(parent: nn.Module, name: str, x: torch.Tensor,
            relu: bool) -> torch.Tensor:
    """``add_conv_bn``'s pair on ``x``: the conv, its plain BatchNorm,
    then a ReLU applied outside it when ``relu`` (no fused epilogue, as
    tpudist's ``nn.relu(norm(...)(x))``)."""
    x = getattr(parent, f"{name}_bn")(getattr(parent, name)(x))
    return F.relu(x) if relu else x


class BasicConv2d(nn.Module):
    """torchvision's inception-family block (``BasicConv2d``): a bias-free
    conv with the truncated-normal init of std ``stddev`` (0.1 for
    inception_v3, 0.01 for googlenet), then ``BatchNorm`` with eps 1e-3 and
    its ReLU fused (``act="relu"``). ``padding`` defaults to none, as
    tpudist's ``(0, 0)``."""

    def __init__(self, in_features: int, features: int, kernel=1,
                 strides: int = 1, *, padding=0, stddev: float = 0.1,
                 bn=None, dtype=None, device=None):
        super().__init__()
        self.conv = Conv2d(in_features, features, kernel, strides,
                           padding=padding, init=("trunc_normal", stddev),
                           dtype=dtype, device=device)
        self.bn = BatchNorm(features, epsilon=1e-3, dtype=dtype,
                            device=device, **(bn or {}))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x), act="relu")


# The seed of the train step's dropout masks (``dropout_seed``), and a
# generator for it on each device the masks are drawn on.
_DROPOUT: dict = {"seed": None, "gens": {}}


@contextlib.contextmanager
def dropout_seed(seed: int):
    """Within the block, every train-mode ``Dropout`` draws its mask from
    one generator seeded with ``seed`` (one per device, made at the first
    draw there), in the order the forward reaches the layers: the train
    step seeds each microbatch from (seed, optimizer step, rank,
    microbatch), so a resumed run draws what a straight run drew. Outside
    the block a mask comes from torch's default generator."""
    prev = dict(_DROPOUT)
    _DROPOUT.update(seed=int(seed), gens={})
    try:
        yield
    finally:
        _DROPOUT.clear()
        _DROPOUT.update(prev)


def _dropout_generator(device: torch.device):
    if _DROPOUT["seed"] is None:
        return None
    gen = _DROPOUT["gens"].get(device)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(_DROPOUT["seed"])
        _DROPOUT["gens"][device] = gen
    return gen


def _keep_mask(shape, keep_prob: float, device) -> torch.Tensor:
    """A boolean mask of ``shape`` on ``device``, each entry True with
    probability ``keep_prob``: ``rand < keep_prob`` from
    ``dropout_seed``'s generator. Every ``Dropout`` and
    ``stochastic_depth`` draws through here, in the order the forward
    reaches them."""
    return torch.rand(tuple(shape), generator=_dropout_generator(device),
                      device=device) < keep_prob


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``: in train mode each entry is kept with
    probability ``1 − rate`` and scaled by ``1/(1 − rate)``, in x's dtype
    (``where(keep, x / keep_prob, 0)``); in eval mode, or at rate 0, the
    identity (and no draw). The keep mask has x's shape, on x's device
    (``_keep_mask``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        keep = _keep_mask(x.shape, keep_prob, x.device)
        return torch.where(keep, x / keep_prob, x.new_zeros(()))


def stochastic_depth(x: torch.Tensor, rate: float, training: bool,
                     rows: int | None = None) -> torch.Tensor:
    """torchvision ``stochastic_depth(..., mode="row")``, tpudist's
    ``layers.stochastic_depth``: in train mode each of the ``rows`` samples
    (x's first dim by default) keeps its residual branch with probability
    ``1 − rate``, scaled by ``1/(1 − rate)``, else zeroes it, in x's
    dtype; in eval mode, or at rate 0, the identity (and no draw). One
    keep a sample, drawn like a dropout mask (``_keep_mask``); where x's
    first dim holds ``rows`` samples' windows one after another (maxvit's
    partitions), each sample's keep covers all of its windows."""
    if not training or rate == 0.0:
        return x
    survival = 1.0 - rate
    n = x.shape[0] if rows is None else rows
    keep = _keep_mask((n,), survival, x.device)
    if n != x.shape[0]:
        keep = keep.repeat_interleave(x.shape[0] // n)
    keep = keep.view((x.shape[0],) + (1,) * (x.dim() - 1))
    return torch.where(keep, x / survival, x.new_zeros(()))


def adaptive_avg_pool(x: torch.Tensor, out_hw: tuple[int, int]
                      ) -> torch.Tensor:
    """torch ``AdaptiveAvgPool2d`` over an NCHW channels_last tensor, as
    tpudist's ``adaptive_avg_pool`` computes it: the identity at the
    output size, a plain average pool where the size divides, else torch's
    bins (output (i, j) averages rows ``[floor(i·H/oh), ceil((i+1)·H/oh))``
    and the same over columns)."""
    h, w = x.shape[2:]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    if h % oh == 0 and w % ow == 0:
        k = (h // oh, w // ow)
        return F.avg_pool2d(x, k, k)
    return F.adaptive_avg_pool2d(x, (oh, ow))


def avg_pool_padded(x: torch.Tensor, window: int, strides: int,
                    padding: int) -> torch.Tensor:
    """``F.avg_pool2d(x, window, strides, padding)`` with the padding
    counted in each mean (flax's ``avg_pool(count_include_pad=True)``),
    on an NCHW channels_last tensor; returns the same layout. The pool
    runs on an NCHW-contiguous copy: on the card, torch's CUDA backward of
    a padded average pool over a channels_last input returns a wrong
    gradient (torch 2.11, cu128: 0.75 of the largest entry off at 3x3/s2,
    0.56 at 3x3/s1, padding 1; ``chip_numerics.py``)."""
    y = F.avg_pool2d(x.contiguous(), window, strides, padding,
                     count_include_pad=True)
    return y.contiguous(memory_format=torch.channels_last)


def max_pool_ceil(x: torch.Tensor, window: int, strides: int,
                  padding: int = 0) -> torch.Tensor:
    """torch ``MaxPool2d(..., ceil_mode=True)``, which tpudist's
    ``max_pool_ceil`` reproduces in flax by padding the bottom and right
    with -inf: the last partial window is kept, and a trailing window that
    would start in the padding is dropped. torch's own ``ceil_mode`` is
    that rule; no padded copy is made, so the output keeps x's
    channels_last layout."""
    return F.max_pool2d(x, window, strides, padding, ceil_mode=True)


class DenseTorch(nn.Module):
    """Linear layer with torch.nn.Linear's default init, U(±1/√fan_in) for
    both weight and bias, computed as tpudist does:
    ``x.astype(dt) @ W.astype(dt) + b.astype(dt)`` (the bias added after
    the product's rounding). ``kernel_init`` and ``bias_init`` override
    the init as tpudist's ``kernel_init``/``bias_init`` do:
    ``("normal", std)``, ``("trunc_normal", std)`` (cut at ±2 std),
    ``("uniform", bound)`` or ``"zeros"``. ``use_bias=False`` is flax's
    ``nn.Dense(use_bias=False)``: no bias parameter."""

    def __init__(self, in_features: int, features: int, *, dtype=None,
                 kernel_init=None, bias_init=None, use_bias: bool = True,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.inits = (kernel_init, bias_init)
        f32 = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.empty(features, in_features, **f32))
        self.bias = (nn.Parameter(torch.empty(features, **f32)) if use_bias
                     else None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        for p, init in zip((self.weight, self.bias), self.inits):
            if p is None:
                continue
            w = torch.empty(p.shape, dtype=torch.float32)
            draw_init(w, ("uniform", bound) if init is None else init,
                      generator)
            p.copy_(w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        y = torch.matmul(x.to(dt), self.weight.to(dt).t())
        return y if self.bias is None else y + self.bias.to(dt)


TRUNC02 = ("trunc_normal", 0.02)


def dense(in_features: int, features: int, dtype=None, device=None,
          **kw) -> DenseTorch:
    """flax ``nn.Dense(kernel_init=truncated_normal(0.02))`` (zero bias):
    the Linears of convnext, swin and maxvit."""
    return DenseTorch(in_features, features, dtype=dtype, device=device,
                      kernel_init=TRUNC02, bias_init="zeros", **kw)


def conv_nhwc(conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on an NHWC tensor, through its NCHW channels_last view;
    returns NHWC."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class DeviceConstants:
    """Device copies of numpy constants (swin's and maxvit's indices and
    masks), made at first use on each device: not buffers, since they are
    no state and no checkpoint holds them."""

    def __init__(self):
        self._cache: dict = {}

    def get(self, key, make, device, dtype=None) -> torch.Tensor:
        k = (key, str(device), dtype)
        t = self._cache.get(k)
        if t is None:
            t = torch.as_tensor(make(), device=device)
            t = t if dtype is None else t.to(dtype)
            self._cache[k] = t
        return t


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon, dtype)`` over the last axis: the
    statistics and the affine in f32 (x promoted), the result cast to
    ``dtype`` (x's dtype promoted with f32 when None). Parameter names are
    the flax tree's (``scale``, ``bias``; init ones and zeros)."""

    def __init__(self, features: int, *, epsilon: float = 1e-6, dtype=None,
                 device=None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        f32 = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.ones(features, **f32))
        self.bias = nn.Parameter(torch.zeros(features, **f32))

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, torch.float32)
        return F.layer_norm(x.float(), self.scale.shape, self.scale,
                            self.bias, self.epsilon).to(dt)


def reset_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """The flax init of every conv, dense, BatchNorm and LayerNorm layer
    of ``model``, and of the parameters a block holds itself (its
    ``reset_own(generator)``: convnext's layer scale, a relative-position
    bias table), drawn from ``generator`` (a CPU generator) in module
    order."""
    for mod in model.modules():
        if isinstance(mod, (Conv2d, DenseTorch, BatchNorm, LayerNorm)):
            mod.reset_parameters(generator)
        elif hasattr(mod, "reset_own"):
            mod.reset_own(generator)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """The mean over H and W of an NCHW channels_last tensor, taken on its
    NHWC view (tpudist's ``jnp.mean(x, axis=(1, 2))``)."""
    return x.permute(0, 2, 3, 1).mean(dim=(1, 2))


class AuxOutputs(NamedTuple):
    """A train-mode forward of a model with aux heads (googlenet with
    ``aux_logits``, inception_v3): the main logits and the aux heads'
    logits in tpudist's order (its sown ``intermediates``, by name). The
    loss adds ``aux_loss_weight`` × each aux head's loss; eval mode
    returns the main logits alone."""
    logits: torch.Tensor
    aux: tuple


def split_aux(out) -> tuple[torch.Tensor, tuple]:
    """``(logits, aux logits)`` of a forward's output."""
    if isinstance(out, AuxOutputs):
        return out.logits, tuple(out.aux)
    return out, ()
