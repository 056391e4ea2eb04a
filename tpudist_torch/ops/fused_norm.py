"""Fused BatchNorm epilogues: BN+ReLU and BN+add+ReLU, both directions.

Counterpart of ``tpudist/ops/pallas/fused_norm.py``. The four kernels are
``csrc/fused_norm.cu`` (built by ``_build``, bound through ctypes); its
source note says what bounds them on the card and how they are laid out.

- ``fused_bn_act`` folds the statistics into per-channel ``a`` and ``b``
  in plain PyTorch (``a = scale·rsqrt(var+eps)``, ``b = bias − mean·a``)
  and applies one of two ``torch.autograd.Function``s: ``_FusedPlain``
  ``(x2, a, b)`` and ``_FusedRes`` ``(x2, r2, a, b)``. Their backward
  returns ``dx``, ``da`` and ``db`` (and ``dr``) straight from the backward
  kernel; autograd carries ``da``/``db`` through the fold to scale, bias,
  mean and var, which is how the full BatchNorm gradient comes out without
  the kernels knowing about BatchNorm.
- Each wrapper (``bn_act_fwd``, ``bn_act_bwd``) launches its kernel on a
  CUDA tensor, or raises: there is no fallback. On a CPU tensor it takes
  the plain-PyTorch version of the same kernel body (``bn_act_fwd_plain``,
  ``bn_act_bwd_plain``, with the same ``(ceil(M/rows), C)`` partials), so
  the CPU tests exercise the ``Function``s' own backward.
- ``LAUNCHES`` counts kernel launches per kernel, and nothing else;
  ``RELAYOUTS`` counts the backward's copies of an incoming gradient that
  was not laid out as rows of channels.

Shapes: ``x`` is ``(..., C)`` channels-last (an NHWC activation; a
channels_last NCHW tensor permuted to NHWC is such a view). On the card the
flattened ``(M, C)`` view must be contiguous: the wrapper raises rather
than copy. The output has x's dtype (the storage dtype of x and r).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# Bumped whenever a kernel's math or schedule changes.
KERNEL_REV = 1

KERNELS = ("bn_act_fwd", "bn_act_fwd_res", "bn_act_bwd", "bn_act_bwd_res")

# Kernel launches made on CUDA tensors, per kernel.
LAUNCHES = dict.fromkeys(KERNELS, 0)
# Incoming gradients the backward had to copy into (M, C) rows.
RELAYOUTS = 0

# Rows per backward block: one row of the partials per block of rows.
BWD_BLOCK_ROWS = 256

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_fns: dict = {}


def reset_counts() -> None:
    global RELAYOUTS
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    RELAYOUTS = 0


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from tpudist_torch.ops import _build
        fn = getattr(_build.load("fused_norm"), f"tpudist_{name}")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.restype = i
        fn.argtypes = {
            "bn_act_fwd": [i, p, p, p, p, ll, i, p],
            "bn_act_fwd_res": [i, p, p, p, p, p, ll, i, p],
            "bn_act_bwd": [i, p, p, p, p, p, p, p, ll, i, i, p],
            "bn_act_bwd_res": [i, p, p, p, p, p, p, p, p, p, ll, i, i, p],
        }[name]
        _fns[name] = fn
    return fn


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


# -- the plain versions of the four kernel bodies ----------------------------

def _pre_act(x2, r2, a, b):
    """x·a + b in f32 (two roundings, as the kernel), and for the residual
    epilogue the value rounded to the storage dtype, added to r there and
    rounded again."""
    pre = x2.float() * a + b
    if r2 is not None:
        pre = (pre.to(r2.dtype) + r2).float()
    return pre


def bn_act_fwd_plain(x2, r2, a, b):
    """``relu(x·a + b)`` (B1) or ``relu(T(T(x·a + b) + r))`` (B2), in x's
    dtype ``T``."""
    return torch.relu(_pre_act(x2, r2, a, b)).to(x2.dtype)


def bn_act_bwd_plain(x2, r2, dy2, a, b, block_rows: int = BWD_BLOCK_ROWS):
    """B3/B4: ``(dx, dr, da_partials, db_partials)``; ``dr`` is None
    without a residual. Partials are ``(ceil(M/block_rows), C)`` f32: row
    ``i`` sums ``g·x`` and ``g`` over rows ``[i·block_rows, (i+1)·block_rows)``."""
    xf = x2.float()
    g = torch.where(_pre_act(x2, r2, a, b) > 0, dy2.float(), 0.0)
    dx = (g * a).to(x2.dtype)
    dr = None if r2 is None else g.to(r2.dtype)
    m, c = x2.shape
    nm = -(-m // block_rows)
    pad = (0, 0, 0, nm * block_rows - m)
    da_p = F.pad(g * xf, pad).view(nm, block_rows, c).sum(1)
    db_p = F.pad(g, pad).view(nm, block_rows, c).sum(1)
    return dx, dr, da_p, db_p


# -- the wrappers ------------------------------------------------------------

def _check(x2, r2, a, b, others=()):
    if x2.dim() != 2:
        raise ValueError(f"fused_norm takes (M, C) rows, got {tuple(x2.shape)}")
    m, c = x2.shape
    if m < 1 or c < 1:
        raise ValueError(f"empty fused_norm input {tuple(x2.shape)}")
    if a.shape != (c,) or b.shape != (c,):
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must be "
                         f"({c},)")
    rows = [t for t in (r2, *others) if t is not None]
    for t in rows:
        if t.shape != x2.shape:
            raise ValueError(f"fused_norm operand {tuple(t.shape)} != x "
                             f"{tuple(x2.shape)}")
    devs = {t.device for t in (x2, a, b, *rows)}
    if len(devs) != 1:
        raise ValueError(f"fused_norm operands on several devices: {devs}")


def _require_rows(t: torch.Tensor) -> None:
    if not t.is_contiguous():
        raise ValueError(
            "fused_norm kernel needs contiguous (M, C) rows: pass a "
            "channels_last activation (NHWC view); got strides "
            f"{t.stride()} for shape {tuple(t.shape)}")


def _kernel_ready(x2, r2, a, b, others=()) -> None:
    """Raise unless the CUDA kernel takes these operands as they are."""
    if x2.device.type != "cuda":
        raise ValueError(f"fused_norm runs on cuda or cpu tensors, got "
                         f"{x2.device}")
    if x2.dtype not in DTYPES:
        raise ValueError(f"fused_norm kernel supports float32 and bfloat16, "
                         f"got {x2.dtype}")
    for t in [t for t in (r2, *others) if t is not None]:
        if t.dtype != x2.dtype:
            raise ValueError(f"fused_norm kernel needs one storage dtype, got "
                             f"{x2.dtype} and {t.dtype}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError("fused_norm kernel takes f32 a and b")
    for t in [t for t in (x2, r2, a, b, *others) if t is not None]:
        _require_rows(t)


def bn_act_fwd(x2, r2, a, b):
    """B1 (``r2`` None) or B2: the epilogue forward on ``(M, C)`` rows."""
    _check(x2, r2, a, b)
    if x2.device.type == "cpu":
        return bn_act_fwd_plain(x2, r2, a, b)
    _kernel_ready(x2, r2, a, b)
    m, c = x2.shape
    y = torch.empty_like(x2)
    dt = DTYPES[x2.dtype]
    if r2 is None:
        _launch("bn_act_fwd", x2.device, dt, x2.data_ptr(), a.data_ptr(),
                b.data_ptr(), y.data_ptr(), m, c)
    else:
        _launch("bn_act_fwd_res", x2.device, dt, x2.data_ptr(),
                r2.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), m, c)
    return y


def bn_act_bwd(x2, r2, dy2, a, b):
    """B3 (``r2`` None) or B4: ``(dx, dr, da_partials, db_partials)``."""
    _check(x2, r2, a, b, others=(dy2,))
    if x2.device.type == "cpu":
        return bn_act_bwd_plain(x2, r2, dy2, a, b)
    _kernel_ready(x2, r2, a, b, others=(dy2,))
    m, c = x2.shape
    nm = -(-m // BWD_BLOCK_ROWS)
    dx = torch.empty_like(x2)
    da_p = torch.empty((nm, c), dtype=torch.float32, device=x2.device)
    db_p = torch.empty_like(da_p)
    dt = DTYPES[x2.dtype]
    if r2 is None:
        _launch("bn_act_bwd", x2.device, dt, x2.data_ptr(), dy2.data_ptr(),
                a.data_ptr(), b.data_ptr(), dx.data_ptr(), da_p.data_ptr(),
                db_p.data_ptr(), m, c, BWD_BLOCK_ROWS)
        return dx, None, da_p, db_p
    dr = torch.empty_like(r2)
    _launch("bn_act_bwd_res", x2.device, dt, x2.data_ptr(), r2.data_ptr(),
            dy2.data_ptr(), a.data_ptr(), b.data_ptr(), dx.data_ptr(),
            dr.data_ptr(), da_p.data_ptr(), db_p.data_ptr(), m, c,
            BWD_BLOCK_ROWS)
    return dx, dr, da_p, db_p


# -- autograd ----------------------------------------------------------------

def _rows(t: torch.Tensor) -> torch.Tensor:
    """``(..., C)`` → ``(M, C)``: on the card a view of contiguous rows, or
    it raises; on the CPU a copy where no view exists."""
    if t.device.type == "cuda":
        _require_rows(t)
    return t.reshape(-1, t.shape[-1])


def _dense_grad(dy: torch.Tensor) -> torch.Tensor:
    """The incoming gradient as contiguous rows. A gradient that arrives
    in another layout (from a pool or a broadcast, say) is copied once,
    and counted."""
    global RELAYOUTS
    if dy.is_contiguous():
        return dy
    RELAYOUTS += 1
    return dy.contiguous()


class _FusedPlain(torch.autograd.Function):
    """``relu(x·a + b)``: the counterpart of ``_fused_plain``."""

    @staticmethod
    def forward(ctx, x, a, b):
        ctx.save_for_backward(x, a, b)
        return bn_act_fwd(_rows(x), None, a, b).view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x, a, b = ctx.saved_tensors
        dx, _, da_p, db_p = bn_act_bwd(_rows(x), None, _rows(_dense_grad(dy)),
                                       a, b)
        return dx.view(x.shape), da_p.sum(0), db_p.sum(0)


class _FusedRes(torch.autograd.Function):
    """``relu(T(x·a + b) + r)``: the counterpart of ``_fused_res``."""

    @staticmethod
    def forward(ctx, x, r, a, b):
        ctx.save_for_backward(x, r, a, b)
        return bn_act_fwd(_rows(x), _rows(r), a, b).view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x, r, a, b = ctx.saved_tensors
        dx, dr, da_p, db_p = bn_act_bwd(_rows(x), _rows(r),
                                        _rows(_dense_grad(dy)), a, b)
        return dx.view(x.shape), dr.view(r.shape), da_p.sum(0), db_p.sum(0)


def fold(scale, bias, mean, var, eps: float):
    """Per-channel ``(a, b)`` in f32: ``x·a + b`` is the normalised and
    affine-transformed ``x``."""
    a = scale.float() * torch.rsqrt(var.float() + eps)
    return a, bias.float() - mean.float() * a


def fused_bn_act(x: torch.Tensor, scale, bias, mean, var, *,
                 eps: float = 1e-5,
                 residual: torch.Tensor | None = None) -> torch.Tensor:
    """Fused BN epilogue ``relu(normalize(x)·scale + bias [+ residual])``.

    ``x``/``residual``: ``(..., C)`` channels-last; ``scale``/``bias``/
    ``mean``/``var``: per-channel vectors, the statistics computed by the
    caller. Returns x's dtype. Differentiable in every argument through the
    backward kernel and the fold."""
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"fused residual shape {tuple(residual.shape)} != "
                         f"x {tuple(x.shape)}")
    a, b = fold(scale, bias, mean, var, eps)
    if residual is None:
        return _FusedPlain.apply(x, a, b)
    return _FusedRes.apply(x, residual, a, b)


def reference_bn_act(x: torch.Tensor, scale, bias, mean, var, *,
                     eps: float = 1e-5, residual: torch.Tensor | None = None,
                     out_dtype=None, act: str | None = "relu") -> torch.Tensor:
    """The plain epilogue in the op order the model's call sites run: f32
    normalize → affine → cast → (add) → (relu). ``act=None`` leaves the
    relu out (a BatchNorm with no activation)."""
    y = (x.float() - mean) * torch.rsqrt(var.float() + eps)
    y = (y * scale + bias).to(out_dtype or x.dtype)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if act == "relu" else y
