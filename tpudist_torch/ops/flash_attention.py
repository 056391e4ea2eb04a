"""Flash attention, both directions: the wrappers of the hand-written CUDA
kernels and the ``autograd.Function`` around them.

Counterpart of ``tpudist/ops/pallas/flash_attention.py`` (``flash_attention``,
``_flash_vjp``, ``_flash_forward``/``_flash_kernel``, ``_flash_backward``/
``_bwd_dq_kernel``/``_bwd_dkv_kernel``). The kernels are ``csrc/flash_fwd.cu``
(the forward) and ``csrc/flash_bwd.cu`` (the dQ and dKV passes), built by
``_build`` and bound through ctypes; their source notes say what bounds them
on the card and how they are laid out.

- A CUDA tensor launches the kernel (or raises: there is no fallback).
- A CPU tensor takes the plain-PyTorch version of the same function:
  ``flash_attention_reference`` ``(o, lse)`` for the forward,
  ``flash_attention_bwd_reference`` ``(dq, dk, dv)`` for both backward
  passes, at the kernels' rounding points. The CPU tests hold them against
  the JAX package; ``chip_smoke.py`` holds the kernels against them on the
  card.
- ``flash_attention`` goes through ``_FlashAttention`` when a gradient is
  wanted: its forward saves ``(q, k, v, o, lse)``, its backward computes
  ``delta = rowsum(dO·O)`` and the clamped lse in torch and runs the two
  backward kernels. Under ``no_grad``/inference the forward runs alone.
- ``LAUNCHES`` counts kernel launches per kernel, and nothing else;
  ``RELAYOUTS`` counts incoming gradients the backward had to copy because
  their head dim was not contiguous.

Shapes are ``(B, T, H, D)`` as in the JAX API; ``lse`` and ``delta`` are
``(B, H, Tq)`` f32 (the JAX kernel's ``(B, H, Tq_pad, 1)`` without padding).
The inputs may be strided views (the model passes slices of its fused QKV
output); only the head dim has to be contiguous, and in bf16 and float16,
where every kernel copies its tiles 16 bytes at a time, the address and
the (batch, seq, head) strides must be 16-byte multiples (``aligned_16``;
the fused QKV views are). The gradients come out contiguous, in the
inputs' dtype.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30

# Bumped whenever a kernel's math or schedule changes.
KERNEL_REV = 4

KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

# Kernel launches made on CUDA tensors, per kernel.
LAUNCHES = dict.fromkeys(KERNELS, 0)
# Incoming gradients the backward copied to get a contiguous head dim.
RELAYOUTS = 0

HEAD_DIMS = (32, 64, 80)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# The dtypes whose kernels copy their tiles 16 bytes at a time.
TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)

_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float16: "float16"}

# The library (a source under csrc/) of each kernel.
_LIBRARY = {"flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd",
            "flash_bwd_dkv": "flash_bwd"}

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
        fn = getattr(_build.load(_LIBRARY[name]), f"tpudist_{name}")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.restype = i
        fn.argtypes = {
            "flash_fwd": [i, i, p, p, p, p, p, i, i, i, i, p, i, f, p],
            "flash_bwd_dq": [i, i, p, p, p, p, p, p, p, i, i, i, i, p, i, f,
                             p],
            "flash_bwd_dkv": [i, i, p, p, p, p, p, p, p, p, i, i, i, i, p, i,
                              f, p],
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


def _strides(*ts: torch.Tensor):
    """The (batch, seq, head) element strides of each tensor, as the
    ``long long`` array the kernels take."""
    vals = [s for t in ts for s in t.stride()[:3]]
    return ctypes.cast((ctypes.c_longlong * len(vals))(*vals), ctypes.c_void_p)


def _scaled_q(q: torch.Tensor) -> torch.Tensor:
    """Softmax temperature folded into Q once: f32 multiply, cast back to
    the input dtype (the JAX kernel's ``_scaled_q``)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    return (q.float() * scale).to(q.dtype)


def _visible(tq: int, tk: int, device) -> torch.Tensor:
    """(Tq, Tk) causal mask at the k_len − q_len offset: row i sees column
    c iff i + (Tk − Tq) >= c."""
    return torch.ones(tq, tk, dtype=torch.bool, device=device).tril(tk - tq)


def flash_attention_reference(q, k, v, causal: bool = False):
    """Plain-PyTorch version of the forward kernel's function: ``(o, lse)``.

    The same arithmetic as the kernel, without tiles: scaled Q in the input
    dtype, f32 scores, keys masked as the kernel masks them, f32 softmax
    statistics, P rounded to V's dtype before the f32 P·V, and a fully
    masked row emitting O = 0 and lse = -1e30."""
    _check(q, k, v)
    tq, tk = q.shape[1], k.shape[1]
    qs = _scaled_q(q).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    if causal:
        valid = _visible(tq, tk, q.device)
        s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(valid, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o / l.squeeze(-1).transpose(1, 2).unsqueeze(-1)
    lse = (m + torch.log(l)).squeeze(-1)
    return o.to(q.dtype), lse


def backward_rows(o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor):
    """What both backward passes read per query row, computed in torch as
    ``_flash_backward`` leaves it to XLA: ``delta = rowsum(dO·O)`` in f32
    and the forward's lse with fully masked rows (lse = -1e30) clamped to
    0, both ``(B, H, Tq)`` f32 and contiguous."""
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    lse = torch.where(lse <= NEG_INF / 2, 0.0, lse).contiguous()
    return delta, lse


def flash_attention_bwd_reference(q, k, v, do, lse, delta,
                                  causal: bool = False):
    """Plain-PyTorch version of both backward kernels: ``(dq, dk, dv)``.

    ``lse`` is the clamped one and ``delta`` the row sums of
    ``backward_rows``. The rounding points are the kernels': S from the
    rounded scaled Q in f32, P = exp(S − lse) with masked pairs 0, dP =
    dO·Vᵀ and dS = P·(dP − δ) in f32; dq = T(scale·Σ T(dS)·K), dv =
    T(Σ T(P)ᵀ·dO), dk = T(Σ T(dS)ᵀ·Qs), the sums in f32."""
    tq, tk, d = q.shape[1], k.shape[1], q.shape[-1]
    qs = _scaled_q(q)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if causal:
        s = torch.where(_visible(tq, tk, q.device), s, NEG_INF)
    p = torch.exp(s - lse.unsqueeze(-1))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta.unsqueeze(-1))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    dq = (dq * (1.0 / d ** 0.5)).to(q.dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), qs.float())
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention takes (B, T, H, D) tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, tq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} disagree on B, H or D")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k and v must share a dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if min(b, tq, k.shape[1], h) < 1:
        raise ValueError(f"empty attention input {tuple(q.shape)}")


def _check_bwd(q, k, v, do, lse, delta) -> None:
    _check(q, k, v)
    b, tq, h, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype} on its device")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, tq) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous ({b}, {h}, {tq}) "
                             f"f32 on q's device, got {tuple(t.shape)} "
                             f"{t.dtype}")


def aligned_16(address: int, strides, element_size: int) -> bool:
    """Whether 16-byte ``cp.async`` copies can read a (B, T, H, D) operand
    row by row: its address and its (batch, seq, head) strides in bytes
    are multiples of 16. The bf16 and float16 kernels, forward and
    backward, copy their tiles so."""
    return address % 16 == 0 and all(
        s * element_size % 16 == 0 for s in tuple(strides)[:3])


def _kernel_ready(*ts: torch.Tensor) -> None:
    """Raise unless the CUDA kernels take these (B, T, H, D) operands as
    they are. bf16 and float16 operands must be 16-byte aligned
    (``aligned_16``): the tensor-core kernels of both directions copy their
    tiles 16 bytes at a time."""
    q = ts[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention kernel supports "
                         f"{sorted(str(t) for t in DTYPES)}, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel supports head dims "
                         f"{HEAD_DIMS}, got {q.shape[-1]}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("flash_attention needs a contiguous head dim "
                         "(stride(-1) == 1) on q, k, v and dO")
    if q.dtype in TENSOR_CORE_DTYPES and not all(
            aligned_16(t.data_ptr(), t.stride(), t.element_size())
            for t in ts):
        raise ValueError(f"the {_DTYPE_NAMES[q.dtype]} flash kernels need "
                         "16-byte alignment: "
                         "the address and the (batch, seq, head) strides "
                         "in bytes of q, k, v (and dO) must be multiples "
                         "of 16")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False):
    """Fused attention forward: ``(o, lse)`` with o ``(B, Tq, H, D)`` in
    q's dtype and lse ``(B, H, Tq)`` f32. On the card the dtype picks the
    kernel: bf16 and float16 the tensor-core ``flash_fwd_mma``, f32 the
    scalar ``flash_fwd_kernel``; one launch either way."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal)
    _kernel_ready(q, k, v)
    b, tq, h, d = q.shape
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q.device, DTYPES[q.dtype], d, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h,
            tq, k.shape[1], _strides(q, k, v), int(causal), 1.0 / (d ** 0.5))
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = False):
    """B6, the dQ pass: ``dq`` ``(B, Tq, H, D)`` in q's dtype, from the
    clamped ``lse`` and the row sums ``delta`` of ``backward_rows``."""
    _check_bwd(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, do, lse, delta,
                                             causal)[0]
    _kernel_ready(q, k, v, do)
    b, tq, h, d = q.shape
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    _launch("flash_bwd_dq", q.device, DTYPES[q.dtype], d, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), b, h, tq, k.shape[1],
            _strides(q, k, v, do), int(causal), 1.0 / (d ** 0.5))
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False):
    """B7, the dKV pass: ``(dk, dv)`` ``(B, Tk, H, D)`` in k's dtype."""
    _check_bwd(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, do, lse, delta,
                                             causal)[1:]
    _kernel_ready(q, k, v, do)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    dk = torch.empty((b, tk, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    _launch("flash_bwd_dkv", q.device, DTYPES[q.dtype], d, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, tq, tk,
            _strides(q, k, v, do), int(causal), 1.0 / (d ** 0.5))
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = False):
    """The two-pass backward from the forward's ``o`` and ``lse``:
    ``(dq, dk, dv)``. On the card each pass is one kernel launch."""
    delta, lse = backward_rows(o, lse, do)
    if q.device.type == "cpu":
        _check_bwd(q, k, v, do, lse, delta)
        return flash_attention_bwd_reference(q, k, v, do, lse, delta, causal)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal)
    return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, causal))


def _dense_grad(do: torch.Tensor) -> torch.Tensor:
    """The incoming gradient with a contiguous head dim: one that arrives
    otherwise is copied once, and counted."""
    global RELAYOUTS
    if do.stride(-1) == 1:
        return do
    RELAYOUTS += 1
    return do.contiguous()


class _FlashAttention(torch.autograd.Function):
    """``o = softmax(Qs·Kᵀ)·V``: the counterpart of ``_flash_vjp``."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, _dense_grad(do),
                                         causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Fused attention. Shapes [B, T, H, D]; returns [B, T, H, D].
    Differentiable through the two backward kernels."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal)
    return flash_attention_fwd(q, k, v, causal=causal)[0]
