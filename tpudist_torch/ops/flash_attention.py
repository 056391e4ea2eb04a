"""Flash-attention forward: the wrapper of the hand-written CUDA kernel.

Counterpart of ``tpudist/ops/pallas/flash_attention.py``'s forward
(``flash_attention``, ``_flash_forward``, ``_flash_kernel``). The kernel is
``csrc/flash_fwd.cu``, built by ``_build`` and bound through ctypes; its
source note says what bounds it on the card and how it is laid out.

- A CUDA tensor launches the kernel (or raises: there is no fallback).
- A CPU tensor takes ``flash_attention_reference``, the plain-PyTorch
  version of the same function with the same ``(o, lse)`` contract. The
  CPU tests hold it against the JAX package; ``chip_smoke.py`` holds the
  kernel against it on the card.
- ``LAUNCHES`` counts kernel launches, and nothing else.

Shapes are ``(B, T, H, D)`` as in the JAX API; ``lse`` is ``(B, H, Tq)``
f32 (the JAX kernel's ``(B, H, Tq_pad, 1)`` without padding). The inputs
may be strided views (the model passes slices of its fused QKV output);
only the head dim has to be contiguous.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30

# Bumped whenever the kernel's math or schedule changes.
KERNEL_REV = 1

# Kernel launches made by flash_attention_fwd on CUDA tensors.
LAUNCHES = 0

HEAD_DIMS = (32, 64, 80)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from tpudist_torch.ops import _build
        fn = _build.load("flash_fwd").tpudist_flash_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p]
        _fn = fn
    return _fn


def _scaled_q(q: torch.Tensor) -> torch.Tensor:
    """Softmax temperature folded into Q once: f32 multiply, cast back to
    the input dtype (the JAX kernel's ``_scaled_q``)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    return (q.float() * scale).to(q.dtype)


def flash_attention_reference(q, k, v, causal: bool = False):
    """Plain-PyTorch version of the kernel's function: ``(o, lse)``.

    The same arithmetic as the kernel, without tiles: scaled Q in the input
    dtype, f32 scores, keys masked as the kernel masks them, f32 softmax
    statistics, P rounded to V's dtype before the f32 P·V, and a fully
    masked row emitting O = 0 and lse = -1e30."""
    _check(q, k, v)
    tq, tk = q.shape[1], k.shape[1]
    qs = _scaled_q(q).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    if causal:
        valid = torch.ones(tq, tk, dtype=torch.bool,
                           device=q.device).tril(tk - tq)
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


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False):
    """Fused attention forward: ``(o, lse)`` with o ``(B, Tq, H, D)`` in
    q's dtype and lse ``(B, H, Tq)`` f32."""
    global LAUNCHES
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention kernel supports "
                         f"{sorted(str(t) for t in DTYPES)}, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel supports head dims "
                         f"{HEAD_DIMS}, got {d}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs a contiguous head dim "
                         "(stride(-1) == 1) on q, k and v")
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 9)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2))
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, tq, tk,
                 ctypes.cast(strides, ctypes.c_void_p), int(causal),
                 1.0 / (d ** 0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Fused attention. Shapes [B, T, H, D]; returns [B, T, H, D]."""
    return flash_attention_fwd(q, k, v, causal=causal)[0]
