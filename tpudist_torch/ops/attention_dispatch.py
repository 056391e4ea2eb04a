"""Measurement-honest attention dispatch (``--flash auto``): a client of
``ops/dispatch``.

Counterpart of ``tpudist/ops/attention_dispatch.py``. What is
attention's own:

- the workload (``shape_key``: batch, tokens, heads, head dim, dtype,
  train or eval, causal), the same string as tpudist's for the same
  workload (``torch.bfloat16`` spells ``bfloat16``);
- static eligibility (``flash_eligible``), by the limits of the port's
  kernels: head dims 32, 64 and 80, f32 or bf16, no additive bias; and
  tpudist's floor of 16 tokens;
- the measurement (``measure_attention``): the flash kernels against the
  ``--flash off`` path, plain ``attention``, at the exact shape: the
  forward (B5) for eval, forward and backward (B5, B6, B7) for training.
  The baseline is never SDPA or cuDNN: a library call is a yardstick and
  never replaces the kernel;
- the kernel revision (``flash_attention.KERNEL_REV``);
- the telemetry projection (``event_fields``).

The rest is ``dispatch`` with ``names=("flash", "plain")``; the cache
file is ``attention_dispatch.<kind>.json``.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch

from tpudist_torch.ops import dispatch

CLIENT = "attention_dispatch"
NAMES = ("flash", "plain")
MODES = dispatch.MODES

cache_path = partial(dispatch.cache_path, CLIENT)
clear_cache = partial(dispatch.clear_cache, CLIENT)


def dtype_name(dtype) -> str:
    """The canonical dtype name tpudist keys on: ``float32``,
    ``bfloat16``, ``float16``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return getattr(dtype, "name", None) or str(dtype)


def shape_key(batch: int, seq: int, heads: int, head_dim: int, dtype,
              train: bool, causal: bool) -> str:
    """The exact attention workload."""
    return (f"b{batch}_t{seq}_h{heads}_d{head_dim}_{dtype_name(dtype)}_"
            f"{'train' if train else 'eval'}_"
            f"{'causal' if causal else 'full'}")


def kernel_rev() -> int:
    from tpudist_torch.ops.flash_attention import KERNEL_REV
    return KERNEL_REV


def flash_eligible(*, seq: int, head_dim: int, bias: bool = False,
                   dtype=None) -> tuple[bool, str]:
    """Whether the flash kernels can run this workload at all."""
    from tpudist_torch.ops.flash_attention import DTYPES, HEAD_DIMS
    if bias:
        return False, ("additive attention bias is not implemented by the "
                       "flash kernel")
    if head_dim not in HEAD_DIMS:
        return False, (f"head_dim {head_dim} is not one of the kernels' "
                       f"head dims {HEAD_DIMS}")
    if dtype is not None and dtype not in DTYPES:
        return False, (f"the flash kernels take f32, bf16 and float16, not "
                       f"{dtype}")
    if seq < 16:
        return False, (f"seq {seq} is below one 16-row tile — blockwise "
                       f"streaming cannot win")
    return True, "eligible"


def measure_attention(batch: int, seq: int, heads: int, head_dim: int,
                      dtype, train: bool, causal: bool, device=None,
                      steps: int = 10, warmup: int = 2) -> tuple[float, float]:
    """``(flash_ms, plain_ms)`` on the card at the exact shape: training
    times the forward and the gradient in q, k and v, eval the forward
    alone."""
    import numpy as np

    from tpudist_torch.ops.flash_attention import flash_attention
    from tpudist_torch.parallel.ring_attention import attention

    device = device or torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    shape = (batch, seq, heads, head_dim)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(device=device, dtype=dtype).requires_grad_(train)
               for _ in range(3))

    def timed(fn):
        if train:
            def call(q, k, v):
                out = fn(q, k, v, causal=causal).float().sum()
                return torch.autograd.grad(out, (q, k, v))
        else:
            def call(q, k, v):
                with torch.no_grad():
                    return fn(q, k, v, causal=causal)
        return dispatch.measure_ms(call, (q, k, v), steps, warmup)

    return timed(flash_attention), timed(attention)


def decide(batch: int, seq: int, heads: int, head_dim: int, dtype,
           *, train: bool = True, causal: bool = False, mode: str = "auto",
           cache_dir: Optional[str] = None,
           measure_pair: Optional[Callable[[], tuple[float, float]]] = None,
           platform: Optional[str] = None,
           device_kind: Optional[str] = None, device=None) -> dict:
    """Resolve the attention of one workload: ``kernel`` "flash" or
    "plain", with ``mode``, ``source``, the timings and margin when
    measured. ``measure_pair`` defaults to ``measure_attention`` at the
    shape, on ``device``; a probe that raises names the workload."""
    if mode not in MODES:
        raise ValueError(f"flash mode must be one of {MODES}, got {mode!r}")
    key = shape_key(batch, seq, heads, head_dim, dtype, train, causal)
    if measure_pair is None:
        def measure_pair():
            try:
                return measure_attention(batch, seq, heads, head_dim, dtype,
                                         train, causal, device)
            except Exception as e:
                kernels = "flash_fwd" + (", flash_bwd_dq, flash_bwd_dkv"
                                         if train else "")
                raise RuntimeError(
                    f"attention dispatch probe failed at {key} (kernels "
                    f"{kernels}): {e!r}") from e
    return dispatch.decide(
        CLIENT, key, mode=mode, names=NAMES, kernel_rev=kernel_rev,
        measure_pair=measure_pair,
        eligibility=flash_eligible(seq=seq, head_dim=head_dim, dtype=dtype),
        cache_dir=cache_dir, platform=platform,
        device_kind=device_kind)


def lookup(batch: int, seq: int, heads: int, head_dim: int, dtype,
           *, train: bool = True, causal: bool = False,
           cache_dir: Optional[str] = None,
           platform: Optional[str] = None,
           device_kind: Optional[str] = None) -> bool:
    """``dispatch.lookup`` behind the eligibility check: the cache and the
    platform only, never a measurement."""
    if not flash_eligible(seq=seq, head_dim=head_dim, dtype=dtype)[0]:
        return False
    key = shape_key(batch, seq, heads, head_dim, dtype, train, causal)
    return dispatch.lookup(CLIENT, key, candidate="flash",
                           kernel_rev=kernel_rev, cache_dir=cache_dir,
                           platform=platform, device_kind=device_kind)


def event_fields(decision: dict) -> dict:
    """The decision as the fields of an ``attention_dispatch`` event."""
    out = {"kernel": decision["kernel"], "mode": decision["mode"],
           "source": decision["source"], "shape_key": decision.get("key")}
    for f in ("flash_ms", "plain_ms", "margin"):
        if isinstance(decision.get(f), (int, float)):
            out[f] = decision[f]
    if decision.get("cache_hit"):
        out["cache_hit"] = 1
    if decision.get("reason"):
        out["reason"] = decision["reason"]
    if decision.get("shared_from_primary"):
        out["shared_from_primary"] = 1
    if decision.get("device_kind"):
        out["dispatch_device_kind"] = decision["device_kind"]
    return out
