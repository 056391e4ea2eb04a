"""Measurement-honest fused-BN-epilogue dispatch (``--fused-bn auto``): the
second client of ``ops/dispatch``, beside ``ops/attention_dispatch``.

Counterpart of ``tpudist/ops/norm_dispatch.py``. The kernels (B1–B4,
``ops/fused_norm``) sit behind ``models/layers.BatchNorm``, so one
question covers every conv family:

- ``record_requests()`` collects, over one forward of the model at the
  rows a train step runs (the microbatch under ``--accum-steps``), every
  (rows, channels, dtype, variant) workload the BatchNorm sites ask
  ``use_fused`` about; each site also keeps its key (``dispatch_key``);
- ``decide()`` settles each workload once per card: under ``auto`` by
  timing B1 + B3 (plain variant) or B2 + B4 (residual variant), forward
  and backward, against the plain epilogue that ``--fused-bn off`` runs,
  cached in ``fused_norm.<kind>.json`` and keyed by ``KERNEL_REV``;
- the trainer then sets each site's verdict on the module before the first
  step, so a forward does no cache lookup and no file I/O.

Structural cases (SyncBN, eval mode, the ViTs) are decided by the trainer;
eligibility here outranks even a forced ``on``, as in tpudist, so a
decision names the epilogue the step runs. tpudist's GSPMD helpers
(``shard_local_workload``, ``epilogue_shard_axes``) serve a path the port
does not have and are left out.
"""

from __future__ import annotations

import contextlib
from functools import partial
from typing import Callable, Optional

import torch

from tpudist_torch.ops import dispatch
from tpudist_torch.ops.attention_dispatch import dtype_name

CLIENT = "fused_norm"
NAMES = ("cuda", "plain")
MODES = dispatch.MODES

_mode: Optional[str] = None
_recording: Optional[set] = None


def set_mode(mode: Optional[str]) -> None:
    """Install the process-wide ``--fused-bn`` mode (None: back to the
    default, ``auto``)."""
    if mode is not None and mode not in MODES:
        raise ValueError(f"fused-bn mode must be one of {MODES}, got "
                         f"{mode!r}")
    global _mode
    _mode = mode


def get_mode() -> str:
    return _mode or "auto"


def kernel_rev() -> int:
    from tpudist_torch.ops.fused_norm import KERNEL_REV
    return KERNEL_REV


def norm_key(rows: int, channels: int, dtype, residual: bool) -> str:
    """The exact epilogue workload: the activation's flattened non-channel
    rows (those one rank's step runs), its channels, dtype and variant."""
    return (f"m{rows}_c{channels}_{dtype_name(dtype)}_"
            f"{'res' if residual else 'plain'}")


def fused_eligible(*, rows: int, channels: int) -> tuple[bool, str]:
    """tpudist's static eligibility: the workloads that resolve to the
    plain epilogue before the card is asked."""
    if rows < 1 or channels < 1:
        return False, "empty activation"
    if channels > 8192:
        return False, (f"channels {channels} exceeds the kernel's channel "
                       f"tiling")
    if rows < 8:
        return False, (f"rows {rows} is below one sublane tile — a "
                       f"streaming epilogue cannot win")
    return True, "eligible"


cache_path = partial(dispatch.cache_path, CLIENT)
clear_cache = partial(dispatch.clear_cache, CLIENT)


@contextlib.contextmanager
def record_requests():
    """While active, every ``use_fused()`` adds its workload to the yielded
    set of ``(rows, channels, key, residual, dtype)`` and answers False."""
    global _recording
    prev, _recording = _recording, set()
    try:
        yield _recording
    finally:
        _recording = prev


def recording() -> bool:
    return _recording is not None


def use_fused(rows: int, channels: int, dtype, *, residual: bool) -> bool:
    """A BatchNorm site's question, asked only in the recording forward:
    under ``record_requests()`` an eligible workload joins the recorded
    set, unless the mode is ``off``. It answers False: the step's verdict
    is set on the module before the first step, never looked up in a
    forward."""
    if _recording is None or get_mode() == "off":
        return False
    if fused_eligible(rows=rows, channels=channels)[0]:
        _recording.add((rows, channels,
                        norm_key(rows, channels, dtype, residual), residual,
                        dtype))
    return False


def build_measure_fns(rows: int, channels: int, dtype, residual: bool,
                      device=None):
    """``(cuda_fn, plain_fn, args)``: each fn takes the forward and the
    gradient (in x, scale, bias and the residual) of a scalar loss over the
    epilogue at the exact workload: the fused ``Function`` (B1 + B3, or
    B2 + B4) against the plain epilogue ``--fused-bn off`` runs. The
    inputs are drawn on the device from a seeded generator: a model with
    dozens of workloads (densenet121 has 65) would otherwise spend most of
    its probes drawing hundreds of millions of normals on the host."""
    from tpudist_torch.ops.fused_norm import fused_bn_act, reference_bn_act

    device = device or torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=device).manual_seed(0)

    def put(shape, dt, grad, low=None):
        t = (torch.randn(shape, generator=gen, device=device) if low is None
             else torch.rand(shape, generator=gen, device=device) + low)
        return t.to(dt).requires_grad_(grad)

    x = put((rows, channels), dtype, True)
    res = put((rows, channels), dtype, True) if residual else None
    scale = put(channels, torch.float32, True)
    bias = put(channels, torch.float32, True)
    mean = put(channels, torch.float32, False)
    var = put(channels, torch.float32, False, low=0.5)
    args = (x, scale, bias) + ((res,) if residual else ())

    def grads(fn):
        def call(x, scale, bias, res=None):
            y = fn(x, scale, bias, mean, var, residual=res)
            return torch.autograd.grad(y.float().sum(),
                                       (x, scale, bias, res)[:len(args)])
        return call

    plain = partial(reference_bn_act, out_dtype=dtype, act="relu")
    return grads(fused_bn_act), grads(plain), args


def measure_fused_norm(rows: int, channels: int, dtype, residual: bool,
                       device=None, steps: int = 10, warmup: int = 2
                       ) -> tuple[float, float]:
    """``(cuda_ms, plain_ms)``: forward and backward of the epilogue at the
    exact workload, on the card."""
    cuda_fn, plain_fn, args = build_measure_fns(rows, channels, dtype,
                                                residual, device)
    return (dispatch.measure_ms(cuda_fn, args, steps, warmup),
            dispatch.measure_ms(plain_fn, args, steps, warmup))


def decide(rows: int, channels: int, dtype, *, residual: bool,
           mode: str = "auto", cache_dir: Optional[str] = None,
           measure_pair: Optional[Callable[[], tuple[float, float]]] = None,
           platform: Optional[str] = None,
           device_kind: Optional[str] = None, device=None) -> dict:
    """Resolve one epilogue workload (``names=("cuda", "plain")``).
    Eligibility outranks even a forced ``on``. A probe that raises names
    the workload and the kernels it ran."""
    key = norm_key(rows, channels, dtype, residual)
    ok, why = fused_eligible(rows=rows, channels=channels)
    if mode == "on" and not ok:
        return {"kernel": "plain", "mode": mode, "source": "ineligible",
                "key": key, "reason": why, "cuda_ms": None,
                "plain_ms": None, "margin": None, "cache_hit": False}
    if measure_pair is None:
        def measure_pair():
            try:
                return measure_fused_norm(rows, channels, dtype, residual,
                                          device)
            except Exception as e:
                kernels = ("bn_act_fwd_res, bn_act_bwd_res" if residual
                           else "bn_act_fwd, bn_act_bwd")
                raise RuntimeError(
                    f"fused-norm dispatch probe failed at {key} (kernels "
                    f"{kernels}): {e!r}") from e
    return dispatch.decide(
        CLIENT, key, mode=mode, names=NAMES, kernel_rev=kernel_rev,
        measure_pair=measure_pair, eligibility=(ok, why),
        cache_dir=cache_dir, platform=platform,
        device_kind=device_kind)


def combined_key(requests) -> str:
    """One stable key over a request set."""
    return "+".join(sorted(r[2] for r in requests))


def aggregate(decisions: dict, mode: str) -> dict:
    """Per-workload decisions rolled into one verdict: ``kernel`` is
    "cuda" when every workload fused, "mixed" when some did, else "plain";
    ``source`` is "measured" when any was measured now, else "cache" when
    any came from the cache."""
    n = len(decisions)
    fused = sum(1 for d in decisions.values() if d.get("kernel") == "cuda")
    if n and fused == n:
        kernel = "cuda"
    elif fused:
        kernel = "mixed"
    else:
        kernel = "plain"
    sources = {d.get("source") for d in decisions.values()}
    source = ("measured" if "measured" in sources
              else "cache" if "cache" in sources
              else next(iter(sorted(sources)), "platform"))
    out = {"kernel": kernel, "mode": mode, "source": source,
           "n_sites": n, "n_fused": fused, "decisions": decisions}
    revs = {d.get("kernel_rev") for d in decisions.values()
            if d.get("kernel_rev") is not None}
    if len(revs) == 1:
        out["kernel_rev"] = revs.pop()
    return out


def event_fields(decision: dict) -> dict:
    """The aggregate decision as the fields of a ``fused_norm_dispatch``
    event."""
    out = {"kernel": decision["kernel"], "mode": decision["mode"],
           "source": decision["source"]}
    for f in ("n_sites", "n_fused"):
        if isinstance(decision.get(f), (int, float)):
            out[f] = decision[f]
    if decision.get("reason"):
        out["reason"] = decision["reason"]
    if decision.get("shared_from_primary"):
        out["shared_from_primary"] = 1
    decs = decision.get("decisions") or {}
    if decs:
        out["detail"] = "; ".join(
            f"{k}={d.get('kernel')}"
            + (f" ({d['cuda_ms']:.3f} vs {d['plain_ms']:.3f} ms)"
               if isinstance(d.get("cuda_ms"), (int, float))
               and isinstance(d.get("plain_ms"), (int, float)) else "")
            for k, d in sorted(decs.items()))[:2000]
    return out
