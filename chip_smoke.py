#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

The quickest proof that ``tpudist_torch`` builds and serves on the GPU.
It imports the port, torch and numpy only, needs one card and no network,
and builds every kernel from the sources in this checkout. Phases, each
printing one JSON line and raising on failure:

1. card and build: the card (``nvidia-smi`` name and power limit, torch's
   device name and CUDA version), then ``nvcc`` builds every kernel;
2. kernel vs plain: each kernel against its plain-PyTorch version on the
   card at the serving shapes and at a few odd ones, with its time, the
   plain version's, one PyTorch library call's and the card's bound;
3. the slice end to end: ``python -m tpudist_torch.serve`` serves
   ViT-B/16 at 224 px in bf16 under a short open-loop load; every bucket
   call must have gone through the flash kernel, and the logits of a
   ``--flash on`` and a ``--flash off`` engine with the same weights must
   agree; then one forward at batch 1 and 8 is broken down by kernel
   (torch.profiler) beside its synchronised host wall;
4. one ``{"kernels": [...]}`` line;
5. last, ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, without a CUDA card or without the
rest of the repository.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from tpudist_torch import telemetry as telemetry_lib
from tpudist_torch.ops import _build
from tpudist_torch.ops import flash_attention as fa
from tpudist_torch.serve import __main__ as serve_cli
from tpudist_torch.serve.engine import ServeEngine
from tpudist_torch.serve.export import load_serve_state

# Published dense peaks (NVIDIA data sheets, SXM parts at 700 W): HBM
# bytes/s, bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores.
PEAKS = {"H100": {"hbm": 3.35e12, "bf16": 989e12, "f32": 67e12},
         "H200": {"hbm": 4.8e12, "bf16": 989e12, "f32": 67e12}}

# ViT-B/16 at 224 px: 196 patches + the class token, 12 heads of 64.
SERVE_T, SERVE_H, SERVE_D = 197, 12, 64
BUCKETS = (1, 2, 4, 8)
LAYERS = 12

F32_TOL = 2e-5     # rtol and atol, the bound tests/test_flash_attention.py
#                    holds the Pallas kernel to
BF16_TOL = 1e-2
# --flash on vs off logits of the served ViT-B/16 in bf16: the kernel
# rounds P before normalising and the plain path after, and the two
# roundings of 2^-8 relative differ per layer across 12 layers.
LOGITS_TOL = 5e-2


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def peaks_for(name: str) -> tuple[str, dict]:
    kind = "H200" if "H200" in name else "H100"
    return kind, PEAKS[kind]


def time_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Median over ``reps`` CUDA-event timings of ``inner`` back-to-back
    calls, per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


# -- phase 1 -----------------------------------------------------------------

def phase_card_and_build() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    paths, logs = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {k: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for k, log in logs.items()}
    peak_kind, _ = peaks_for(name)
    card = {"phase": "card_and_build", "nvidia_smi": smi_line,
            "device_name": name, "torch": torch.__version__,
            "torch_cuda": torch.version.cuda,
            "capability": list(torch.cuda.get_device_capability(0)),
            "peaks_of": peak_kind, "build_s": round(build_s, 3),
            "libraries": {k: os.path.basename(p) for k, p in paths.items()},
            "ptxas": ptxas}
    emit(card)
    return card


# -- phase 2 -----------------------------------------------------------------

def _qkv_views(b, tq, tk, h, d, dtype, seed):
    """q, k, v as the model hands them to the kernel: strided views of one
    head-major fused QKV buffer when tq == tk, separate tensors otherwise."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if tq == tk:
        qkv = torch.randn(b, tq, h, 3, d, generator=g, device="cuda",
                          dtype=torch.float32).to(dtype)
        return qkv.unbind(3)
    return tuple(torch.randn(b, t, h, d, generator=g, device="cuda",
                             dtype=torch.float32).to(dtype)
                 for t in (tq, tk, tk))


def _work(q, k, v, causal):
    """Bytes the function must move (each input read once, O and lse
    written once) and the FLOPs of its two products over the visible
    (row, key) pairs."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    elt = q.element_size()
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * elt \
        + b * h * tq * 4
    if causal:
        pairs = sum(max(0, min(tk, i + tk - tq + 1)) for i in range(tq))
    else:
        pairs = tq * tk
    return nbytes, 4.0 * b * h * pairs * d


def phase_kernel_vs_plain(peaks: dict) -> dict:
    cases = [
        # (label, B, Tq, Tk, H, D, dtype, causal): the serving shapes
        # first, then a ragged causal cross length, head dim 80 (ViT-H/14's
        # 257 tokens of 16 heads) and head dim 32 with fully masked rows.
        *[(f"serve_b{b}", b, SERVE_T, SERVE_T, SERVE_H, SERVE_D,
           torch.bfloat16, False) for b in BUCKETS],
        ("f32_causal_cross", 2, 150, 197, 4, 64, torch.float32, True),
        ("f32_d80", 2, 257, 257, 16, 80, torch.float32, False),
        ("f32_d32_masked_rows", 2, 100, 60, 3, 32, torch.float32, True),
    ]
    rows = []
    for i, (label, b, tq, tk, h, d, dtype, causal) in enumerate(cases):
        q, k, v = _qkv_views(b, tq, tk, h, d, dtype, seed=i)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal=causal)
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        torch.testing.assert_close(o.float(), o_ref.float(), rtol=tol,
                                   atol=tol)
        torch.testing.assert_close(lse, lse_ref, rtol=tol, atol=tol)
        row = {"case": label, "shape": [b, tq, tk, h, d],
               "dtype": str(dtype).replace("torch.", ""), "causal": causal,
               "tol": tol,
               "o_max_abs_err": (o.float() - o_ref.float()).abs().max().item(),
               "lse_max_abs_err": (lse - lse_ref).abs().max().item()}
        nbytes, flops = _work(q, k, v, causal)
        rate = peaks["bf16" if dtype == torch.bfloat16 else "f32"]
        t_bytes, t_ops = nbytes / peaks["hbm"] * 1e3, flops / rate * 1e3
        row.update(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        row["kernel_ms"] = time_ms(
            lambda: fa.flash_attention_fwd(q, k, v, causal=causal))
        row["plain_ms"] = time_ms(
            lambda: fa.flash_attention_reference(q, k, v, causal=causal))
        if not causal:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt))
        else:
            # SDPA's is_causal aligns the mask top-left, not at the
            # k_len - q_len offset: no one call computes this function.
            row["library_ms"] = None
        rows.append(row)
    out = {"phase": "kernel_vs_plain", "kernel": "flash_fwd", "cases": rows}
    emit(out)
    return out


# -- phase 3 -----------------------------------------------------------------

def phase_serve() -> dict:
    outdir = tempfile.mkdtemp(prefix="tpudist_torch_smoke_")
    argv = ["-a", "vit_b_16", "--image-size", "224",
            "--buckets", ",".join(map(str, BUCKETS)), "--flash", "on",
            "--load-rate", "20", "--load-duration", "5", "--load-batch", "1",
            "--seed", "0", "--telemetry", "--outpath", outdir]
    buf = io.StringIO()
    fa.LAUNCHES = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve_cli.main(argv)
    wall_s = time.perf_counter() - t0
    launches = fa.LAUNCHES
    text = buf.getvalue()
    print(text, end="", flush=True)
    if rc != 0:
        raise RuntimeError(f"tpudist_torch.serve exited {rc}")
    summary = json.loads(next(ln for ln in text.splitlines()
                              if ln.startswith("SERVE_SUMMARY "))
                         .split(" ", 1)[1])
    if summary.get("n_errors", 1) != 0 or not summary.get("n_requests"):
        raise RuntimeError(f"serving errors: {summary}")

    with open(telemetry_lib.events_path(outdir, 0)) as f:
        events = [json.loads(ln) for ln in f]
    for ev in events:
        telemetry_lib.validate_event(ev)
    warm = [e for e in events if e["type"] == "compile"]
    calls = [e for e in events if e["type"] == "serve_batch"]
    if sorted(e["bucket"] for e in warm) != list(BUCKETS) \
            or any(e["phase"] != "serve_aot" for e in warm):
        raise RuntimeError(f"warm-up events {warm}")
    bucket_calls = len(warm) + len(calls)
    if launches != LAYERS * bucket_calls:
        raise RuntimeError(f"flash kernel launched {launches} times for "
                           f"{bucket_calls} bucket calls of {LAYERS} "
                           f"layers: some attention skipped the kernel")

    # --flash on vs --flash off with the same weights, on one batch of 8.
    rng = np.random.default_rng(0)
    images = rng.standard_normal((8, 224, 224, 3)).astype(np.float32)
    logits, models = {}, {}
    for mode in ("on", "off"):
        models[mode] = load_serve_state("vit_b_16", flash=mode, seed=0)
        engine = ServeEngine(models[mode], image_size=224, buckets=(8,))
        logits[mode] = engine.infer(images)
    on, off = logits["on"], logits["off"]
    if on.shape != (8, 1000) or not np.isfinite(on).all():
        raise RuntimeError(f"served logits {on.shape}, finite "
                           f"{np.isfinite(on).all()}")
    diff = float(np.abs(on - off).max())
    scale = max(1.0, float(np.abs(off).max()))
    if diff > LOGITS_TOL * scale:
        raise RuntimeError(f"--flash on vs off logits differ by {diff} "
                           f"(bound {LOGITS_TOL} x {scale})")
    by_bucket = {b: sum(e["bucket"] == b for e in calls) for b in BUCKETS}
    out = {"phase": "serve", "arch": "vit_b_16", "image_size": 224,
           "dtype": "bfloat16", "wall_s": round(wall_s, 3),
           "summary": summary, "bucket_calls": bucket_calls,
           "warmup_calls": len(warm), "serve_calls_by_bucket": by_bucket,
           "flash_launches": launches,
           "launches_per_bucket_call": launches / bucket_calls,
           "logits_on_vs_off_max_abs": diff, "logits_max_abs": scale,
           "logits_tol": LOGITS_TOL * scale}
    emit(out)
    return out, models["on"]


# -- phase 3b: where a served forward's time goes ----------------------------

def _category(kernel: str) -> str:
    n = kernel.lower()
    if "flash_fwd" in n:
        return "flash_fwd"
    if any(s in n for s in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "matmul"
    if "conv" in n or "cudnn" in n:
        return "conv"
    if "layer_norm" in n:
        return "layer_norm"
    if "gelu" in n:
        return "gelu"
    return "other"


def phase_forward_breakdown(model) -> dict:
    """One ViT-B/16 forward at buckets 1 and 8: host wall (synchronised),
    the device's busy time by kernel category from torch.profiler, and
    the idle share. Where the profiler sees no device time the breakdown
    is "not measured" and the wall stands alone."""
    rows = []
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    for b in (1, 8):
        x = torch.randn(b, 224, 224, 3, device="cuda")

        def fwd():
            with torch.inference_mode():
                model(x)

        for _ in range(5):
            fwd()
        torch.cuda.synchronize()
        walls = []
        for _ in range(20):
            t0 = time.perf_counter()
            fwd()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(walls)
        n = 5
        with torch.profiler.profile(activities=act) as prof:
            for _ in range(n):
                fwd()
            torch.cuda.synchronize()
        by_cat: dict[str, float] = {}
        kernels = []
        for e in prof.key_averages():
            if getattr(e, "device_type", None) != \
                    torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            if us <= 0:
                continue
            ms = us / 1e3 / n
            cat = _category(e.key)
            by_cat[cat] = by_cat.get(cat, 0.0) + ms
            kernels.append({"kernel": e.key[:80], "category": cat,
                            "ms": ms, "calls": e.count / n})
        busy = sum(by_cat.values())
        kernels.sort(key=lambda k: -k["ms"])
        rows.append({
            "batch": b, "wall_ms_p50": wall,
            "device_busy_ms": busy if busy else "not measured",
            "idle_share": 1.0 - busy / wall if busy else "not measured",
            "by_category_ms": by_cat or "not measured",
            "flash_share_of_busy": (by_cat.get("flash_fwd", 0.0) / busy
                                    if busy else "not measured"),
            "kernel_launches": sum(k["calls"] for k in kernels),
            "top_kernels": kernels[:8]})
    out = {"phase": "forward_breakdown", "arch": "vit_b_16",
           "dtype": "bfloat16", "rows": rows}
    emit(out)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_card_and_build()
    _, peaks = peaks_for(card["device_name"])
    kern = phase_kernel_vs_plain(peaks)
    serve, model = phase_serve()
    phase_forward_breakdown(model)

    serve_rows = [r for r in kern["cases"] if r["case"].startswith("serve_")]
    main_row = serve_rows[-1]              # bucket 8, the largest call
    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "tpudist_torch/ops/csrc/flash_fwd.cu",
        "replaces": "tpudist/ops/pallas/flash_attention.py:95 "
                    "(_flash_kernel, via _flash_forward)",
        "launches": serve["flash_launches"],
        "max_abs_err": max(r["o_max_abs_err"] for r in kern["cases"]),
        "ms": main_row["kernel_ms"], "kernel_ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"], "dtype": main_row["dtype"],
        "by_batch": [{k: r[k] for k in ("shape", "kernel_ms", "plain_ms",
                                         "library_ms", "bound_ms")}
                     for r in serve_rows],
        "card": card["nvidia_smi"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
