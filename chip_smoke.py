#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

The quickest proof that ``tpudist_torch`` builds, serves and trains on the
GPU. It imports the port, torch and numpy only, needs one card and no
network, and builds every kernel from the sources in this checkout (one
``nvcc`` per source, all started together). Phases, each printing one JSON
line and raising on failure:

1. card and build: the card (``nvidia-smi`` name and power limit, torch's
   device name and CUDA version), then ``nvcc`` builds every kernel and
   its ``-Xptxas -v`` report (registers, spills) is printed; a bf16
   tensor-core kernel that spills fails the phase;
2. kernel vs plain: each kernel against its plain-PyTorch version on the
   card, with its time, the plain version's, one PyTorch library call's
   (where one computes the same function) and the card's bound:
   a. the flash-attention forward at the serving shapes, ViT-B/16's
      training shape (batch 128) and odd shapes in f32 and bf16 (head
      dims 32 and 80, a causal cross length, fully masked rows): o and
      lse within the bound (the bf16 lse within the f32 one), the share
      of O entries not bit-equal to the plain version, two launches
      bit-identical, rows that see no key O = 0 and lse = -1e30;
   b. the flash-attention backward, its dQ and dKV passes, at ViT-B/16's
      training shape in bf16 and at odd shapes in f32 and bf16 (head dims
      32 and 80, causal cross lengths with fully masked rows): within the
      bound, the share of entries not bit-equal to the plain version, two
      launches bit-identical; beside SDPA's backward and the names of the
      device kernels it launched;
   c. the four fused BatchNorm epilogues (forward, forward+residual,
      backward, backward+residual) at the five resnet18 shapes of batch
      256 at 224 px in bf16 and three odd shapes in f32;
3. serving end to end: ``python -m tpudist_torch.serve`` serves ViT-B/16
   at 224 px in bf16 under a short open-loop load; every bucket call must
   have gone through the flash kernel, and the logits of a ``--flash on``
   and a ``--flash off`` engine with the same weights must agree; then one
   forward at batch 1 and 8 is broken down by kernel (torch.profiler)
   beside its synchronised host wall;
4. training end to end: ``python -m tpudist_torch`` trains resnet18 at
   224 px, batch 256, bf16, ``--fused-bn on`` for two short epochs; every
   train step must launch the fused-norm kernels exactly 17 times in each
   direction and validation none, every telemetry event must validate and
   the losses must be finite; the first three steps' losses under
   ``--fused-bn on`` and ``off`` (same seed, same batches) must agree;
   then one train step on a device-resident batch is broken down by
   kernel category beside its synchronised wall;
5. ViT training end to end: ``python -m tpudist_torch`` trains ViT-B/16
   at 224 px, batch 128, bf16, ``--flash on``, AdamW for two short
   epochs; every train step must launch each flash kernel exactly 12
   times and every validation batch the forward alone 12 times; the first
   three SGD steps under ``--flash on`` and ``off`` (same seed, same
   batches, bf16 and f32) must agree; then one train step is broken down
   by kernel category;
6. one ``{"kernels": [...]}`` line;
7. last, ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, without a CUDA card or without the
rest of the repository. ``python3 chip_smoke.py --mutations`` runs only
the ``--flash on``/``off`` comparison under in-memory faults of the
backward (dq 10 % off; one key tile's dk and dv dropped), then builds two
faulty copies of the forward kernel (one key tile's contribution to O
dropped; l summed from the rounded P) and holds each against the bf16
forward cases, the served logits on/off and the bf16 training on/off; it
exits 0 only if every fault breaks a bound.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from tpudist_torch import __main__ as train_cli
from tpudist_torch import config as config_lib
from tpudist_torch import telemetry as telemetry_lib
from tpudist_torch import train as train_lib
from tpudist_torch.models import create_model
from tpudist_torch.ops import _build
from tpudist_torch.ops import flash_attention as fa
from tpudist_torch.ops import fused_norm as fn
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
# The bf16 forward's lse against the plain version's. Every product feeding
# S is exact in f32 (bf16 operands) and l sums the unrounded P in f32, so
# only the order of f32 sums differs; held to the f32 bound. Read at 9.5e-7
# on an H100 80GB HBM3 at 700 W. A kernel that sums l from the bf16-rounded
# P reads 5.6e-4 to 1.2e-3 there, and breaks neither the served logits nor
# the training bounds (python3 chip_smoke.py --mutations).
BF16_LSE_TOL = F32_TOL
# --flash on vs off logits of the served ViT-B/16 in bf16: the kernel
# rounds P before normalising and the plain path after, and the two
# roundings of 2^-8 relative differ per layer across 12 layers.
LOGITS_TOL = 5e-2

# resnet18 at batch 256 and 224 px: the (rows, channels) of its BN
# epilogues, stem then stages 1-4. Each stage has two blocks, each with a
# BN+ReLU (bn1) and a BN+add+ReLU (bn2) at the stage's shape.
TRAIN_B, TRAIN_PX = 256, 224
RESNET18_SHAPES = [("stem", 256 * 112 * 112, 64), ("layer1", 256 * 56 * 56, 64),
                   ("layer2", 256 * 28 * 28, 128),
                   ("layer3", 256 * 14 * 14, 256),
                   ("layer4", 256 * 7 * 7, 512)]
ODD_SHAPES = [("f32_24x130", 24, 130), ("f32_40x8", 40, 8),
              ("f32_2x5x5x64", 2 * 5 * 5, 64)]
SITES_PER_STEP = 17
# The backward's (nm, C) partials and their per-channel sums are f32 sums
# of g·x and g taken in another order than the plain version's: each entry
# is held within F32_SUM_TOL·(1 + Σ|term|) over the rows it sums (256 f32
# additions in sequence err by at most 256·2^-24 ≈ 1.5e-5 of Σ|term|, and
# by about 16·2^-24 ≈ 1e-6 when the roundings fall at random).
F32_SUM_TOL = 1e-5
# Elementwise operations per element, each counted once: fwd mul, add,
# max; fwd_res also the rounding add; bwd mul, add, compare, dx mul, the
# two accumulations; bwd_res also the rounding add.
NORM_OPS = {"bn_act_fwd": 3, "bn_act_fwd_res": 4, "bn_act_bwd": 7,
            "bn_act_bwd_res": 8}
# --fused-bn on vs off over 3 train steps from one seed on the same
# batches. The two epilogues fold the statistics in different f32 orders,
# so in bf16 about 1e-4 of the activations round one ulp (2^-8) apart, 17
# layers deep, and the SGD updates at lr 0.1 carry that into the weights.
# The losses are held relative to max(1, |loss|): read at 1.9e-4 (bf16)
# and 4e-5 (f32) on an H100 80GB HBM3 at 700 W. Every parameter and
# running statistic after the first step (one gradient, no trajectory yet)
# is held against that leaf's largest change in the step: read at 0.34
# (bf16) and 0.035 (f32) there. A backward with dx 10 % off exceeds both
# bounds; in f32 so do one with da 10 % off or with a partial row dropped.
# After three steps at lr 0.1 the runs drift apart by a fifth (f32) to
# three quarters (bf16) of a leaf's change, too far to tell a wrong
# backward.
TRAIN_CMP_STEPS = 3
TRAIN_LOSS_TOL = {"bfloat16": 2e-3, "float32": 2e-3}
TRAIN_STATE_TOL = {"bfloat16": 1.0, "float32": 0.1}

# ViT-B/16 training at 224 px: batch 128, 197 tokens, 12 heads of 64.
VIT_B = 128
VIT_SYNTHETIC = 1024            # train images an epoch; validation half
# The backward kernels against their plain version: rtol and atol·max|ref|
# (the bound tests/test_flash_attention.py holds the Pallas backward to).
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# --flash on vs off over 3 SGD steps (lr VIT_CMP_LR) from one seed on the
# same batches of VIT_CMP_B images: the plain attention rounds P after
# normalising and the kernel before, so bf16 activations round apart, 12
# layers deep; in f32 the two forwards differ in the last bits. Losses
# relative to max(1, |loss|): read at 4.2e-4 (bf16) and 6.7e-8 (f32, one
# ulp) on an H100 80GB HBM3 at 700 W. Every parameter after step one
# against that leaf's change in the step: read at 0.021 (bf16) and 0.0095
# (f32) there. The bounds sit about 3x above. A backward with dq 10 % off
# reads 0.11 in both dtypes, one with a key tile's dk and dv dropped 0.79
# (python3 chip_smoke.py --mutations). Those readings were taken with the
# scalar bf16 backward; with the tensor-core bf16 backward (f32 sums in
# another order) the same card reads 4.1e-4 and 0.0215 (bf16), 6.7e-8 and
# 0.0095 (f32), and the two faults 0.116 / 0.112 and 0.790 / 0.791.
VIT_CMP_B = 32
VIT_CMP_LR = 1e-3
VIT_LOSS_TOL = {"bfloat16": 1.5e-3, "float32": 2e-7}
VIT_STATE_TOL = {"bfloat16": 0.06, "float32": 0.03}


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

def _kernel_name(mangled: str) -> str:
    """``flash_fwd_mma<64>``, ``flash_bwd_dq_kernel<f32,64>`` or
    ``bn_act_fwd_kernel<bf16,true>`` from a mangled kernel name; one of
    another form comes back as it is."""
    m = re.search(r"\d+((?:flash|bn)_\w+?_(?:mma|kernel))I(\w+?)EEv",
                  mangled)
    if not m:
        return mangled
    words = {"f": "f32", "13__nv_bfloat16": "bf16", "Lb0E": "false",
             "Lb1E": "true"}
    toks = re.finditer(r"f(?=L|$)|13__nv_bfloat16|Lb[01]E|Li(\d+)E",
                       m.group(2))
    names = [words.get(t.group(0)) or t.group(1) for t in toks]
    return f"{m.group(1)}<{','.join(names)}>"


def _ptxas_entries(log: str) -> dict:
    """Registers and spill bytes of each kernel in an ``-Xptxas -v``
    report, by readable name (``flash_fwd_mma<64>``; an entry of another
    form keeps its mangled name)."""
    out, entry = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = _kernel_name(m.group(1))
            out[entry] = {}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out[entry].update(spill_stores=int(m.group(1)),
                              spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[entry]["registers"] = int(m.group(1))
    return out


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
    ptxas = {k: _ptxas_entries(log) for k, log in logs.items()}
    spills = [f"{lib}: {entry} {r}" for lib, entries in ptxas.items()
              for entry, r in entries.items() if "_mma<" in entry
              and (r.get("spill_stores") or r.get("spill_loads"))]
    if spills:
        raise RuntimeError(f"a bf16 tensor-core kernel spills: {spills}")
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


FWD_CASES = [
    # (label, B, Tq, Tk, H, D, dtype, causal): the serving shapes first,
    # then ViT-B/16's training shape, then odd ones in f32 (the scalar
    # kernel) and in bf16 (the tensor-core kernel): head dim 80 (ViT-H/14's
    # 257 tokens of 16 heads), a ragged causal cross length, and head dim 32
    # causal with fully masked rows. At D = 32 and 80 the scale is no power
    # of two, so an unrounded Qs would show there only.
    *[(f"serve_b{b}", b, SERVE_T, SERVE_T, SERVE_H, SERVE_D, torch.bfloat16,
       False) for b in BUCKETS],
    (f"train_b{VIT_B}", VIT_B, SERVE_T, SERVE_T, SERVE_H, SERVE_D,
     torch.bfloat16, False),
    ("f32_causal_cross", 2, 150, 197, 4, 64, torch.float32, True),
    ("f32_d80", 2, 257, 257, 16, 80, torch.float32, False),
    ("f32_d32_masked_rows", 2, 100, 60, 3, 32, torch.float32, True),
    ("bf16_d80", 2, 257, 257, 16, 80, torch.bfloat16, False),
    ("bf16_causal_cross", 2, 150, 197, 4, 64, torch.bfloat16, True),
    ("bf16_d32_masked_rows", 2, 100, 60, 3, 32, torch.bfloat16, True),
]


def _close(got, want, tol):
    """Whether |got − want| <= tol + tol·|want| everywhere (the form of
    torch.testing.assert_close with rtol = atol = tol)."""
    return bool(((got - want).abs() <= tol + tol * want.abs()).all())


def _fwd_check(q, k, v, causal) -> tuple[dict, list[str]]:
    """The forward kernel against its plain version on one input: the
    errors and bit-equality shares of O and lse, and what breaks its
    bounds (none: []): o within 2e-5 (f32) or 1e-2 (bf16), lse within
    2e-5 (F32_TOL, BF16_LSE_TOL), two launches bit-identical, and rows
    that see no key O = 0 and lse = -1e30 exactly."""
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal=causal)
    bf16 = q.dtype == torch.bfloat16
    tol = BF16_TOL if bf16 else F32_TOL
    of, rf = o.float(), o_ref.float()
    bad = []
    if not _close(of, rf, tol):
        bad.append(f"o off by {(of - rf).abs().max().item()} (tol {tol})")
    lse_tol = BF16_LSE_TOL if bf16 else F32_TOL
    if not _close(lse, lse_ref, lse_tol):
        bad.append(f"lse off by {(lse - lse_ref).abs().max().item()} "
                   f"(tol {lse_tol})")
    relaunch = torch.equal(o, o2) and torch.equal(lse, lse2)
    if not relaunch:
        bad.append("two launches on the same inputs differ")
    blind = max(0, q.shape[1] - k.shape[1]) if causal else 0
    if blind and not (torch.all(o[:, :blind] == 0)
                      and torch.all(lse[:, :, :blind] == fa.NEG_INF)):
        bad.append("rows that see no key got O != 0 or lse != -1e30")
    row = {"o_max_abs_err": (of - rf).abs().max().item(),
           "lse_max_abs_err": (lse - lse_ref).abs().max().item(),
           "o_not_bit_equal_share": (o != o_ref).float().mean().item(),
           "lse_not_bit_equal_share": (lse != lse_ref).float().mean()
           .item(),
           "lse_tol": lse_tol, "relaunch_bit_identical": relaunch,
           "rows_seeing_no_key": blind}
    return row, bad


def phase_kernel_vs_plain(peaks: dict) -> dict:
    rows = []
    for i, (label, b, tq, tk, h, d, dtype, causal) in enumerate(FWD_CASES):
        q, k, v = _qkv_views(b, tq, tk, h, d, dtype, seed=i)
        checked, bad = _fwd_check(q, k, v, causal)
        if bad:
            raise RuntimeError(f"flash_fwd {label}: {'; '.join(bad)}")
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        row = {"case": label, "shape": [b, tq, tk, h, d],
               "dtype": str(dtype).replace("torch.", ""), "causal": causal,
               "tol": tol, **checked}
        nbytes, flops = _work(q, k, v, causal)
        rate = peaks["bf16" if dtype == torch.bfloat16 else "f32"]
        t_bytes, t_ops = nbytes / peaks["hbm"] * 1e3, flops / rate * 1e3
        row.update(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        row["kernel_ms"] = time_ms(
            lambda: fa.flash_attention_fwd(q, k, v, causal=causal))
        large = b >= VIT_B
        row["plain_ms"] = time_ms(
            lambda: fa.flash_attention_reference(q, k, v, causal=causal),
            reps=5 if large else 25, inner=2 if large else 10)
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
    fa.reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve_cli.main(argv)
    wall_s = time.perf_counter() - t0
    launches = fa.LAUNCHES["flash_fwd"]
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

    logits, bad, model = serve_logits_on_off()
    if bad:
        raise RuntimeError(bad)
    by_bucket = {b: sum(e["bucket"] == b for e in calls) for b in BUCKETS}
    out = {"phase": "serve", "arch": "vit_b_16", "image_size": 224,
           "dtype": "bfloat16", "wall_s": round(wall_s, 3),
           "summary": summary, "bucket_calls": bucket_calls,
           "warmup_calls": len(warm), "serve_calls_by_bucket": by_bucket,
           "flash_launches": launches,
           "launches_per_bucket_call": launches / bucket_calls,
           **logits}
    emit(out)
    return out, model


def serve_logits_on_off():
    """The served logits of a ``--flash on`` and a ``--flash off`` engine
    with the same weights, on one batch of 8: the reading, what breaks its
    bound (None if nothing), and the ``on`` model."""
    rng = np.random.default_rng(0)
    images = rng.standard_normal((8, 224, 224, 3)).astype(np.float32)
    logits, models = {}, {}
    for mode in ("on", "off"):
        models[mode] = load_serve_state("vit_b_16", flash=mode, seed=0)
        engine = ServeEngine(models[mode], image_size=224, buckets=(8,))
        logits[mode] = engine.infer(images)
    on, off = logits["on"], logits["off"]
    diff = float(np.abs(on - off).max())
    scale = max(1.0, float(np.abs(off).max()))
    bad = None
    if on.shape != (8, 1000) or not np.isfinite(on).all():
        bad = f"served logits {on.shape}, finite {np.isfinite(on).all()}"
    elif not diff <= LOGITS_TOL * scale:
        bad = (f"--flash on vs off logits differ by {diff} (bound "
               f"{LOGITS_TOL} x {scale})")
    return ({"logits_on_vs_off_max_abs": diff, "logits_max_abs": scale,
             "logits_tol": LOGITS_TOL * scale}, bad, models["on"])


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


def _device_kernels(prof, n: int, category) -> tuple[dict, list]:
    """Device ms a call by category, and each kernel's ms and calls,
    from a torch.profiler window over ``n`` calls, largest first. User
    annotations (``record_function`` ranges such as ``Optimizer.step``,
    drawn on the device timeline over the kernels they enclose) are left
    out: their time is those kernels' time counted again."""
    by_cat: dict[str, float] = {}
    kernels = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False) \
                or e.key.startswith("Optimizer."):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us <= 0:
            continue
        ms = us / 1e3 / n
        cat = category(e.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        kernels.append({"kernel": e.key[:90], "category": cat, "ms": ms,
                        "calls": e.count / n})
    kernels.sort(key=lambda k: -k["ms"])
    return by_cat, kernels


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
        by_cat, kernels = _device_kernels(prof, n, _category)
        busy = sum(by_cat.values())
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


# -- phase 2b: the fused BatchNorm epilogues ----------------------------------

def _abs_partials(x, r, dy, a, b):
    """Σ|g·x| and Σ|g| over the rows of each partial: the plain backward
    on |dy|·sign(x) and on |dy| (the mask depends on x, r, a, b only)."""
    _, _, gx, _ = fn.bn_act_bwd_plain(x, r, dy.abs() * x.sign(), a, b)
    _, _, _, g = fn.bn_act_bwd_plain(x, r, dy.abs(), a, b)
    return gx, g


def _norm_case(label, m, c, dtype, peaks, seed):
    """All four epilogue kernels at one (M, C): each against its plain
    version (y, dx and dr bit for bit: both round x·a and + b separately
    and g·a once; the partials and their sums within F32_SUM_TOL·(1 +
    Σ|term|)), timed beside the plain version, with the card's bound for
    the function's bytes and operations. The looser ``20·tol·(1 +
    max|ref|)`` of ``tests/test_fused_norm.py`` is printed beside."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape, dt=dtype):
        return torch.randn(*shape, generator=g, device="cuda",
                           dtype=torch.float32).to(dt)

    x, r, dy = rand(m, c), rand(m, c), rand(m, c)
    a, b = rand(c, dt=torch.float32), rand(c, dt=torch.float32)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    elt = x.element_size()
    large = m * c > 10_000_000
    rows = {}
    for res in (False, True):
        rr = r if res else None
        y = fn.bn_act_fwd(x, rr, a, b)
        dx, dr, da_p, db_p = fn.bn_act_bwd(x, rr, dy, a, b)
        torch.cuda.synchronize()
        y_ref = fn.bn_act_fwd_plain(x, rr, a, b)
        dx_ref, dr_ref, da_ref, db_ref = fn.bn_act_bwd_plain(x, rr, dy, a, b)
        y_err = (y.float() - y_ref.float()).abs().max().item()
        if not torch.equal(y, y_ref):
            raise RuntimeError(f"{label} fwd res={res}: |y - plain| {y_err}")
        gx_abs, g_abs = _abs_partials(x, rr, dy, a, b)
        exact = {"dx": (dx, dx_ref)}
        if res:
            exact["dr"] = (dr, dr_ref)
        sums = {"da_partials": (da_p, da_ref, gx_abs),
                "db_partials": (db_p, db_ref, g_abs),
                "da": (da_p.sum(0), da_ref.sum(0), gx_abs.sum(0)),
                "db": (db_p.sum(0), db_ref.sum(0), g_abs.sum(0))}
        bwd_err, issue_bound = {}, {}
        for k, (got, want) in exact.items():
            bwd_err[k] = (got.float() - want.float()).abs().max().item()
            if not torch.equal(got, want):
                raise RuntimeError(f"{label} bwd res={res}: {k} differs by "
                                   f"{bwd_err[k]} (must be equal)")
        for k, (got, want, scale) in sums.items():
            err = (got - want).abs()
            bwd_err[k] = err.max().item()
            if (err > F32_SUM_TOL * (1 + scale)).any():
                worst = (err / (1 + scale)).max().item()
                raise RuntimeError(f"{label} bwd res={res}: {k} differs by "
                                   f"{bwd_err[k]}, {worst} of 1 + Σ|term| "
                                   f"(bound {F32_SUM_TOL})")
            issue_bound[k] = 20 * tol * (1 + want.abs().max().item())
        n_io = 3 if res else 2     # forward: x (and r) read, y written
        for name, fwd in (("bn_act_fwd_res" if res else "bn_act_fwd", True),
                          ("bn_act_bwd_res" if res else "bn_act_bwd", False)):
            if fwd:
                nbytes = n_io * m * c * elt + 2 * c * 4
                kern = lambda: fn.bn_act_fwd(x, rr, a, b)  # noqa: E731
                plain = lambda: fn.bn_act_fwd_plain(  # noqa: E731
                    x, rr, a, b)
                err = y_err
            else:
                # x, dy (and r) read; dx (and dr) written; a, b read and
                # da, db written as (C,) f32.
                nbytes = (n_io + 1 + res) * m * c * elt + 4 * c * 4
                kern = lambda: fn.bn_act_bwd(x, rr, dy, a, b)  # noqa: E731
                plain = lambda: fn.bn_act_bwd_plain(  # noqa: E731
                    x, rr, dy, a, b)
                err = max(bwd_err.values())
            ops = NORM_OPS[name] * m * c
            t_bytes = nbytes / peaks["hbm"] * 1e3
            t_ops = ops / peaks["f32"] * 1e3
            rows[name] = {
                "case": label, "shape": [m, c],
                "dtype": str(dtype).replace("torch.", ""), "tol": tol,
                "max_abs_err": err, "errors": bwd_err if not fwd else
                {"y": y_err}, "sum_tol": F32_SUM_TOL,
                "bound_20tol": issue_bound if not fwd else None,
                "bytes": nbytes, "ops": ops,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "kernel_ms": time_ms(kern),
                "plain_ms": time_ms(plain, reps=5 if large else 25,
                                    inner=2 if large else 10),
                # No one PyTorch call computes relu(x·a + b) with this
                # rounding (or its backward with per-block partials).
                "library_ms": None}
    return rows


def phase_fused_norm_vs_plain(peaks: dict) -> dict:
    cases = [(label, m, c, torch.bfloat16) for label, m, c in RESNET18_SHAPES]
    cases += [(label, m, c, torch.float32) for label, m, c in ODD_SHAPES]
    rows = []
    for i, (label, m, c, dtype) in enumerate(cases):
        for name, row in _norm_case(label, m, c, dtype, peaks, i).items():
            rows.append(dict(row, kernel=name))
    out = {"phase": "fused_norm_vs_plain", "cases": rows,
           "library_ms": "null: no single PyTorch call computes the "
                         "epilogue with its rounding, or its backward "
                         "with per-block partials"}
    emit(out)
    return out


# -- phase 4: training end to end ---------------------------------------------

def _epoch_losses(text: str, kind: str) -> list[float]:
    return [float(ln.split("Loss ")[1].split()[0]) for ln in text.splitlines()
            if ln.startswith(f"||==> {kind}: Epoch[")]


def phase_train() -> dict:
    outdir = os.path.join(tempfile.mkdtemp(prefix="tpudist_torch_train_"),
                          "run")
    argv = ["--synthetic", "-a", "resnet18", "--image-size", str(TRAIN_PX),
            "--num-classes", "1000", "-b", str(TRAIN_B), "--epochs", "2",
            "--use_amp", "--fused-bn", "on", "--telemetry", "--seed", "0",
            "--outpath", outdir, "--synthetic-size", "2048", "--step", "1",
            "-p", "4"]
    buf = io.StringIO()
    fn.reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train_cli.main(argv)
    wall_s = time.perf_counter() - t0
    launches, relayouts = dict(fn.LAUNCHES), fn.RELAYOUTS
    text = buf.getvalue()
    print(text, end="", flush=True)
    if rc != 0 or not text.splitlines()[-1].startswith("best_acc1="):
        raise RuntimeError(f"python -m tpudist_torch exited {rc}")
    with open(telemetry_lib.events_path(outdir, 0)) as f:
        events = [json.loads(ln) for ln in f]
    for ev in events:
        telemetry_lib.validate_event(ev)
    steps = [e for e in events if e["type"] == "step"]
    n = len(steps)
    want = {"bn_act_fwd": 9 * n, "bn_act_fwd_res": 8 * n,
            "bn_act_bwd": 9 * n, "bn_act_bwd_res": 8 * n}
    if n != 16 or launches != want:
        raise RuntimeError(f"fused-norm launches {launches} for {n} train "
                           f"steps; want {want} (17 a step each way, none "
                           f"in validation)")
    first = ("=> fused-norm kernels launched by the first train step: "
             f"{2 * SITES_PER_STEP} ("
             + ", ".join(f"{k} {v // n}" for k, v in want.items()) + ")")
    if first not in text.splitlines():
        raise RuntimeError(f"the trainer did not log {first!r}")
    train_l, val_l = _epoch_losses(text, "Train"), _epoch_losses(text, "Val")
    if len(train_l) != 2 or len(val_l) != 2 or not all(
            np.isfinite(train_l + val_l)):
        raise RuntimeError(f"train losses {train_l}, val losses {val_l}")
    steady = [e["step_s"] for e in steps[1:]]
    end = events[-1]
    out = {"phase": "train", "arch": "resnet18", "image_size": TRAIN_PX,
           "batch": TRAIN_B, "dtype": "bfloat16", "wall_s": wall_s,
           "train_steps": n, "fused_norm_launches": launches,
           "launches_per_step": {k: v / n for k, v in launches.items()},
           "relayouts": relayouts, "train_loss": train_l,
           "val_loss": val_l,
           "best_acc1": float(text.splitlines()[-1].split("=")[1]),
           "host_step_s_p50": statistics.median(steady),
           "host_data_s_p50": statistics.median(
               e["data_s"] for e in steps[1:]),
           "host_compute_s_p50": statistics.median(
               e["compute_s"] for e in steps[1:]),
           "run_end": {k: end[k] for k in ("wall_s", "productive_s",
                                           "goodput", "compile_s",
                                           "data_wait_s", "eval_s")}}
    emit(out)
    return out


def _train_setup(fused: bool, dtype=torch.bfloat16, seed: int = 0):
    cfg = config_lib.Config(batch_size=TRAIN_B, image_size=TRAIN_PX,
                            fused_bn="on" if fused else "off")
    model = create_model("resnet18", dtype=dtype, fused_bn=fused)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.cuda()
    step = train_lib.make_train_step(
        model, train_lib.make_optimizer(model, cfg), cfg)
    return model, step


def _leaves(model) -> dict:
    return {k: v.detach().float().clone()
            for k, v in model.state_dict().items()}


def _device_batch(seed: int, batch: int = TRAIN_B):
    g = torch.Generator(device="cuda").manual_seed(seed)
    images = torch.randn(batch, TRAIN_PX, TRAIN_PX, 3, generator=g,
                         device="cuda")
    labels = torch.randint(0, 1000, (batch,), generator=g, device="cuda")
    return images, labels


def compare_on_off(setup, dtype, batch: int, lr: float) -> dict:
    """TRAIN_CMP_STEPS train steps with the kernels on (``setup(True,
    dtype)``) and off from one seed on the same device batches: the
    losses, and per parameter and running statistic max|on − off| over the
    off run's largest change, after the first step and (reported only)
    after the last."""
    batches = [_device_batch(100 + i, batch) for i in range(TRAIN_CMP_STEPS)]
    losses, first, last = {}, {}, {}
    for mode in ("on", "off"):
        model, step = setup(mode == "on", dtype)
        init = _leaves(model)
        losses[mode] = []
        for i, (x, y) in enumerate(batches):
            losses[mode].append(float(step(x, y, lr)["loss"]))
            if i == 0:
                first[mode] = _leaves(model)
        last[mode] = _leaves(model)
        del model, step

    def ratios(leaves):
        out = {}
        for k, want in leaves["off"].items():
            change = (want - init[k]).abs().max().item()
            out[k] = (leaves["on"][k] - want).abs().max().item() \
                / max(change, 1e-30)
        return out

    ratio, drift = ratios(first), ratios(last)
    worst = max(ratio, key=ratio.get)
    return {"dtype": str(dtype).replace("torch.", ""),
            "losses_on": losses["on"], "losses_off": losses["off"],
            "loss_abs_diff": [abs(a - b) for a, b in zip(losses["on"],
                                                          losses["off"])],
            "state_ratio_max": ratio[worst], "state_ratio_worst_leaf": worst,
            "state_ratio_median": statistics.median(ratio.values()),
            "state_ratio_max_after_last_step": max(drift.values())}


def _held_on_off(row: dict, loss_tol: dict, state_tol: dict,
                 what: str) -> list[str]:
    """What breaks the on/off bounds in one comparison row (none: []);
    both bounds are per dtype."""
    tol, ltol = state_tol[row["dtype"]], loss_tol[row["dtype"]]
    bad = [f"{what} losses {row['losses_on']} vs {row['losses_off']}"
           for d, ref in zip(row["loss_abs_diff"], row["losses_off"])
           if not np.isfinite(d) or d > ltol * max(1.0, abs(ref))][:1]
    if not row["state_ratio_max"] <= tol:
        bad.append(f"{what} weights differ by {row['state_ratio_max']} of "
                   f"their change in {row['state_ratio_worst_leaf']} (bound "
                   f"{tol})")
    return bad


def phase_fused_vs_plain() -> dict:
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        row = compare_on_off(_train_setup, dtype, TRAIN_B, 0.1)
        bad = _held_on_off(row, TRAIN_LOSS_TOL, TRAIN_STATE_TOL,
                           "--fused-bn on vs off")
        if bad:
            raise RuntimeError(f"{'; '.join(bad)}: {row}")
        rows.append(dict(row,
                         loss_tol_relative=TRAIN_LOSS_TOL[row["dtype"]],
                         state_tol=TRAIN_STATE_TOL[row["dtype"]]))
    out = {"phase": "fused_vs_plain_train", "steps": TRAIN_CMP_STEPS,
           "rows": rows}
    emit(out)
    return out


def _train_category(kernel: str) -> str:
    n = kernel.lower()
    if "bn_act_fwd" in n:
        return "fused_norm_fwd"
    if "bn_act_bwd" in n:
        return "fused_norm_bwd"
    if "pool" in n:
        return "pool"
    if any(s in n for s in ("dgrad", "wgrad", "bprop", "backward_data",
                            "backward_filter")):
        return "conv_bwd"
    if any(s in n for s in ("conv", "cudnn", "xmma", "fprop",
                            "implicit_gemm", "nhwc", "nchw")):
        return "conv_fwd"
    if any(s in n for s in ("gemm", "cutlass", "nvjet", "cublas")):
        return "matmul"
    if "reduce" in n:
        return "bn_statistics"
    if "multi_tensor" in n or "sgd" in n:
        return "optimizer"
    if any(s in n for s in ("copy", "cast", "convert", "memcpy")):
        return "casts_copies"
    if "elementwise" in n:
        return "elementwise"
    return "other"


def phase_train_breakdown() -> dict:
    """One resnet18 train step (batch 256, 224 px, bf16, --fused-bn on)
    on a device-resident batch: synchronised wall (median of 15),
    images/s, device busy time by category (torch.profiler over 3 steps),
    the idle share, kernels a step and the fused backward's re-layouts."""
    _, step = _train_setup(True)
    x, y = _device_batch(7)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        step(x, y, 0.1)
    torch.cuda.synchronize()
    walls = []
    for _ in range(15):
        t0 = time.perf_counter()
        step(x, y, 0.1)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    n = 3
    fn.reset_counts()
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(n):
            step(x, y, 0.1)
        torch.cuda.synchronize()
    relayouts = fn.RELAYOUTS / n
    by_cat, kernels = _device_kernels(prof, n, _train_category)
    busy = sum(by_cat.values())
    out = {"phase": "train_step_breakdown", "arch": "resnet18",
           "batch": TRAIN_B, "image_size": TRAIN_PX, "dtype": "bfloat16",
           "fused_bn": "on", "wall_ms_p50": wall,
           "wall_ms_min": min(walls), "images_per_s": TRAIN_B / wall * 1e3,
           "device_busy_ms": busy if busy else "not measured",
           "idle_share": 1.0 - busy / wall if busy else "not measured",
           "by_category_ms": by_cat or "not measured",
           "kernel_launches_per_step": sum(k["calls"] for k in kernels),
           "relayouts_per_step": relayouts,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "top_kernels": kernels[:20]}
    emit(out)
    return out


# -- phase 2b: the flash-attention backward -----------------------------------

def _bwd_work(q, k, causal):
    """Bytes each backward pass must move (q, k, v, dO, lse, delta read
    once; dq, or dk and dv, written once) and the FLOPs of its products
    over the visible (row, key) pairs: S, dP and dS·K for the dQ pass; S,
    dP, Pᵀ·dO and dSᵀ·Qs for the dKV pass."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    elt = q.element_size()
    if causal:
        pairs = sum(max(0, min(tk, i + tk - tq + 1)) for i in range(tq))
    else:
        pairs = tq * tk
    reads = (2 * q.numel() + 2 * k.numel()) * elt + 2 * b * h * tq * 4
    product = 2.0 * b * h * pairs * d
    return {"flash_bwd_dq": (reads + q.numel() * elt, 3 * product),
            "flash_bwd_dkv": (reads + 2 * k.numel() * elt, 4 * product)}


def _grad_errors(got, want, tol):
    """max|got − ref| of dq, dk and dv; raises unless each is within rtol
    ``tol`` and atol ``tol``·max|ref|."""
    errs = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = a.float(), b.float()
        errs[name] = (a - b).abs().max().item()
        torch.testing.assert_close(
            a, b, rtol=tol, atol=tol * max(1e-6, b.abs().max().item()),
            msg=lambda m, name=name: f"{name}: {m}")
    return errs


def _sdpa_backward_kernels(o_l, inputs, do_t) -> list[str]:
    """Names of the device kernels one SDPA backward launches (one
    torch.profiler pass): they say which backend (flash or memory-
    efficient) ``library_ms`` timed."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        torch.autograd.grad(o_l, inputs, do_t, retain_graph=True)
        torch.cuda.synchronize()
    return sorted(k["kernel"] for k in _device_kernels(prof, 1, str)[1])


def phase_flash_bwd_vs_plain(peaks: dict) -> dict:
    cases = [
        # (label, B, Tq, Tk, H, D, dtype, causal): ViT-B/16's training
        # shape first, then head dim 80 at 197 tokens, a ragged causal
        # cross length, and head dim 32 with fully masked rows, in f32
        # (the scalar kernels) and in bf16 (the tensor-core kernels; at
        # D = 32 and 80 the scale is no power of two, so an unrounded Qs
        # would show there only).
        (f"train_b{VIT_B}", VIT_B, SERVE_T, SERVE_T, SERVE_H, SERVE_D,
         torch.bfloat16, False),
        ("f32_d80", 2, SERVE_T, SERVE_T, 4, 80, torch.float32, False),
        ("f32_causal_cross", 2, 150, 197, 4, 64, torch.float32, True),
        ("f32_d32_masked_rows", 2, 100, 60, 3, 32, torch.float32, True),
        ("bf16_d80", 2, SERVE_T, SERVE_T, 4, 80, torch.bfloat16, False),
        ("bf16_causal_cross", 2, 150, 197, 4, 64, torch.bfloat16, True),
        ("bf16_d32_masked_rows", 2, 100, 60, 3, 32, torch.bfloat16, True),
    ]
    rows = []
    for i, (label, b, tq, tk, h, d, dtype, causal) in enumerate(cases):
        q, k, v = _qkv_views(b, tq, tk, h, d, dtype, seed=50 + i)
        g = torch.Generator(device="cuda").manual_seed(150 + i)
        do = torch.randn(b, tq, h, d, generator=g, device="cuda").to(dtype)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        delta, lse = fa.backward_rows(o, lse, do)
        args = (q, k, v, do, lse, delta, causal)
        dq = fa.flash_bwd_dq(*args)
        dk, dv = fa.flash_bwd_dkv(*args)
        again = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_reference(*args)
        tol = BWD_TOL[dtype]
        errs = _grad_errors((dq, dk, dv), want, tol)
        if causal and tq > tk and not torch.all(dq[:, :tq - tk] == 0):
            raise RuntimeError(f"{label}: rows that see no key got a dq")
        if not all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv))):
            raise RuntimeError(f"{label}: two launches on the same inputs "
                               f"differ")
        large = b >= VIT_B
        row = {"case": label, "shape": [b, tq, tk, h, d],
               "dtype": str(dtype).replace("torch.", ""), "causal": causal,
               "tol": tol, "errors": errs,
               "relative_errors": {
                   n: errs[n] / max(1e-30, w.float().abs().max().item())
                   for n, w in zip(("dq", "dk", "dv"), want)},
               "not_bit_equal_share": {
                   n: (a != w).float().mean().item()
                   for n, a, w in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                      want)},
               "plain_ms": time_ms(
                   lambda: fa.flash_attention_bwd_reference(*args),
                   reps=5 if large else 25, inner=2 if large else 10)}
        rate = peaks["bf16" if dtype == torch.bfloat16 else "f32"]
        for name, (nbytes, flops) in _bwd_work(q, k, causal).items():
            t_bytes, t_ops = nbytes / peaks["hbm"] * 1e3, flops / rate * 1e3
            fn_ = fa.flash_bwd_dq if name == "flash_bwd_dq" \
                else fa.flash_bwd_dkv
            row[name] = {
                "bytes": nbytes, "flops": flops,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "kernel_ms": time_ms(lambda fn_=fn_: fn_(*args)),
                "max_abs_err": max(errs[n] for n in (
                    ("dq",) if name == "flash_bwd_dq" else ("dk", "dv")))}
        if not causal:
            # SDPA's backward alone, from a retained graph; SDPA's causal
            # mask aligns top-left, not at the k_len − q_len offset.
            qt, kt, vt = (t.detach().transpose(1, 2).contiguous()
                          .requires_grad_() for t in (q, k, v))
            o_l = F.scaled_dot_product_attention(qt, kt, vt)
            do_t = do.transpose(1, 2)
            row["library_ms"] = time_ms(lambda: torch.autograd.grad(
                o_l, (qt, kt, vt), do_t, retain_graph=True))
            row["library_kernels"] = _sdpa_backward_kernels(
                o_l, (qt, kt, vt), do_t)
            del o_l
        else:
            row["library_ms"] = None
            row["library_kernels"] = None
        rows.append(row)
    out = {"phase": "flash_bwd_vs_plain", "cases": rows,
           "library": "torch.nn.functional.scaled_dot_product_attention "
                      "backward (torch.autograd.grad from a retained "
                      "graph)"}
    emit(out)
    return out


# -- phase 5: ViT-B/16 training end to end ------------------------------------

def phase_train_vit() -> dict:
    outdir = os.path.join(tempfile.mkdtemp(prefix="tpudist_torch_vit_"),
                          "run")
    argv = ["--synthetic", "-a", "vit_b_16", "--image-size", "224",
            "--num-classes", "1000", "-b", str(VIT_B), "--epochs", "2",
            "--use_amp", "--flash", "on", "--optimizer", "adamw", "--lr",
            "1e-3", "--weight-decay", "0.05", "--telemetry", "--seed", "0",
            "--synthetic-size", str(VIT_SYNTHETIC), "--step", "1", "-p", "4",
            "--outpath", outdir]
    buf = io.StringIO()
    fa.reset_counts()
    fn.reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train_cli.main(argv)
    wall_s = time.perf_counter() - t0
    launches, relayouts = dict(fa.LAUNCHES), fa.RELAYOUTS
    text = buf.getvalue()
    print(text, end="", flush=True)
    if rc != 0 or not text.splitlines()[-1].startswith("best_acc1="):
        raise RuntimeError(f"python -m tpudist_torch -a vit_b_16 exited {rc}")
    with open(telemetry_lib.events_path(outdir, 0)) as f:
        events = [json.loads(ln) for ln in f]
    for ev in events:
        telemetry_lib.validate_event(ev)
    steps = [e for e in events if e["type"] == "step"]
    n = len(steps)
    val_batches = 2 * math.ceil(VIT_SYNTHETIC // 2 / VIT_B)
    want = {"flash_fwd": LAYERS * (n + val_batches),
            "flash_bwd_dq": LAYERS * n, "flash_bwd_dkv": LAYERS * n}
    if n != 2 * VIT_SYNTHETIC // VIT_B or launches != want \
            or any(fn.LAUNCHES.values()):
        raise RuntimeError(
            f"flash launches {launches} (fused-norm {fn.LAUNCHES}) for {n} "
            f"train steps and {val_batches} validation batches; want {want} "
            f"(12 of each kernel a train step, 12 forwards a validation "
            f"batch)")
    first = ("=> flash kernels launched by the first train step: 36 "
             "(flash_fwd 12, flash_bwd_dq 12, flash_bwd_dkv 12)")
    if first not in text.splitlines():
        raise RuntimeError(f"the trainer did not log {first!r}")
    disp = [e for e in events if e["type"] == "attention_dispatch"]
    if [(e["kernel"], e["mode"]) for e in disp] != [("flash", "on")]:
        raise RuntimeError(f"attention_dispatch events {disp}")
    train_l, val_l = _epoch_losses(text, "Train"), _epoch_losses(text, "Val")
    if len(train_l) != 2 or len(val_l) != 2 or not all(
            np.isfinite(train_l + val_l)):
        raise RuntimeError(f"train losses {train_l}, val losses {val_l}")
    end = events[-1]
    out = {"phase": "train_vit", "arch": "vit_b_16", "image_size": 224,
           "batch": VIT_B, "dtype": "bfloat16", "optimizer": "adamw",
           "wall_s": wall_s, "train_steps": n, "val_batches": val_batches,
           "flash_launches": launches,
           "launches_per_train_step": {k: LAYERS for k in launches},
           "relayouts": relayouts, "train_loss": train_l,
           "val_loss": val_l,
           "best_acc1": float(text.splitlines()[-1].split("=")[1]),
           "host_step_s_p50": statistics.median(
               e["step_s"] for e in steps[1:]),
           "host_data_s_p50": statistics.median(
               e["data_s"] for e in steps[1:]),
           "host_compute_s_p50": statistics.median(
               e["compute_s"] for e in steps[1:]),
           "run_end": {k: end[k] for k in ("wall_s", "productive_s",
                                           "goodput", "compile_s",
                                           "data_wait_s", "eval_s")}}
    emit(out)
    return out


def _vit_setup(flash: bool, dtype=torch.bfloat16, seed: int = 0,
               optimizer: str = "sgd"):
    cfg = config_lib.Config(arch="vit_b_16", batch_size=VIT_B,
                            image_size=TRAIN_PX, optimizer=optimizer,
                            flash="on" if flash else "off")
    model = create_model("vit_b_16", dtype=dtype, flash=flash,
                         image_size=TRAIN_PX)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.cuda()
    step = train_lib.make_train_step(
        model, train_lib.make_optimizer(model, cfg), cfg)
    return model, step


def compare_flash_and_plain() -> list[dict]:
    """SGD, not AdamW: AdamW's first step is lr·sign(g) almost everywhere,
    so it would hide a gradient that is off by a factor."""
    return [compare_on_off(_vit_setup, dtype, VIT_CMP_B, VIT_CMP_LR)
            for dtype in (torch.bfloat16, torch.float32)]


def phase_flash_vs_plain_train() -> dict:
    rows = []
    for row in compare_flash_and_plain():
        bad = _held_on_off(row, VIT_LOSS_TOL, VIT_STATE_TOL,
                           "--flash on vs off")
        if bad:
            raise RuntimeError(f"{'; '.join(bad)}: {row}")
        rows.append(dict(row, loss_tol_relative=VIT_LOSS_TOL[row["dtype"]],
                         state_tol=VIT_STATE_TOL[row["dtype"]]))
    out = {"phase": "flash_vs_plain_train", "arch": "vit_b_16",
           "batch": VIT_CMP_B, "optimizer": "sgd", "lr": VIT_CMP_LR,
           "steps": TRAIN_CMP_STEPS, "rows": rows}
    emit(out)
    return out


def _dq_off(dq):
    return dq * 1.1


def _key_tile_dropped(out):
    dk, dv = out
    dk, dv = dk.clone(), dv.clone()
    dk[:, 64:128] = 0
    dv[:, 64:128] = 0
    return dk, dv


MUTATIONS = {"dq_10pct_off": ("flash_bwd_dq", _dq_off),
             "key_tile_1_dropped": ("flash_bwd_dkv", _key_tile_dropped)}

# Faults of the forward: one line of flash_fwd.cu's tensor-core kernel
# patched, built into a library of its own. Key tile 1's P zeroed before
# P·V (its contribution to O dropped, l kept), and l summed from the
# bf16-rounded P instead of the unrounded one.
FWD_MUTANTS = {
    "fwd_key_tile_1_dropped": (
        "      pack_a(aP, s[2 * kk], s[2 * kk + 1]);\n",
        "      pack_a(aP, s[2 * kk], s[2 * kk + 1]);\n"
        "      if (kt == 1) aP[0] = aP[1] = aP[2] = aP[3] = 0u;\n"),
    "fwd_l_from_rounded_p": (
        "        ls[e >> 1] += p;\n",
        "        ls[e >> 1] += __bfloat162float(__float2bfloat16(p));\n"),
}


def _build_mutants(root: str) -> dict:
    """Each forward fault built under ``root`` from a patched copy of the
    kernel sources, all nvcc runs at once: the path of each library."""
    jobs = {}
    for name, (old, new) in FWD_MUTANTS.items():
        d = os.path.join(root, name)
        shutil.copytree(_build.CSRC_DIR, d)
        src = os.path.join(d, _build.SOURCES["flash_fwd"])
        with open(src) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the line it patches is not in "
                               f"flash_fwd.cu exactly once: {old!r}")
        with open(src, "w") as f:
            f.write(text.replace(old, new))
        lib = os.path.join(d, "libflash_fwd.so")
        jobs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        libs[name] = lib
    return libs


@contextlib.contextmanager
def _forward_library(path: str):
    """The flash forward launched from the library at ``path`` (the
    wrapper, its launch count and its checks unchanged) inside the block."""
    saved = _build._libs.get("flash_fwd")
    _build._libs["flash_fwd"] = ctypes.CDLL(path)
    fa._fns.pop("flash_fwd", None)
    try:
        yield
    finally:
        if saved is None:
            _build._libs.pop("flash_fwd", None)
        else:
            _build._libs["flash_fwd"] = saved
        fa._fns.pop("flash_fwd", None)


def _forward_mutation(name: str, path: str) -> bool:
    """One forward fault against every bound that can see it: the bf16
    kernel_vs_plain cases, the served logits on/off and the bf16 --flash
    on/off training comparison. Whether any of them breaks."""
    with _forward_library(path):
        cases = []
        for i, (label, b, tq, tk, h, d, dtype, causal) in enumerate(
                FWD_CASES):
            if dtype == torch.bfloat16:
                q, k, v = _qkv_views(b, tq, tk, h, d, dtype, seed=i)
                row, bad = _fwd_check(q, k, v, causal)
                cases.append(dict(row, case=label, breaks=bad))
        logits, serve_bad, model = serve_logits_on_off()
        del model
        train = compare_on_off(_vit_setup, torch.bfloat16, VIT_CMP_B,
                               VIT_CMP_LR)
        train_bad = _held_on_off(train, VIT_LOSS_TOL, VIT_STATE_TOL, name)
    breaks = {"kernel_vs_plain": [f"{c['case']}: {'; '.join(c['breaks'])}"
                                  for c in cases if c["breaks"]],
              "serve_logits": [serve_bad] if serve_bad else [],
              "flash_vs_plain_train_bf16": train_bad}
    emit({"phase": "mutation", "mutation": name,
          "breaks_bounds": {k: bool(v) for k, v in breaks.items()},
          "why": breaks, "kernel_cases": cases, "serve": logits,
          "train_row": train})
    return any(breaks.values())


def run_mutations() -> int:
    """The --flash on/off comparison with a fault in the backward's
    result, each fault in turn, then each forward fault against every
    bound that can see it: 0 if every fault breaks a bound (a backward
    fault: the training bounds in both dtypes)."""
    caught = {}
    for name, (kernel, fault) in MUTATIONS.items():
        real = getattr(fa, kernel)
        setattr(fa, kernel, lambda *a, real=real, fault=fault, **k:
                fault(real(*a, **k)))
        try:
            rows = compare_flash_and_plain()
        finally:
            setattr(fa, kernel, real)
        broken = {r["dtype"]: _held_on_off(r, VIT_LOSS_TOL, VIT_STATE_TOL,
                                           name) for r in rows}
        caught[name] = all(broken.values())
        emit({"phase": "mutation", "mutation": name,
              "breaks_bounds": {k: bool(v) for k, v in broken.items()},
              "why": broken, "rows": rows})
    root = tempfile.mkdtemp(prefix="tpudist_torch_mutants_")
    try:
        for name, path in _build_mutants(root).items():
            caught[name] = _forward_mutation(name, path)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"mutations_caught": caught})
    return 0 if all(caught.values()) else 1


def _vit_category(kernel: str) -> str:
    n = kernel.lower()
    for name in fa.KERNELS:
        if name in n:
            return name
    if any(s in n for s in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "matmul"
    if "conv" in n or "cudnn" in n:
        return "conv"
    if "multi_tensor" in n or "adam" in n:
        return "optimizer"
    if "layer_norm" in n:
        return "layer_norm"
    if any(s in n for s in ("copy", "cast", "convert")):
        return "casts_copies"
    if any(s in n for s in ("elementwise", "gelu", "reduce", "softmax",
                            "cross_entropy", "nll")):
        return "elementwise_reductions"
    return "other"


def phase_vit_train_step_breakdown() -> dict:
    """One ViT-B/16 train step (batch 128, 224 px, bf16, --flash on,
    AdamW) on a device-resident batch: synchronised wall (median of 10),
    images/s, device busy by category (torch.profiler over 3 steps), the
    idle share, launches a step and the peak memory."""
    _, step = _vit_setup(True, optimizer="adamw")
    x, y = _device_batch(7, VIT_B)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        step(x, y, 1e-3)
    torch.cuda.synchronize()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        step(x, y, 1e-3)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    n = 3
    fa.reset_counts()
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(n):
            step(x, y, 1e-3)
        torch.cuda.synchronize()
    launches = {k: v / n for k, v in fa.LAUNCHES.items()}
    relayouts = fa.RELAYOUTS / n
    by_cat, kernels = _device_kernels(prof, n, _vit_category)
    busy = sum(by_cat.values())
    out = {"phase": "vit_train_step_breakdown", "arch": "vit_b_16",
           "batch": VIT_B, "image_size": TRAIN_PX, "dtype": "bfloat16",
           "flash": "on", "optimizer": "adamw", "wall_ms_p50": wall,
           "wall_ms_min": min(walls), "images_per_s": VIT_B / wall * 1e3,
           "device_busy_ms": busy if busy else "not measured",
           "idle_share": 1.0 - busy / wall if busy else "not measured",
           "by_category_ms": by_cat or "not measured",
           "flash_launches_per_step": launches,
           "relayouts_per_step": relayouts,
           "kernel_launches_per_step": sum(k["calls"] for k in kernels),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "top_kernels": kernels[:20]}
    emit(out)
    return out


def _bwd_kernel_entries(bwd: dict, vit: dict, card: dict) -> list:
    """The dQ and dKV entries of the kernels line: the main row is ViT-B/16's
    training shape; ``step_ms`` is the kernel's time over one train step's
    12 launches."""
    replaces = {
        "flash_bwd_dq": "tpudist/ops/pallas/flash_attention.py:373 "
                        "(_bwd_dq_kernel, via _flash_backward)",
        "flash_bwd_dkv": "tpudist/ops/pallas/flash_attention.py:425 "
                         "(_bwd_dkv_kernel, via _flash_backward)"}
    main = bwd["cases"][0]
    out = []
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        r = main[name]
        out.append({
            "name": name, "route": "cuda",
            "source": "tpudist_torch/ops/csrc/flash_bwd.cu",
            "replaces": replaces[name],
            "launches": vit["flash_launches"][name],
            "max_abs_err": max(c[name]["max_abs_err"] for c in bwd["cases"]),
            "ms": r["kernel_ms"], "kernel_ms": r["kernel_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": main["library_ms"],
            "library_kernels": main["library_kernels"],
            "plain_and_library_cover": "both backward passes",
            "shape": main["shape"], "dtype": main["dtype"],
            "step_ms": LAYERS * r["kernel_ms"],
            "by_shape": [{"case": c["case"], "shape": c["shape"],
                          "kernel_ms": c[name]["kernel_ms"],
                          "bound_ms": c[name]["bound_ms"],
                          "plain_ms": c["plain_ms"],
                          "library_ms": c["library_ms"]}
                         for c in bwd["cases"]],
            "ptxas": {k: r for k, r in _mma_ptxas(card, "flash_bwd").items()
                      if k.startswith(name + "_mma")},
            "card": card["nvidia_smi"]})
    return out


def _mma_ptxas(card: dict, library: str) -> dict:
    """Registers and spills of a library's bf16 tensor-core kernels, from
    this run's build (none if the library was built before it)."""
    return {k: r for k, r in card["ptxas"].get(library, {}).items()
            if "_mma<" in k}


def _norm_kernel_entries(norm: dict, train: dict, card: dict) -> list:
    """The four fused-norm entries of the kernels line: the main row is
    the largest main-path shape of each kernel (the stem for the plain
    epilogue, stage 1 for the residual one); ``step_ms`` sums the kernel's
    measured time over one step's launches at their shapes."""
    replaces = {
        "bn_act_fwd": "tpudist/ops/pallas/fused_norm.py:83 (_fwd_kernel, "
                      "via _fwd_call)",
        "bn_act_fwd_res": "tpudist/ops/pallas/fused_norm.py:89 "
                          "(_fwd_res_kernel, via _fwd_call)",
        "bn_act_bwd": "tpudist/ops/pallas/fused_norm.py:100 (_bwd_kernel, "
                      "via _bwd_call)",
        "bn_act_bwd_res": "tpudist/ops/pallas/fused_norm.py:110 "
                          "(_bwd_res_kernel, via _bwd_call)"}
    # Launches a step at each shape: the stem once (plain only), each
    # stage twice.
    per_step = {"stem": 1, "layer1": 2, "layer2": 2, "layer3": 2,
                "layer4": 2}
    out = []
    for name in fn.KERNELS:
        rows = [r for r in norm["cases"] if r["kernel"] == name]
        res = name.endswith("_res")
        main = [r for r in rows if r["case"] == ("layer1" if res
                                                 else "stem")][0]
        step_rows = [(r, per_step[r["case"]]) for r in rows
                     if r["case"] in per_step
                     and not (res and r["case"] == "stem")]
        out.append({
            "name": name, "route": "cuda",
            "source": "tpudist_torch/ops/csrc/fused_norm.cu",
            "replaces": replaces[name],
            "launches": train["fused_norm_launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["kernel_ms"], "kernel_ms": main["kernel_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "shape": main["shape"], "dtype": main["dtype"],
            "step_ms": sum(r["kernel_ms"] * k for r, k in step_rows),
            "step_bound_ms": sum(r["bound_ms"] * k for r, k in step_rows),
            "by_shape": [{k: r[k] for k in ("case", "shape", "kernel_ms",
                                            "plain_ms", "bound_ms")}
                         for r in rows],
            "card": card["nvidia_smi"]})
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    if argv not in ([], ["--mutations"]):
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_card_and_build()
    if argv:
        return run_mutations()
    _, peaks = peaks_for(card["device_name"])
    kern = phase_kernel_vs_plain(peaks)
    bwd = phase_flash_bwd_vs_plain(peaks)
    norm = phase_fused_norm_vs_plain(peaks)
    serve, model = phase_serve()
    phase_forward_breakdown(model)
    del model
    train = phase_train()
    phase_fused_vs_plain()
    phase_train_breakdown()
    vit = phase_train_vit()
    phase_flash_vs_plain_train()
    phase_vit_train_step_breakdown()

    fwd_rows = [r for r in kern["cases"] if r["case"].startswith(
        ("serve_", "train_"))]
    main_row = fwd_rows[-1]                # batch 128, the training call
    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "tpudist_torch/ops/csrc/flash_fwd.cu",
        "replaces": "tpudist/ops/pallas/flash_attention.py:95 "
                    "(_flash_kernel, via _flash_forward)",
        "launches": serve["flash_launches"]
        + vit["flash_launches"]["flash_fwd"],
        "launches_by_path": {
            "serve": serve["flash_launches"],
            "train_vit": vit["flash_launches"]["flash_fwd"]},
        "max_abs_err": max(r["o_max_abs_err"] for r in kern["cases"]),
        "ms": main_row["kernel_ms"], "kernel_ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"], "dtype": main_row["dtype"],
        "by_batch": [{k: r[k] for k in ("shape", "kernel_ms", "plain_ms",
                                         "library_ms", "bound_ms")}
                     for r in fwd_rows],
        "o_not_bit_equal_share": {r["case"]: r["o_not_bit_equal_share"]
                                  for r in kern["cases"]},
        "ptxas": _mma_ptxas(card, "flash_fwd"),
        "card": card["nvidia_smi"]}] + _bwd_kernel_entries(bwd, vit, card)
        + _norm_kernel_entries(norm, train, card)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
