#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

The quickest proof that ``tpudist_torch`` builds, serves and trains on the
GPU. It imports the port, torch and numpy only, needs one card and no
network, and builds every kernel from the sources in this checkout (one
``nvcc`` per source, all started together). Phases, each printing one JSON
line and raising on failure:

1. card and build: the card (``nvidia-smi`` name and power limit, torch's
   device name and CUDA version), then ``nvcc`` builds every kernel and
   its ``-Xptxas -v`` report (registers, spills) is printed; a 16-bit
   (bf16 or float16) tensor-core kernel that spills fails the phase.
   ``startup`` then points every Python process this script starts at a
   bytecode cache in the checkout (the first launch fills it);
2. kernel vs plain: each kernel against its plain-PyTorch version on the
   card, with its time, the plain version's, one PyTorch library call's
   (where one computes the same function) and the card's bound:
   a. the flash-attention forward at the serving shapes, ViT-B/16's
      training shape (batch 128) and odd shapes in f32, bf16 and float16
      (head dims 32 and 80, a causal cross length, fully masked rows): o
      and lse within the bound (the 16-bit lse within the f32 one), the
      share of O entries not bit-equal to the plain version, two launches
      bit-identical, rows that see no key O = 0 and lse = -1e30; in
      float16 with inf and NaN planted in v and q, O and lse non-finite
      exactly where the plain version's are;
   b. the flash-attention backward, its dQ and dKV passes, at ViT-B/16's
      training shape in bf16 and float16 and at odd shapes in f32, bf16
      and float16 (head dims 32 and 80, causal cross lengths with fully
      masked rows): within the bound, the share of entries not bit-equal
      to the plain version, two launches bit-identical; beside SDPA's
      backward and the names of the device kernels it launched; in
      float16 with inf and NaN planted in dO, dq, dk and dv non-finite
      exactly where the plain version's are;
   c. the four fused BatchNorm epilogues (forward, forward+residual,
      backward, backward+residual) at the five resnet18 shapes of batch
      256 at 224 px in bf16 and float16 and three odd shapes in f32; in
      float16 with inf and NaN planted in x, r and dy and an affine past
      65,504, y, dx and dr equal the plain version's (NaN where it is
      NaN) and every partial is non-finite where the plain one is; then B1
      and B3 in bf16 at the new conv families' shapes (``ZOO_SHAPES``:
      vgg16_bn's 822 M-element first BatchNorms, 16, 48, 72, 80, 104,
      120, 440, 992 and 2,208 channels), and B1–B4 in bf16 at the 16-byte
      vector variant's edges (``NORM_EDGE_SHAPES``) and on rows one
      element off a 16-byte boundary, which must take the scalar variant;
      each case reports its variant and its share of the bytes bound;
3. serving end to end: ``python -m tpudist_torch.serve`` serves ViT-B/16
   at 224 px in bf16 under a short open-loop load; every bucket call must
   have gone through the flash kernel, and the logits of a ``--flash on``
   and a ``--flash off`` engine with the same weights must agree; then one
   forward at batch 1 and 8 is broken down by kernel (torch.profiler)
   beside its synchronised host wall; then the CLI's default arch,
   resnet18, serves for 1.5 s and launches no kernel (eval-mode BN), with
   ``--metrics-port 0``: its endpoint, scraped as it closes, counts the
   requests served;
4. training end to end: ``python -m tpudist_torch`` trains resnet18 at
   224 px, batch 256, bf16, ``--fused-bn on`` for two short epochs, with
   ``--telemetry --metrics-port 0 --telemetry-max-mb 0.004 --profile
   3:5`` (``observe``: each scrape of ``/metrics`` while it trains agrees
   with the step events around it, the rotated and live event files hold
   every step, the window's Chrome trace holds B1–B4 9/8/9/8 times in each
   of its two ``train`` ranges and no other of their launches); every
   train step must launch the fused-norm kernels exactly 17 times in each
   direction (in the 16-byte vector variant: the scalar one 0 times) and
   validation none, every telemetry event must validate and
   the losses must be finite; the first three steps' losses under
   ``--fused-bn on`` and ``off`` (same seed, same batches) must agree;
   then one train step on a device-resident batch is broken down by
   kernel category, and each fused-norm kernel's device ms, beside its
   synchronised wall;
5. ViT training end to end: ``python -m tpudist_torch`` trains ViT-B/16
   at 224 px, batch 128, bf16, ``--flash on``, AdamW for two short
   epochs; every train step must launch each flash kernel exactly 12
   times and every validation batch the forward alone 12 times; the first
   three SGD steps under ``--flash on`` and ``off`` (same seed, same
   batches, bf16 and f32) must agree; then one train step is broken down
   by kernel category;
5b. float16 (``--use_amp --amp-dtype float16``, dynamic loss scaling):
   ``fp16_train`` steps resnet18 (batch 256) and ViT-B/16 (batch 128)
   from the default scale 65,536 until one lands, then holds three SGD
   steps kernels on against off from that scale (B1–B4 9/8/9/8 and B5–B7
   12/12/12 a step, skipped steps included) and times the float16 step
   beside the bf16 one; ``fp16_cli`` runs the slice's three commands in
   this process (resnet18 at ``--fused-bn auto``, whose probes time the
   float16 kernels; resnet18 ``--accum-steps 2 --fused-bn on``; ViT-B/16
   ``--flash on`` with AdamW): steps land, the checkpoint carries a
   finite ``dynamic_scale``, the parameters move;
6. the measurement dispatch, accumulation and mixing: ``dispatch_auto``
   runs tpudist's own resnet18 and ViT-B/16 commands at full width with
   ``--fused-bn`` and ``--flash`` at their default, ``auto``, and
   ``--accum-steps 2 --mixup-alpha 0.2 --cutmix-alpha 1.0``, twice each
   under a fresh ``TPUDIST_DISPATCH_CACHE``: the first run measures every
   workload (each verdict printed with the kernel's and the plain side's
   ms and the margin), the second reads every verdict from the cache; each
   site that chose the kernel launches it once a microbatch, each that
   chose plain nothing (the probes' launches are counted apart); then
   ViT-B/16 is served with no ``--flash`` flag. ``accum_mixup`` holds
   three steps of two microbatches on mixed batches, kernels on against
   off (the same draws), to the on/off bounds of phases 4 and 5, at
   B1–B4 18/16/18/16 and B5–B7 24/24/24 launches a step;
6b. the doctor and the flight recorder, in this process (``doctor``):
   the guard's cost (resnet18 at batch 256 and ViT-B/16 at batch 32,
   guard on against off, each step between CUDA events); resnet18 through
   the trainer with ``--doctor --blackbox`` and ``nanbomb`` at steps 3–5
   (the skipped step bit-equal in every tensor with B1–B4 9/8/9/8 in it,
   three ``skip_step`` events, a ``persistent_nonfinite`` rollback to the
   seeded state and a 5-step replay; the recorder's dumps and a deep
   capture whose trace holds B1–B4 18/16/18/16); ``lossbomb`` at step 10
   of two epochs (a spike, the rollback to epoch 0's probe-verified-good
   checkpoint, 7 replayed steps); a NaN batch through ViT-B/16 with
   ``--flash on`` (skipped, B5–B7 12/12/12, bit-equal);
7. data-parallel training, world 1 over NCCL: the reference's recipe 3
   through ``python -m tpudist_torch.launch -n 1 -- python -m
   tpudist_torch --distributed``, resnet18 at 224 px, batch 256, float16,
   ``--fused-bn on`` for two epochs of 8 steps, the launcher with
   ``--telemetry-dir --metrics-port 0 --straggler-factor 4`` (its fleet
   endpoint, scraped while the rank trains, shows the world of 1 and rank
   0's heartbeat step, ``/dashboard`` answers, its events hold
   ``launcher_start`` and no ``straggler``; the rank runs
   ``--replica-check-freq 1 --stall-timeout 15``: the replica check's
   world-1 line each epoch, no watchdog fault; the log and
   ``run_start`` name backend nccl, the first step launches B1–B4
   9/8/9/8 times, ``init_s`` > 0, the checkpoint carries a finite
   ``dynamic_scale``; its rank reports its imports); then, in this
   process as rank 0 of a world of 1, a short bf16 ``--sync_batchnorm``
   run (the plain epilogue: no fused-norm launch) and a short float16
   ViT-B/16 ``--flash on`` run (12/12/12 flash launches a step). A
   rank's launch counters start at 0 in its process, and the trainer
   reports them in ``run_end``. Then three steps of the world-1 DDP step
   against the one-card step (bit-equal whenever two one-card runs are)
   and the DDP step's breakdown;
8. checkpoints: ``checkpoint_resume`` takes ``train_ddp``'s run as its
   straight run A and trains resnet18 at its settings again under
   ``--max-restarts 1 --resume auto --overwrite keep`` with
   ``CRASH_WRAPPER``, whose attempt 0 dies after the first epoch's save:
   the launcher restarts once, attempt 1 resumes, B1–B4 launch 9/8/9/8
   times a step in both attempts and the two final checkpoints hold the
   same parameters, BN statistics, momentum, step and loss scale bit for
   bit.
   ``checkpoint_vit`` trains ViT-B/16 (batch 128, AdamW,
   ``--model-ema-decay 0.999``) 2 epochs straight against 1 epoch and a
   ``--resume`` for the second: params, moments, EMA and step bit-equal,
   12/12/12 launches a step; each save and restore is timed beside the
   host RSS it adds. ``serve_checkpoint`` serves ViT-B/16 (the EMA
   weights, 12 flash launches a bucket call) and resnet18 from those runs'
   dirs; the served logits equal an eval forward of the model rebuilt
   from the file. Where a straight and a resumed run are not bit-equal,
   a second straight run measures the run-to-run spread and the resumed
   run is held within 3x of it;
9. ImageFolder data: ``image_decode`` prints what the host offers for
   decoding (PIL, torchvision, ``jpeglib.h``, ``libjpeg.so``, nvJPEG,
   the cores, ``g++``) and the data path the port takes there, building
   the native host kernels (``tpudist_torch/data/csrc``, g++);
   ``imagefolder_corpus`` writes 8 classes × 160 train and 32 val JPEGs
   at 384 px with ``benchmarks/make_synth_imagefolder.py``'s ``render``
   (one writer process a host core)
   and cuts one train JPEG to half its bytes; ``native_vs_plain_host``
   holds the native train and val transforms against the numpy bilinear
   reference and the PIL stack on those images and times each one thread;
   ``loader_rates`` runs the train loader alone at batch 256, 224 px,
   ``-j`` = the cores (at most 32) on the card's path, the PIL stack and
   the PIL stack with ``--auto-augment ra --random-erase 0.25``, and the
   val loader, beside the device-resident resnet18 rate;
   ``train_imagefolder`` trains resnet18 (two epochs, under ``--inject
   decode_fail:p=0.1,fails=1``, which ``decode_fail`` reads) and ViT-B/16
   (one, ``--auto-augment ta_wide --random-erase 0.25``), both in this
   process, from the tree with ``--data-skip-budget 1``:
   B1–B4 9/8/9/8 and B5–B7 12/12/12 a step, the truncated JPEG skipped
   once an epoch and logged, the share of the wall spent waiting for
   data;
10. preemption, fault injection and the reference's files:
   ``preempt_resume`` sends SIGTERM to the launcher of a
   ``checkpoint_resume`` run mid-epoch (the launcher's ``--inject
   slow_peer:ms=1@step=0`` reaches the rank: one ``fault`` event; the
   rank runs ``--blackbox``, the launcher ``--incident-keep 2``: one
   incident bundle holds the rank's ``preempt`` dump and
   ``events.jsonl``): the rank drains, writes its
   emergency checkpoint (a live file whose ``data_cursor`` counts whole
   steps), exits 75, the launcher 130; the same command continues the
   epoch at the cursor and ends where the straight run A ended, with
   9/8/9/8 B1–B4 launches a step in both runs; the emergency save's
   seconds and the drain's are printed. ``faults_on_card``:
   ``checkpoint_corrupt`` on a short resnet18 run's second save (the
   resume quarantines both files, falls back to the history and emits the
   ``fault`` events), ``bitflip`` (one flipped bit in ``bn1.bias[0]``
   against an unflipped twin, the digests apart; a float16 run under
   ``--doctor --doctor-probe-freq 2 --inject bitflip@step=1``: it fires
   once, the world-1 probes see nothing and stamp epoch 0's file good),
   and, on the ImageFolder tree, ``decode_fail:p=0.1,fails=1``
   given to train_imagefolder's resnet18 run (retries, no new skip).
   ``torch_checkpoint``:
   that run's ``checkpoint.pth.tar`` and ``model_best.pth.tar`` (the EMA)
   hold the reference's schema and the run's weights, ``--evaluate`` from
   ``--pretrained-path`` equals ``--evaluate`` from ``--resume``; the
   ViT-B/16 of ``checkpoint_vit`` goes out to a ``.pth.tar`` and back
   into a fresh model with bit-equal logits through B5, two ViT-B/16 steps
   start from that file (B5–B7 12/12/12 a step), and ``--pretrained``
   with an empty ``$TORCH_HOME`` fails, naming where it searched;
11. the BatchNorm+ReLU conv families (in this process, after
   ``fp16_cli``): ``zoo_train`` takes vgg16_bn, densenet121, googlenet,
   inception_v3 (299 px, aux head on), mobilenet_v3_large and
   regnet_y_400mf at full width, bf16, batch 256 through three SGD steps
   kernels on against off, each site launching B1 and B3 once a step (13,
   121, 57, 96, 11 and 33 sites), then times each run's step and reads its
   ``max_memory_allocated``, and holds each model's weights after one f32
   step at batch 64 kernels on against off; ``zoo_cli`` runs ``python -m tpudist_torch -a
   densenet121 --use_amp`` for one 4-step epoch at ``--fused-bn on`` and
   at ``auto`` (a fresh dispatch cache: every workload timed, the
   dispatch's seconds, its verdicts), with launches a step from the
   counters and the host step's data/compute split; ``zoo_breakdown``
   breaks a densenet121 step down by kernel category, B1's and B3's
   device ms beside their bytes bound; none of the three launches the
   scalar fused-norm variant; ``zoo_serve``
   serves each family at bucket 8 against its own eval forward;
   ``zoo_vs_cpu`` runs one f32 train-mode forward and backward of each
   (TF32 off, batch 2, ``--fused-bn on``: B1 and B3 on the card, their
   plain bodies on the CPU, the same weights and dropout masks) on the
   CPU and on the card and holds the loss, logits, BatchNorm statistics
   and every gradient, as ``rest_vs_cpu`` below;
12. the rest of the one-card zoo (in this process, after ``zoo_serve``),
   ten representatives at full width and 224 px with seed-0 weights
   drawn once on the host (``REST_MODELS``: alexnet, squeezenet1_1,
   mnasnet1_0, shufflenet_v2_x1_0, efficientnet_b0, efficientnet_v2_s on
   SGD, convnext_tiny, swin_t, swin_v2_t, maxvit_t on AdamW):
   ``rest_train`` trains each at batch 128 in bf16 for three steps with
   dropout and stochastic depth live (every loss finite, every leaf
   moved, B1–B7 launched 0 times: these families reach no kernel, as in
   tpudist), then times three synchronised steps and reads
   ``max_memory_allocated``; ``rest_vs_cpu`` runs one f32 train-mode
   forward and backward of each (TF32 off, batch 2, the dropout and
   stochastic-depth masks drawn on the host in the CPU run and replayed
   on the card) on the CPU and on the card and holds the loss, logits,
   BatchNorm statistics and every gradient; ``rest_cli`` runs ``python -m
   tpudist_torch -a swin_v2_t --optimizer adamw`` for 3 steps with
   tpudist's defaults (the no-decay group is tpudist's ``no_decay_mask``
   by name; the dispatch records no workload and probes nothing);
   ``rest_serve`` serves the ten at bucket 8 against their eval forward;
13. one ``{"phase_seconds": {...}}`` line, each phase's seconds;
14. one ``{"kernels": [...]}`` line: each kernel in bf16 (its f32 cases
    beside) and its float16 instantiation, `` (float16)`` in the name;
15. last, ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, without a CUDA card or without the
rest of the repository (then one line names the missing sources).
``python3 chip_smoke.py --mutations`` runs only the ``--flash on``/``off``
comparison under in-memory faults of the
backward (dq 10 % off; one key tile's dk and dv dropped), then builds two
faulty copies of the forward kernel (one key tile's contribution to O
dropped; l summed from the rounded P) and holds each against the bf16
forward cases, the served logits on/off and the bf16 training on/off; it
then runs each zoo model with B3 faulted (dx zeroed at one site; one
site's dx and partials zeroed; dx 10 % low at every site) against its
sound ``off`` run under ``zoo_train``'s bounds, and the same faults in the
card's run of ``zoo_vs_cpu`` against the sound CPU under its bounds; it
exits 0 only if every fault breaks a bound.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import hashlib
import io
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

# Run from a checkout: the port and its kernel sources sit beside this file.
_MISSING = [d for d in ("tpudist_torch/", "tpudist_torch/ops/csrc/")
            if not os.path.isdir(os.path.join(
                os.path.dirname(os.path.abspath(__file__)), d))]
if _MISSING:
    print(f"chip_smoke: missing the checkout's sources "
          f"{' and '.join(_MISSING)} beside {os.path.abspath(__file__)}; "
          f"run it from the repo", file=sys.stderr)
    sys.exit(1)

import numpy as np  # noqa: E402
import torch
import torch.nn.functional as F

from tpudist_torch import __main__ as train_cli
from tpudist_torch import checkpoint as ckpt_lib
from tpudist_torch import config as config_lib
from tpudist_torch import data as data_lib
from tpudist_torch import dist as dist_lib
from tpudist_torch import faults
from tpudist_torch import launch as launch_lib
from tpudist_torch import telemetry as telemetry_lib
from tpudist_torch import train as train_lib
from tpudist_torch.compat import torch_checkpoint as torch_ckpt
from tpudist_torch.compat.jax_params import state_dict_from_jax
from tpudist_torch.data import autoaugment as data_aa
from tpudist_torch.data import native as data_native
from tpudist_torch.data import transforms as data_tf
from tpudist_torch.dynamic_scale import DynamicScale
from tpudist_torch.models import create_model
from tpudist_torch.models import layers as model_layers
from tpudist_torch.obs import server as obs_server
from tpudist_torch.ops import _build
from tpudist_torch.ops import flash_attention as fa
from tpudist_torch.ops import fused_norm as fn
from tpudist_torch.ops import mixup
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
# float16's own bounds: float16 resolves 8x finer than bf16, so bf16's 1e-2
# would pass a float16 kernel that rounds P or dS at bf16. O within 1.5e-3
# (the form of F32_TOL; read at 4.9e-4, one float16 ulp below 1, on an
# H100 80GB HBM3 at 700 W), and at most 45 % of O's entries not bit-equal
# to the plain version's (read 0.16-0.28 there). A plain version that
# rounds P and dS at bf16 passes bf16's bound and breaks these, forward
# and backward (tests/test_torch_flash_kernel.py, on the CPU).
F16_TOL = 1.5e-3
F16_O_SHARE = 0.45
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
# The vector variant's edges in bf16 (label, rows, C, offset rows): rows no
# row block divides, the fewest channels (two 16-byte groups), densenet161's
# 2,208 (276 groups: the backward splits them in slices); and rows one
# element past a 16-byte boundary, which take the scalar variant.
NORM_EDGE_SHAPES = [("bf16_ragged_rows", 50_001, 64, False),
                    ("bf16_c16_ragged", 1_001, 16, False),
                    ("bf16_c2208_ragged", 12_345, 2208, False),
                    ("bf16_offset_view", 50_001, 64, True)]
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
CKPT_VIT_SYNTHETIC = 512        # the same in checkpoint_vit's runs
# The backward kernels against their plain version: rtol and atol·max|ref|
# (the bound tests/test_flash_attention.py holds the Pallas backward to).
# float16 at about 3x its readings there: dq, dk, dv within 3.4e-4 of
# max|ref|, and at most 0.85 % of a gradient's entries not bit-equal, held
# to 3 % (BWD_F16_SHARE).
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-3}
BWD_F16_SHARE = 0.03
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

# The command checkpoint_resume's interrupted run launches, written to a
# file: the trainer under runpy, whose attempt 0 prints its optimizer step
# and kernel launches and dies (exit 17) as soon as the first epoch's
# history copy and its sidecar are on disk.
CRASH_WRAPPER = r"""
import json, os, runpy, sys
sys.path.insert(0, os.getcwd())
from tpudist_torch import checkpoint
from tpudist_torch.ops import flash_attention, fused_norm

if os.environ.get("TPUDIST_RESTART_COUNT", "0") == "0":
    save = checkpoint.save_checkpoint

    def save_then_crash(state, is_best, outpath, keep=0):
        path = save(state, is_best, outpath, keep)
        hist = os.path.join(outpath, "checkpoint-ep00001.msgpack")
        if os.path.exists(hist) and os.path.exists(hist + ".sha256"):
            print("CRASH " + json.dumps({
                "step": int(state["state"]["step"]),
                "launches": {**fused_norm.LAUNCHES,
                             **flash_attention.LAUNCHES}}), flush=True)
            os._exit(17)
        return path

    checkpoint.save_checkpoint = save_then_crash
runpy.run_module("tpudist_torch", run_name="__main__", alter_sys=True)
"""


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
    """``flash_fwd_mma<f16,64>``, ``flash_bwd_dq_kernel<f32,64>`` or
    ``bn_act_fwd_kernel<bf16,true>`` from a mangled kernel name; one of
    another form comes back as it is."""
    m = re.search(r"\d+((?:flash|bn)_\w+?_(?:mma|kernel))I(\w+?)EEv",
                  mangled)
    if not m:
        return mangled
    words = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16",
             "Lb0E": "false", "Lb1E": "true"}
    toks = re.finditer(r"f(?=L|$)|13__nv_bfloat16|6__half|Lb[01]E|Li(\d+)E",
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
        raise RuntimeError(f"a 16-bit tensor-core kernel spills: {spills}")
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


# -- phase 1b: a process's start ------------------------------------------------

def _bytecode_cache() -> dict:
    """Point the Python processes this script starts at a bytecode cache
    in the checkout (``build/pycache``, which git ignores). Where the
    interpreter may not write ``__pycache__`` beside its modules (a
    read-only install, or ``PYTHONDONTWRITEBYTECODE``), every process
    compiles torch's sources anew: the first process now writes the cache
    and the others read it. What the host offered is returned."""
    torch_dir = os.path.dirname(torch.__file__)
    out = {"dont_write_bytecode_env": os.environ.get("PYTHONDONTWRITEBYTECODE"),
           "pycache_prefix_env": os.environ.get("PYTHONPYCACHEPREFIX"),
           "torch_dir_writable": os.access(torch_dir, os.W_OK),
           "torch_has_pycache": os.path.isdir(
               os.path.join(torch_dir, "__pycache__"))}
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = os.path.join(HERE, "build", "pycache")
    out["pycache_prefix"] = os.environ["PYTHONPYCACHEPREFIX"]
    return out


def phase_startup() -> dict:
    """The bytecode cache every later process uses (``_bytecode_cache``).
    The first launch (``train_ddp``) fills it; every launch reports where
    its seconds went (``timing``), so the first shows a cold start and the
    rest a warm one."""
    out = {"phase": "startup", **_bytecode_cache()}
    emit(out)
    return out


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
    # float16 (--amp-dtype float16) through the same tensor-core kernel, at
    # every bf16 shape.
    *[(f"f16_serve_b{b}", b, SERVE_T, SERVE_T, SERVE_H, SERVE_D,
       torch.float16, False) for b in BUCKETS],
    (f"f16_train_b{VIT_B}", VIT_B, SERVE_T, SERVE_T, SERVE_H, SERVE_D,
     torch.float16, False),
    ("f16_d80", 2, 257, 257, 16, 80, torch.float16, False),
    ("f16_causal_cross", 2, 150, 197, 4, 64, torch.float16, True),
    ("f16_d32_masked_rows", 2, 100, 60, 3, 32, torch.float16, True),
]


def _close(got, want, tol):
    """Whether |got − want| <= tol + tol·|want| everywhere (the form of
    torch.testing.assert_close with rtol = atol = tol)."""
    return bool(((got - want).abs() <= tol + tol * want.abs()).all())


def _fwd_tol(dtype) -> float:
    return {torch.float32: F32_TOL, torch.bfloat16: BF16_TOL,
            torch.float16: F16_TOL}[dtype]


def _fwd_check(q, k, v, causal) -> tuple[dict, list[str]]:
    """The forward kernel against its plain version on one input: the
    errors and bit-equality shares of O and lse, and what breaks its
    bounds (none: []): o within 2e-5 (f32), 1e-2 (bf16) or 1.5e-3
    (float16, with at most F16_O_SHARE of O not bit-equal), lse within
    2e-5 (F32_TOL, BF16_LSE_TOL: in float16 too only the order of the f32
    sums differs), two launches bit-identical, and rows that see no key
    O = 0 and lse = -1e30 exactly."""
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal=causal)
    half = q.dtype != torch.float32
    tol = _fwd_tol(q.dtype)
    of, rf = o.float(), o_ref.float()
    bad = []
    if not _close(of, rf, tol):
        bad.append(f"o off by {(of - rf).abs().max().item()} (tol {tol})")
    o_share = (o != o_ref).float().mean().item()
    if q.dtype == torch.float16 and o_share > F16_O_SHARE:
        bad.append(f"{o_share:.3f} of o not bit-equal (at most "
                   f"{F16_O_SHARE})")
    lse_tol = BF16_LSE_TOL if half else F32_TOL
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
           "o_not_bit_equal_share": o_share,
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
        tol = _fwd_tol(dtype)
        row = {"case": label, "shape": [b, tq, tk, h, d],
               "dtype": str(dtype).replace("torch.", ""), "causal": causal,
               "tol": tol, **checked}
        nbytes, flops = _work(q, k, v, causal)
        rate = peaks["f32" if dtype == torch.float32 else "bf16"]
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
    out = {"phase": "kernel_vs_plain", "kernel": "flash_fwd", "cases": rows,
           "nonfinite": _nonfinite_fwd()}
    emit(out)
    return out


def _nonfinite_share(got, want) -> dict:
    """Where ``got`` and its plain version ``want`` are non-finite: the
    plain version's NaN and inf counts, the entries finite in one and not
    in the other (``pattern_mismatches``, which must be 0), the entries
    whose class differs (NaN in one, inf in the other: a 0·inf in one sum
    that is p·inf in the other), and the largest difference where both are
    finite."""
    g, w = got.float(), want.float()
    fin_g, fin_w = torch.isfinite(g), torch.isfinite(w)
    both = fin_g & fin_w
    return {"nan": int(torch.isnan(w).sum()), "inf": int(torch.isinf(w).sum()),
            "pattern_mismatches": int((fin_g != fin_w).sum()),
            "class_differs": int((torch.isnan(g) != torch.isnan(w)).sum()),
            "finite_max_abs_err": float((g[both] - w[both]).abs().max())
            if both.any() else 0.0}


def _planted(t, seed, frac=1e-3):
    """``t`` with about ``frac`` of its entries set to +inf, -inf and NaN
    (a third each), at seeded positions."""
    g = torch.Generator(device=t.device).manual_seed(seed)
    u = torch.rand(t.shape, generator=g, device=t.device)
    t = t.clone()
    t[u < frac / 3] = float("inf")
    t[(u >= frac / 3) & (u < 2 * frac / 3)] = float("-inf")
    t[(u >= 2 * frac / 3) & (u < frac)] = float("nan")
    return t


def _nonfinite_fwd() -> dict:
    """B5 in float16 with inf and NaN planted in v and in one query row:
    O and lse are non-finite exactly where the plain version's are."""
    b, t, h, d = 2, SERVE_T, 4, SERVE_D
    q, k, v = _qkv_views(b, t, t, h, d, torch.float16, seed=90)
    v = _planted(v, 91)
    q = q.clone()
    q[0, 5, 1, 3] = float("inf")
    o, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v)
    out = {"shape": [b, t, t, h, d], "dtype": "float16",
           "o": _nonfinite_share(o, o_ref),
           "lse": _nonfinite_share(lse, lse_ref)}
    if out["o"]["pattern_mismatches"] or out["lse"]["pattern_mismatches"] \
            or not out["o"]["nan"] + out["o"]["inf"]:
        raise RuntimeError(f"flash_fwd float16 with inf/NaN: the kernel's "
                           f"non-finite outputs differ from the plain "
                           f"version's: {out}")
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


def phase_serve_resnet() -> dict:
    """``python -m tpudist_torch.serve`` with its default arch, resnet18, at
    224 px in bf16 for 1.5 s of load: eval-mode BatchNorm takes the plain
    epilogue, so no kernel of the port is launched. ``--metrics-port 0``:
    its endpoint, scraped as it closes (after ``run_end``), counts the
    requests the summary served."""
    outdir = tempfile.mkdtemp(prefix="tpudist_torch_serve_r18_")
    argv = ["--image-size", "224", "--buckets", "1,8", "--load-rate", "20",
            "--load-duration", "1.5", "--seed", "0", "--telemetry",
            "--metrics-port", "0", "--outpath", outdir]
    fa.reset_counts()
    fn.reset_counts()
    buf = io.StringIO()
    final: list = []
    close = obs_server.MetricsServer.close

    def scrape_then_close(srv):
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics",
                                    timeout=5) as r:
            final.append(_prom(r.read().decode()))
        close(srv)

    obs_server.MetricsServer.close = scrape_then_close
    try:
        with contextlib.redirect_stdout(buf):
            rc = serve_cli.main(argv)
    finally:
        obs_server.MetricsServer.close = close
    launches = {**fa.LAUNCHES, **fn.LAUNCHES}
    text = buf.getvalue()
    print(text, end="", flush=True)
    summary = json.loads(next(ln for ln in text.splitlines()
                              if ln.startswith("SERVE_SUMMARY "))
                         .split(" ", 1)[1])
    scraped = final[0] if final else {}
    if rc != 0 or summary["arch"] != "resnet18" \
            or summary.get("n_errors", 1) != 0 \
            or not summary.get("n_requests") or any(launches.values()) \
            or scraped.get("tpudist_serve_requests_total") \
            != summary["n_requests"]:
        raise RuntimeError(f"serving resnet18: exit {rc}, {summary}, "
                           f"kernel launches {launches}, scraped {scraped}")
    with open(telemetry_lib.events_path(outdir, 0)) as f:
        events = [json.loads(ln) for ln in f]
    for ev in events:
        telemetry_lib.validate_event(ev)
    if events[-1]["type"] != "run_end":
        raise RuntimeError(f"serving resnet18 wrote no run_end: {events[-1]}")
    out = {"phase": "serve_resnet18", "arch": "resnet18", "image_size": 224,
           "dtype": "bfloat16", "summary": summary,
           "kernel_launches": launches,
           "metrics": {k: v for k, v in scraped.items()
                       if k.startswith("tpudist_serve_")}}
    emit(out)
    return out


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


def _norm_bytes(kernel: str, m: int, c: int, elt: int) -> int:
    """Bytes a fused-norm kernel must move at (m, c) rows of ``elt``-byte
    elements, each input read once and each output written once: x (and
    r) read and y written forward; x, dy (and r) read and dx (and dr)
    written backward, with its (ceil(M/rows), C) f32 partials of g·x and
    g; a and b read as (C,) f32."""
    res = kernel.endswith("_res")
    if kernel.startswith("bn_act_fwd"):
        return (3 if res else 2) * m * c * elt + 2 * c * 4
    nm = -(-m // fn.BWD_BLOCK_ROWS)
    return (5 if res else 3) * m * c * elt + 2 * c * 4 + 2 * nm * c * 4


def _norm_case(label, m, c, dtype, peaks, seed, variants=(False, True),
               offset=False):
    """The epilogue kernels at one (M, C), the plain (B1, B3) and with
    ``variants`` the residual ones (B2, B4) too: each against its plain
    version (y, dx and dr bit for bit: both round x·a and + b separately
    and g·a once; the partials and their sums within F32_SUM_TOL·(1 +
    Σ|term|)), timed beside the plain version, with the card's bound for
    the function's bytes and operations and the kernel's share of it.
    Each launch must take the variant the operands call for (``vector``
    where C is a multiple of the elements in 16 bytes, ``scalar``
    otherwise and for ``offset`` rows, which start one element past a
    16-byte boundary). The looser ``20·tol·(1 + max|ref|)`` of
    ``tests/test_fused_norm.py`` is printed beside."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(m, c):
        t = torch.randn(m * c + offset, generator=g, device="cuda").to(dtype)
        return t[int(offset):].view(m, c)

    x, dy = rand(m, c), rand(m, c)
    r = rand(m, c) if True in variants else None
    a, b = (torch.randn(c, generator=g, device="cuda") for _ in range(2))
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    elt = x.element_size()
    want_var = ("scalar" if offset or c % (fn.VEC_BYTES // elt)
                else "vector")
    large = m * c > 10_000_000
    rows = {}
    for res in variants:
        rr = r if res else None
        before = fn.VARIANT_LAUNCHES[want_var]
        y = fn.bn_act_fwd(x, rr, a, b)
        dx, dr, da_p, db_p = fn.bn_act_bwd(x, rr, dy, a, b)
        torch.cuda.synchronize()
        if fn.VARIANT_LAUNCHES[want_var] != before + 2:
            raise RuntimeError(f"{label} res={res}: the {want_var} variant "
                               f"did not launch ({fn.VARIANT_LAUNCHES})")
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
        for name, fwd in (("bn_act_fwd_res" if res else "bn_act_fwd", True),
                          ("bn_act_bwd_res" if res else "bn_act_bwd", False)):
            nbytes = _norm_bytes(name, m, c, elt)
            if fwd:
                kern = lambda: fn.bn_act_fwd(x, rr, a, b)  # noqa: E731
                plain = lambda: fn.bn_act_fwd_plain(  # noqa: E731
                    x, rr, a, b)
                err = y_err
            else:
                kern = lambda: fn.bn_act_bwd(x, rr, dy, a, b)  # noqa: E731
                plain = lambda: fn.bn_act_bwd_plain(  # noqa: E731
                    x, rr, dy, a, b)
                err = max(bwd_err.values())
            ops = NORM_OPS[name] * m * c
            t_bytes = nbytes / peaks["hbm"] * 1e3
            t_ops = ops / peaks["f32"] * 1e3
            kernel_ms = time_ms(kern)
            rows[name] = {
                "case": label, "shape": [m, c], "variant": want_var,
                "dtype": str(dtype).replace("torch.", ""), "tol": tol,
                "max_abs_err": err, "errors": bwd_err if not fwd else
                {"y": y_err}, "sum_tol": F32_SUM_TOL,
                "bound_20tol": issue_bound if not fwd else None,
                "bytes": nbytes, "ops": ops,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "kernel_ms": kernel_ms,
                "bound_share": max(t_bytes, t_ops) / kernel_ms,
                "plain_ms": time_ms(plain, reps=5 if large else 25,
                                    inner=2 if large else 10),
                # No one PyTorch call computes relu(x·a + b) with this
                # rounding (or its backward with per-block partials).
                "library_ms": None}
    return rows


def _nonfinite_norm() -> dict:
    """B1–B4 in float16 with inf and NaN planted in x, r and dy, and an
    affine that overflows float16 (x·a + b past 65504) on a few channels:
    y, dx and dr equal the plain version's bit for bit, NaN for NaN, and
    every partial is non-finite exactly where the plain one is."""
    m, c = 25_088, 256
    g = torch.Generator(device="cuda").manual_seed(80)
    x, r, dy = (_planted(torch.randn(m, c, generator=g, device="cuda")
                         .half(), 81 + i) for i in range(3))
    a = torch.randn(c, generator=g, device="cuda")
    b = torch.randn(c, generator=g, device="cuda")
    a[:4] = 3.0e4                          # |x·a| past 65504 where |x| > 2.2
    out = {"shape": [m, c], "dtype": "float16"}
    for res in (False, True):
        rr = r if res else None
        got = (fn.bn_act_fwd(x, rr, a, b), *fn.bn_act_bwd(x, rr, dy, a, b))
        torch.cuda.synchronize()
        want = (fn.bn_act_fwd_plain(x, rr, a, b),
                *fn.bn_act_bwd_plain(x, rr, dy, a, b))
        row = {}
        for name, gv, wv in zip(("y", "dx", "dr", "da_partials",
                                 "db_partials"), got, want):
            if wv is None:
                continue
            row[name] = _nonfinite_share(gv, wv)
            # y, dx, dr: the same bits wherever the plain value is not
            # NaN, and NaN wherever it is (a NaN's payload is the
            # conversion's, not the data's).
            exact = name in ("y", "dx", "dr")
            nan = torch.isnan(wv)
            if row[name]["pattern_mismatches"] or (exact and not (
                    torch.equal(nan, torch.isnan(gv)) and torch.equal(
                        gv.view(torch.int16)[~nan],
                        wv.view(torch.int16)[~nan]))):
                raise RuntimeError(f"fused-norm float16 res={res} with "
                                   f"inf/NaN: {name} differs from the plain "
                                   f"version ({row[name]})")
        if not row["y"]["inf"] or not row["dx"]["nan"] + row["dx"]["inf"]:
            raise RuntimeError(f"fused-norm float16 non-finite case planted "
                               f"nothing that shows: {row}")
        out["residual" if res else "plain"] = row
    return out


def phase_fused_norm_vs_plain(peaks: dict) -> dict:
    cases = [(label, m, c, torch.bfloat16) for label, m, c in RESNET18_SHAPES]
    cases += [(label, m, c, torch.float32) for label, m, c in ODD_SHAPES]
    cases += [(label, m, c, torch.float16) for label, m, c in RESNET18_SHAPES]
    rows = []
    for i, (label, m, c, dtype) in enumerate(cases):
        for name, row in _norm_case(label, m, c, dtype, peaks, i).items():
            rows.append(dict(row, kernel=name))
    # The new families' shapes feed B1 and B3 alone.
    for i, (label, m, c) in enumerate(ZOO_SHAPES):
        for name, row in _norm_case(label, m, c, torch.bfloat16, peaks,
                                    200 + i, variants=(False,)).items():
            rows.append(dict(row, kernel=name))
        torch.cuda.empty_cache()
    for i, (label, m, c, offset) in enumerate(NORM_EDGE_SHAPES):
        for name, row in _norm_case(label, m, c, torch.bfloat16, peaks,
                                    300 + i, offset=offset).items():
            rows.append(dict(row, kernel=name))
    out = {"phase": "fused_norm_vs_plain", "cases": rows,
           "nonfinite": _nonfinite_norm(),
           "library_ms": "null: no single PyTorch call computes the "
                         "epilogue with its rounding, or its backward "
                         "with per-block partials"}
    emit(out)
    return out


# -- phase 4: training end to end ---------------------------------------------

def _epoch_losses(text: str, kind: str) -> list[float]:
    return [float(ln.split("Loss ")[1].split()[0]) for ln in text.splitlines()
            if ln.startswith(f"||==> {kind}: Epoch[")]


# The observability flags of the resnet18 run (``train``, ``observe``): a
# cap its ≈ 6 KB of events overflow once, and a trace window of two steps
# clear of the first (which builds and warms up).
OBSERVE_MAX_MB = 0.004
OBSERVE_WINDOW = (3, 5)
NORM_KERNEL_RE = re.compile(r"bn_act_(fwd|bwd)_(?:vec_)?kernel<[^,>]+,\s*"
                            r"(true|false)>")


def _scrape_while(outdir: str, rank, stop: threading.Event,
                  scrapes: list) -> None:
    """Scrape the rank's ``/metrics`` (found through its port file) every
    0.2 s until ``stop``: ``(t_before, t_after, text)`` each. The scraper
    shares the trainer's process (and its interpreter lock), so it scrapes
    at about a step's pace, not faster."""
    portfile = os.path.join(outdir, f"metrics.{rank}.port")
    while not stop.is_set():
        try:
            with open(portfile) as f:
                port = int(f.read())
            t0 = time.time()
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                        timeout=2) as r:
                text = r.read().decode()
            scrapes.append((t0, time.time(), text))
        except (OSError, ValueError):
            pass
        stop.wait(0.2)


def _prom(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, val = line.rsplit(" ", 1)
            out[key] = float(val)
    return out


def _trace_norm_launches(path: str, steps: range) -> dict:
    """B1–B4 in a Chrome trace of ``torch.profiler``: the kernels' total
    count by name, and, where the trace ties each kernel to its launch
    (``correlation``), the count inside each ``train`` range."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("name") == "train"
                    and e.get("cat") == "user_annotation")
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    total = dict.fromkeys(fn.KERNELS, 0)
    per_step = [dict.fromkeys(fn.KERNELS, 0) for _ in ranges]
    unattributed = 0
    for e in events:
        m = NORM_KERNEL_RE.search(e.get("name", "")) \
            if e.get("cat") == "kernel" else None
        if not m:
            continue
        name = f"bn_act_{m.group(1)}" + ("_res" if m.group(2) == "true"
                                         else "")
        total[name] += 1
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        hit = [i for i, (a, b) in enumerate(ranges)
               if ts is not None and a <= ts <= b]
        if hit:
            per_step[hit[0]][name] += 1
        else:
            unattributed += 1
    return {"train_ranges": len(ranges), "steps": list(steps),
            "train_range_ms": [(b - a) / 1e3 for a, b in ranges],
            "total": total, "per_step": per_step,
            "unattributed": unattributed,
            "kernel_events": sum(e.get("cat") == "kernel" for e in events),
            "mb": os.path.getsize(path) / 2**20}


def _observe(outdir: str, events: list, scrapes: list, steps: list,
             text: str) -> dict:
    """The observability of the ``train`` run (``--metrics-port 0
    --telemetry-max-mb OBSERVE_MAX_MB --profile 3:5``): each scrape of
    ``/metrics`` agrees with the step events written around it (one step
    of slack for a scrape between an event and its gauge), the rotated
    and live event files together hold every step, and the window's trace
    holds B1–B4 9/8/9/8 times in each of its two ``train`` ranges and no
    other launch of them. Reported, not bounded: the step p50 inside and
    outside the window, the ``train`` range's p50, the trace's MB."""
    bad = []
    if "=> live metrics on :" not in text:
        bad.append("no '=> live metrics on :' line")
    if os.path.exists(os.path.join(outdir, "metrics.0.port")):
        bad.append("the port file outlived the run")
    seen = [(t0, t1, _prom(s)) for t0, t1, s in scrapes
            if "tpudist_last_step" in s]
    worst = 0
    for t0, t1, m in seen:
        lo = sum(e["t"] < t0 for e in steps)
        hi = sum(e["t"] <= t1 for e in steps)
        n = int(m["tpudist_steps_total"])
        worst = max(worst, lo - n)
        if not lo - 1 <= n <= hi or \
                m["tpudist_last_step"] != steps[n - 1]["step"]:
            bad.append(f"a scrape read steps_total {n}, last_step "
                       f"{m['tpudist_last_step']} where the events held "
                       f"{lo}..{hi} steps")
            break
    if not seen:
        bad.append("no scrape saw a completed step")
    rotated = os.path.join(outdir, "events.0.1.jsonl")
    if not os.path.exists(rotated):
        bad.append(f"no rotated event file at --telemetry-max-mb "
                   f"{OBSERVE_MAX_MB}")
    if sorted(e["step"] for e in steps) != list(range(16)):
        bad.append(f"the event files hold steps "
                   f"{sorted(e['step'] for e in steps)}")
    a, b = OBSERVE_WINDOW
    traces = sorted(os.listdir(os.path.join(outdir, "profile",
                                            "attempt_0")))
    trace = {}
    if traces != [f"steps{a}-{b - 1}.pt.trace.json"]:
        bad.append(f"traces {traces}")
    else:
        trace = _trace_norm_launches(os.path.join(
            outdir, "profile", "attempt_0", traces[0]), range(a, b))
        want = {k: v * (b - a) for k, v in R18_PER_STEP.items()}
        per = [dict(R18_PER_STEP)] * (b - a)
        if trace["train_ranges"] != b - a or trace["total"] != want \
                or trace["unattributed"] or trace["per_step"] != per:
            bad.append(f"the trace: {trace}")
    in_w = [e["step_s"] for e in steps if a <= e["step"] < b]
    out_w = [e["step_s"] for e in steps[1:] if not a <= e["step"] < b]
    out = {"phase": "observe", "metrics_scrapes": len(scrapes),
           "scrapes_with_steps": len(seen), "scrape_lag_steps_max": worst,
           "rotated_bytes": os.path.getsize(rotated)
           if os.path.exists(rotated) else None,
           "live_bytes": os.path.getsize(telemetry_lib.events_path(
               outdir, 0)),
           "max_mb": OBSERVE_MAX_MB, "trace": trace,
           "step_s_p50_in_window": statistics.median(in_w) if in_w else None,
           "step_s_p50_outside_window": statistics.median(out_w),
           "train_range_ms_p50": statistics.median(
               trace["train_range_ms"]) if trace.get("train_range_ms")
           else None,
           "trace_mb": trace.get("mb")}
    emit(out)
    if bad:
        raise RuntimeError("observe: " + "; ".join(bad))
    return out


def phase_train() -> dict:
    """resnet18 through ``python -m tpudist_torch`` at full width with the
    observability flags (``_observe`` holds them)."""
    outdir = os.path.join(tempfile.mkdtemp(prefix="tpudist_torch_train_"),
                          "run")
    argv = ["--synthetic", "-a", "resnet18", "--image-size", str(TRAIN_PX),
            "--num-classes", "1000", "-b", str(TRAIN_B), "--epochs", "2",
            "--use_amp", "--fused-bn", "on", "--telemetry", "--seed", "0",
            "--outpath", outdir, "--synthetic-size", "2048", "--step", "1",
            "-p", "4", "--metrics-port", "0", "--telemetry-max-mb",
            str(OBSERVE_MAX_MB), "--profile",
            "{}:{}".format(*OBSERVE_WINDOW)]
    buf = io.StringIO()
    fn.reset_counts()
    scrapes: list = []
    stop = threading.Event()
    scraper = threading.Thread(target=_scrape_while,
                               args=(outdir, 0, stop, scrapes), daemon=True)
    scraper.start()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = train_cli.main(argv)
    finally:
        stop.set()
        scraper.join(timeout=10)
    wall_s = time.perf_counter() - t0
    launches, relayouts = dict(fn.LAUNCHES), fn.RELAYOUTS
    variants = dict(fn.VARIANT_LAUNCHES)
    text = buf.getvalue()
    print(text, end="", flush=True)
    if rc != 0 or not text.splitlines()[-1].startswith("best_acc1="):
        raise RuntimeError(f"python -m tpudist_torch exited {rc}")
    if variants["scalar"]:
        raise RuntimeError(f"train: the scalar fused-norm variant launched "
                           f"({variants})")
    events = []
    for path in (os.path.join(outdir, "events.0.1.jsonl"),
                 telemetry_lib.events_path(outdir, 0)):
        if os.path.exists(path):
            with open(path) as f:
                events += [json.loads(ln) for ln in f]
    for ev in events:
        telemetry_lib.validate_event(ev)
    steps = [e for e in events if e["type"] == "step"]
    observe = _observe(outdir, events, scrapes, steps, text)
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
    shutil.rmtree(os.path.dirname(outdir), ignore_errors=True)
    out = {"phase": "train", "arch": "resnet18", "image_size": TRAIN_PX,
           "batch": TRAIN_B, "dtype": "bfloat16", "wall_s": wall_s,
           "train_steps": n, "fused_norm_launches": launches,
           "variant_launches": variants,
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
                                           "data_wait_s", "eval_s",
                                           "checkpoint_s")}}
    emit(out)
    out["observe"] = observe
    return out


def _scaler(dtype, scale=None):
    """A float16 step's loss scale (flax's default 65,536 unless
    ``scale``); None for the other dtypes."""
    if dtype != torch.float16:
        return None
    return DynamicScale() if scale is None else DynamicScale(scale=scale)


# Seed-0 f32 weights, drawn once on the host for each (arch, shape
# arguments) and loaded by every run of that model: the draw does not
# depend on the compute dtype or the kernels, and takes seconds for
# ViT-B/16, googlenet and inception_v3 (torch's truncated normal).
_WEIGHTS: dict = {}


def _seed0_weights(arch: str, **shape) -> dict:
    key = (arch, tuple(sorted(shape.items())))
    if key not in _WEIGHTS:
        model = create_model(arch, dtype=torch.float32, **shape)
        model.reset_parameters(torch.Generator().manual_seed(0))
        _WEIGHTS[key] = {k: v.clone() for k, v in model.state_dict().items()}
    return _WEIGHTS[key]


def _train_setup(fused: bool, dtype=torch.bfloat16, seed: int = 0,
                 ddp: bool = False, scaler=None):
    """resnet18 at TRAIN_B and its train step; with ``ddp`` the step is the
    data-parallel one (the process group must be up); in float16 the step
    scales its loss by ``scaler`` (flax's default when None)."""
    cfg = config_lib.Config(batch_size=TRAIN_B, image_size=TRAIN_PX,
                            fused_bn="on" if fused else "off")
    model = create_model("resnet18", dtype=dtype, fused_bn=fused)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.cuda()
    net = (train_lib.data_parallel(model, torch.device("cuda", 0)) if ddp
           else model)
    opt = train_lib.make_optimizer(model, cfg)
    step = train_lib.make_train_step(net, opt, cfg,
                                     scaler=scaler or _scaler(dtype))
    step.optimizer = opt
    return model, step


def _leaves(model) -> dict:
    return {k: v.detach().float().clone()
            for k, v in model.state_dict().items()}


def _device_batch(seed: int, batch: int = TRAIN_B, px: int = TRAIN_PX):
    g = torch.Generator(device="cuda").manual_seed(seed)
    images = torch.randn(batch, px, px, 3, generator=g, device="cuda")
    labels = torch.randint(0, 1000, (batch,), generator=g, device="cuda")
    return images, labels


def _steps(setup, on: bool, dtype, batches, lr: float, scale=None,
           timed: int = 0, patch=contextlib.nullcontext) -> dict:
    """One run of ``compare_on_off``: ``setup(on, dtype)``, then a train
    step on each batch inside ``patch()``: the losses, whether each step
    landed, the leaves at the start, after the first step and after the
    last, the kernel launches, and with ``timed`` the synchronised wall
    (median of that many more steps on the last batch) and the
    ``max_memory_allocated``."""
    torch.cuda.reset_peak_memory_stats()
    model, step = (setup(on, dtype) if dtype != torch.float16
                   else setup(on, dtype, scaler=_scaler(dtype, scale)))
    run = {"init": _leaves(model), "losses": [], "landed": []}
    before = {**fn.LAUNCHES, **fa.LAUNCHES}
    with patch():
        for i, (x, y) in enumerate(batches):
            m = step(x, y, lr)
            run["losses"].append(float(m["loss"]))
            run["landed"].append(bool(m.get("finite", True)))
            if i == 0:
                run["first"] = _leaves(model)
    run["last"] = _leaves(model)
    run["launches"] = {k: v - before[k] for k, v in {
        **fn.LAUNCHES, **fa.LAUNCHES}.items() if v != before[k]}
    if timed:
        times = []
        for _ in range(timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(*batches[-1], lr)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        run["wall"] = statistics.median(times)
        run["peak"] = torch.cuda.max_memory_allocated() / 1e9
    del model, step
    return run


def _on_off_row(on: dict, off: dict, dtype) -> dict:
    """Two ``_steps`` runs from one seed compared: the losses; per
    parameter and running statistic after the first step, the difference
    over the off run's change, as max|on − off| / max|Δoff| (and after the
    last step, reported only) and as ‖on − off‖₂ / ‖Δoff‖₂ (its median
    over every leaf, its largest over the weights: the leaves of two or
    more dimensions); and the leaves that the off run moved and the on run
    left unmoved."""
    init = off["init"]

    def ratios(key, order):
        out = {}
        for k, want in off[key].items():
            change = torch.linalg.vector_norm(want - init[k], order).item()
            out[k] = torch.linalg.vector_norm(
                on[key][k] - want, order).item() / max(change, 1e-30)
        return out

    ratio = ratios("first", float("inf"))
    drift = ratios("last", float("inf"))
    l2 = ratios("first", 2)
    weights = {k: v for k, v in l2.items() if init[k].ndim >= 2}
    worst, worst_l2 = max(ratio, key=ratio.get), max(l2, key=l2.get)
    worst_w = max(weights, key=weights.get)
    return {"dtype": str(dtype).replace("torch.", ""),
            "landed_on": on["landed"], "landed_off": off["landed"],
            "launches_on": on["launches"],
            "losses_on": on["losses"], "losses_off": off["losses"],
            "loss_abs_diff": [abs(a - b) for a, b in zip(on["losses"],
                                                          off["losses"])],
            "state_ratio_max": ratio[worst], "state_ratio_worst_leaf": worst,
            "state_ratio_median": statistics.median(ratio.values()),
            "state_ratio_max_after_last_step": max(drift.values()),
            "state_l2_ratio_max": l2[worst_l2],
            "state_l2_ratio_worst_leaf": worst_l2,
            "state_l2_ratio_median": statistics.median(l2.values()),
            "weight_l2_ratio_max": weights[worst_w],
            "weight_l2_ratio_worst_leaf": worst_w,
            "unmoved_on": [k for k, v in on["first"].items()
                           if torch.equal(v, init[k])
                           and not torch.equal(off["first"][k], init[k])],
            **({"step_ms_p50": {"on": on["wall"], "off": off["wall"]},
                "max_memory_allocated_gb": {"on": on["peak"],
                                            "off": off["peak"]}}
               if "wall" in on else {})}


def _cmp_batches(batch: int, px: int = TRAIN_PX,
                 steps: int = TRAIN_CMP_STEPS) -> list:
    return [_device_batch(100 + i, batch, px) for i in range(steps)]


def compare_on_off(setup, dtype, batch: int, lr: float,
                   scale=None, px: int = TRAIN_PX, timed: int = 0) -> dict:
    """TRAIN_CMP_STEPS train steps with the kernels on (``setup(True,
    dtype)``) and off from one seed on the same device batches of ``px``
    images, compared by ``_on_off_row``, with the kernel launches of the
    ``on`` run. In float16 both runs start from the loss scale ``scale``,
    and whether each step landed is reported. With ``timed``, each run
    then times that many more steps on its last batch (synchronised wall,
    median) and reports its ``max_memory_allocated``."""
    batches = _cmp_batches(batch, px)
    on = _steps(setup, True, dtype, batches, lr, scale, timed)
    off = _steps(setup, False, dtype, batches, lr, scale, timed)
    return _on_off_row(on, off, dtype)


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
    if "nccl" in n:
        return "nccl_all_reduce"
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


def _fused_norm_device_ms(prof, n: int) -> dict:
    """Device ms a step of each fused-norm kernel (B1–B4), summed over its
    launches at every shape, from a torch.profiler window over ``n``
    steps; None where the profiler saw no device time."""
    out = dict.fromkeys(fn.KERNELS, 0.0)
    for e in prof.key_averages():
        m = re.search(r"bn_act_(fwd|bwd)_(?:vec_)?kernel<[^,>]+,\s*"
                      r"(true|false)>", e.key)
        if not m or getattr(e, "device_type", None) \
                != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        name = f"bn_act_{m.group(1)}" + ("_res" if m.group(2) == "true"
                                         else "")
        out[name] += us / 1e3 / n
    return out if any(out.values()) else None


def phase_train_breakdown(ddp: bool = False) -> dict:
    """One resnet18 train step (batch 256, 224 px, bf16, --fused-bn on)
    on a device-resident batch: synchronised wall (median of 15),
    images/s, device busy time by category (torch.profiler over 3 steps),
    the idle share, kernels a step, each fused-norm kernel's device ms a
    step and the fused backward's re-layouts. With ``ddp`` the step is the
    world-1 data-parallel one (DDP's reducer, the buffer and metric
    all-reduces)."""
    _, step = _train_setup(True, ddp=ddp)
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
    launches = {k: v / n for k, v in fn.LAUNCHES.items()}
    by_cat, kernels = _device_kernels(prof, n, _train_category)
    by_kernel = _fused_norm_device_ms(prof, n)
    busy = sum(by_cat.values())
    out = {"phase": "train_step_breakdown", "arch": "resnet18",
           "batch": TRAIN_B, "image_size": TRAIN_PX, "dtype": "bfloat16",
           "fused_bn": "on", "ddp": ddp, "wall_ms_p50": wall,
           "wall_ms_min": min(walls), "images_per_s": TRAIN_B / wall * 1e3,
           "device_busy_ms": busy if busy else "not measured",
           "idle_share": 1.0 - busy / wall if busy else "not measured",
           "by_category_ms": by_cat or "not measured",
           "kernel_launches_per_step": sum(k["calls"] for k in kernels),
           "fused_norm_launches_per_step": launches,
           "fused_norm_device_ms_per_step": by_kernel or "not measured",
           "relayouts_per_step": relayouts,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "top_kernels": kernels[:20]}
    emit(out)
    return out


# -- phase 6: data-parallel training (world 1 over NCCL) ---------------------

DDP_LINE = ("=> data-parallel: world 1, backend nccl, DDP (buffers averaged "
            "after the step)")
# train_ddp's rank runs --replica-check-freq 1 and a stall watchdog of
# this many seconds: under the rank's start (imports, model, kernels)
# and above its slowest unit of progress (a checkpoint save).
DDP_STALL_TIMEOUT_S = 15
REPLICA_SKIP_LINE = ("replica consistency check skipped: no replicated "
                     "leaves (single device or fully sharded state)")


FLEET_RE = re.compile(r"fleet metrics on :(\d+)")


def _scrape_fleet(port: int, proc, got: dict) -> None:
    """Scrape the launcher's fleet ``/metrics`` every 0.25 s while its rank
    runs, until one shows the world of 1 and rank 0's heartbeat step; then
    fetch ``/dashboard`` once."""
    url = f"http://127.0.0.1:{port}"
    while proc.poll() is None:
        try:
            with urllib.request.urlopen(f"{url}/metrics", timeout=2) as r:
                text = r.read().decode()
        except OSError:
            text = ""
        got["scrapes"] = got.get("scrapes", 0) + 1
        if "tpudist_fleet_nprocs 1" in text \
                and 'tpudist_rank_last_step{rank="0"}' in text:
            got["metrics"] = {k: v for k, v in _prom(text).items()
                              if k.startswith(("tpudist_fleet_",
                                               "tpudist_rank_",
                                               "tpudist_straggler",
                                               "tpudist_world_size"))}
            with urllib.request.urlopen(f"{url}/dashboard", timeout=5) as r:
                page = r.read().decode()
            got["dashboard"] = {"status": r.status, "bytes": len(page),
                                "html": page.startswith("<!doctype html>")}
            return
        time.sleep(0.25)


def _launch_trainer(args: list[str], what: str, timeout: float = 300.0, *,
                    outdir: str | None = None, trainer: list | None = None,
                    launch_args: tuple = ()):
    """``python -m tpudist_torch.launch -n 1 [LAUNCH_ARGS] -- python -m
    tpudist_torch --distributed ARGS --telemetry``: its output (printed), a
    summary of its rank-0 events (each validated) and the events. The
    wrappers' launch counters start at 0 in the rank's process; the trainer
    reports them in ``run_end``. ``trainer`` replaces ``-m tpudist_torch``
    (a script); the run dir is removed after unless ``outdir`` is given.
    The launcher's stderr is read as it comes: where it announces its fleet
    endpoint (``--metrics-port``), ``_scrape_fleet`` scrapes it while the
    rank trains, and the summary's ``fleet`` holds what it got (empty where
    no endpoint was announced)."""
    own = outdir is None
    if own:
        outdir = os.path.join(tempfile.mkdtemp(prefix="tpudist_torch_ddp_"),
                              "run")
    cmd = [sys.executable, "-m", "tpudist_torch.launch", "-n", "1",
           *launch_args, "--", sys.executable,
           *(trainer or ["-m", "tpudist_torch"]), "--distributed", *args,
           "--telemetry", "--seed", "0", "--outpath", outdir]
    t0, t0_wall = time.perf_counter(), time.time()
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    got: dict = {}
    err_lines: list = []

    def pump():
        for line in proc.stderr:
            err_lines.append(line)
            m = FLEET_RE.search(line)
            if m and "port" not in got:
                got["port"] = int(m.group(1))
                threading.Thread(target=_scrape_fleet,
                                 args=(got["port"], proc, got),
                                 daemon=True).start()

    timed_out = threading.Event()

    def kill():
        timed_out.set()
        proc.terminate()               # the launcher tears its rank down

    pumper = threading.Thread(target=pump, daemon=True)
    pumper.start()
    killer = threading.Timer(timeout, kill)
    killer.start()
    try:
        text = proc.stdout.read()
        proc.wait(timeout=60)
    finally:
        killer.cancel()
    pumper.join(timeout=10)
    err = "".join(err_lines)
    if timed_out.is_set():
        raise RuntimeError(f"{what} timed out after {timeout}s: "
                           f"{err[-2000:]}")
    wall_s = time.perf_counter() - t0
    print(text, end="", flush=True)
    lines = text.splitlines()
    if proc.returncode != 0 or not lines \
            or not lines[-1].startswith("best_acc1="):
        raise RuntimeError(f"{what} exited {proc.returncode}: "
                           f"{err[-3000:]}")
    if "Grad strides do not match" in err:
        raise RuntimeError(f"{what}: DDP re-laid out a gradient: "
                           f"{err[-2000:]}")
    with open(telemetry_lib.events_path(outdir, 0)) as f:
        events = [json.loads(ln) for ln in f]
    for ev in events:
        telemetry_lib.validate_event(ev)
    row = _world1_run(text, events, what)
    if own:
        shutil.rmtree(os.path.dirname(outdir), ignore_errors=True)
    # Where the launch's seconds went, on the host clock: to the rank's
    # run_start (the launcher's and the rank's start, imports, the process
    # group), to its first step's end, to its run_end, and to the exit.
    steps = [e for e in events if e["type"] == "step"]
    t_end = t0_wall + wall_s
    timing = {"to_run_start_s": events[0]["t"] - t0_wall,
              "to_first_step_end_s": steps[0]["t"] - t0_wall
              if steps else None,
              "to_run_end_s": events[-1]["t"] - t0_wall,
              "exit_after_run_end_s": t_end - events[-1]["t"]}
    return text, {
        "timing": timing, "wall_s": wall_s, **row,
        "fleet": got,
        "launcher_lines": [ln for ln in err.splitlines()
                           if ln.startswith("[tpudist_torch.launch]")]}, events


def _world1_run(text: str, events: list, what: str) -> dict:
    """What makes a valid world-1 NCCL run, launched or in process: the
    DDP line, a run_start over NCCL on one device and an init phase
    recorded at its start and end, finite train and val losses. Returns
    its summary (the launches are its run_end's counters)."""
    start, end = events[0], events[-1]
    if DDP_LINE not in text or start.get("backend") != "nccl" \
            or start["n_devices"] != 1 or not start["init_s"] > 0 \
            or not end["init_s"] > 0:
        raise RuntimeError(f"{what}: not a world-1 NCCL run with its init "
                           f"phase recorded: run_start {start}, run_end "
                           f"{end}")
    train_l, val_l = _epoch_losses(text, "Train"), _epoch_losses(text, "Val")
    if not train_l or not all(np.isfinite(train_l + val_l)):
        raise RuntimeError(f"{what}: losses {train_l}, {val_l}")
    steps = [e for e in events if e["type"] == "step"]
    return {
        "train_steps": len(steps), "train_loss": train_l,
        "val_loss": val_l, "launches": end["kernel_launches"],
        "init_s": {"run_start": start["init_s"], "run_end": end["init_s"]},
        "backend": start["backend"],
        "host_step_s_p50": (statistics.median(e["step_s"] for e in steps[1:])
                            if len(steps) > 1 else None),
        "run_end": {k: end[k] for k in (
            "wall_s", "productive_s", "goodput", "init_s", "compile_s",
            "eval_s", "checkpoint_s")}}


def _ddp_in_process(args: list, what: str, outdir: str):
    """``python -m tpudist_torch --distributed ARGS --telemetry`` in this
    process as rank 0 of a world of 1 over NCCL (the launcher's
    ``TPUDIST_*`` identity set for the run; the trainer joins the process
    group and leaves it), held to ``_world1_run``'s checks: the launches
    are this process's counters, set to 0 just before."""
    env = {"TPUDIST_COORDINATOR": f"127.0.0.1:{launch_lib.find_free_port()}",
           "TPUDIST_NUM_PROCESSES": "1", "TPUDIST_PROCESS_ID": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    t0 = time.perf_counter()
    try:
        text, events, launches = _run_cli(
            ["--distributed", *args, "--telemetry", "--seed", "0",
             "--outpath", outdir], what)
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    wall_s = time.perf_counter() - t0
    return text, {"in_process": True, "wall_s": wall_s,
                  **_world1_run(text, events, what),
                  "launches": launches}, events


def phase_train_ddp(root: str) -> dict:
    """The reference's recipe 3 through the launcher at full width:
    resnet18 at 224 px, 1000 classes, global batch 256, float16 with
    tpudist's dynamic loss scaling, --fused-bn on, two epochs of 8 steps,
    world 1 over NCCL (CKPT_R18_ARGS): every train step, skipped ones
    included, launches the fused-norm kernels 9/8/9/8 times and validation
    none; the checkpoint carries a finite ``dynamic_scale``, at least one
    step landed and the parameters moved (``_fp16_facts``). The run is
    checkpoint_resume's straight run A: its dir is kept under ``root``.
    The launcher runs with ``--telemetry-dir`` (the run dir; the trainer
    keeps it with ``--overwrite keep``), ``--metrics-port 0`` and
    ``--straggler-factor 4``: it announces its fleet endpoint, a scrape
    while the rank trains shows the world of 1 and rank 0's heartbeat
    step, ``/dashboard`` answers, and its ``events.launcher.jsonl`` holds
    ``launcher_start`` and no ``straggler`` (one rank has no fleet to lag
    behind)."""
    run_a = os.path.join(root, "r18_a")
    # The first launch: its rank fills the bytecode cache.
    text, row, events = _launch_trainer(
        CKPT_R18_ARGS + ["--overwrite", "keep", "--replica-check-freq", "1",
                         "--stall-timeout", str(DDP_STALL_TIMEOUT_S)],
        "the DDP resnet18 float16 run", outdir=run_a,
        launch_args=("--telemetry-dir", run_a, "--metrics-port", "0",
                     "--straggler-factor", "4"))
    n = row["train_steps"]
    want = {k: v * n for k, v in R18_PER_STEP.items()}
    got = {k: row["launches"][k] for k in fn.KERNELS}
    first = ("=> fused-norm kernels launched by the first train step: "
             "34 (bn_act_fwd 9, bn_act_fwd_res 8, bn_act_bwd 9, "
             "bn_act_bwd_res 8)")
    if n != 16 or got != want or first not in text.splitlines():
        raise RuntimeError(f"DDP fused-norm launches {got} for {n} steps; "
                           f"want {want} and the line {first!r}")
    # The fault planes at world 1: the replica check has no other replica
    # to hold rank 0 against, and the watchdog (started after the rank
    # built and loaded its kernels) never fired.
    checks = text.count(REPLICA_SKIP_LINE)
    stalls = [e for e in events if e["type"] == "fault"]
    if checks != 2 or stalls:
        raise RuntimeError(f"train_ddp: {checks} replica-check lines, "
                           f"fault events {stalls}")
    with open(os.path.join(run_a, "events.launcher.jsonl")) as f:
        launcher = [json.loads(ln) for ln in f]
    for ev in launcher:
        telemetry_lib.validate_event(ev)
    fleet = row["fleet"]
    kinds = [e["type"] for e in launcher]
    if "port" not in fleet or "metrics" not in fleet \
            or not fleet.get("dashboard", {}).get("html") \
            or fleet["metrics"].get("tpudist_fleet_nprocs") != 1 \
            or kinds != ["launcher_start"] or launcher[0]["nprocs"] != 1:
        raise RuntimeError(f"train_ddp's fleet view: {fleet}, launcher "
                           f"events {launcher}")
    out = {"phase": "train_ddp", "arch": "resnet18", "batch": TRAIN_B,
           "world": 1, "dtype": "float16", **row,
           "replica_check_lines": checks,
           "stall_timeout_s": DDP_STALL_TIMEOUT_S,
           "fused_norm_launches": got,
           "images_per_s_host": TRAIN_B / row["host_step_s_p50"],
           "float16": _fp16_facts(text, run_a, "resnet18"),
           "run_dir": run_a}
    emit(out)
    out["events"] = events
    return out


def phase_train_syncbn_ddp(root: str) -> dict:
    """``--sync_batchnorm`` at world 1 over NCCL, in this process, two
    steps: the statistics go through the all-reduce and the epilogue is
    the plain one, as tpudist's (0 fused-norm launches)."""
    text, row, _ = _ddp_in_process(
        ["-a", "resnet18", "--use_amp", "--fused-bn", "on",
         "--sync_batchnorm", "-b", str(TRAIN_B), "--synthetic",
         "--image-size", str(TRAIN_PX), "--num-classes", "1000",
         "--epochs", "1", "--synthetic-size", str(2 * TRAIN_B), "-p", "1"],
        "the DDP SyncBN run", os.path.join(root, "syncbn"))
    shutil.rmtree(os.path.join(root, "syncbn"), ignore_errors=True)
    plain = ("=> fused-norm dispatch: plain epilogue (mode on, ineligible; "
             "SyncBN's statistics all-reduce has no fused kernel; plain "
             "epilogue)")
    got = {k: row["launches"][k] for k in fn.KERNELS}
    if any(got.values()) or plain not in text.splitlines() \
            or DDP_LINE + ", SyncBN" not in text.splitlines():
        raise RuntimeError(f"SyncBN run: fused-norm launches {got}; want 0 "
                           f"and the line {plain!r}")
    out = {"phase": "train_syncbn_ddp", "arch": "resnet18",
           "batch": TRAIN_B, "world": 1, **row, "fused_norm_launches": got}
    emit(out)
    return out


def phase_train_vit_ddp(root: str) -> dict:
    """ViT-B/16 at 224 px, batch 128, float16 with dynamic loss scaling,
    --flash on, AdamW under DDP at world 1 over NCCL, in this process, two
    steps and one validation batch: 12 of each flash kernel a train step
    (skipped or not) and 12 forwards a validation batch; the checkpoint
    carries a finite ``dynamic_scale``."""
    outdir = os.path.join(root, "vit_ddp")
    text, row, _ = _ddp_in_process(
        ["-a", "vit_b_16", "--use_amp", "--amp-dtype", "float16", "--flash",
         "on", "--optimizer", "adamw", "--lr", "1e-3", "--weight-decay",
         "0.05", "-b", str(VIT_B), "--synthetic", "--image-size", "224",
         "--num-classes", "1000", "--epochs", "1", "--synthetic-size",
         str(2 * VIT_B), "-p", "1", "--keep-checkpoints", "0"],
        "the DDP ViT-B/16 float16 run", outdir)
    tree = ckpt_lib.load_checkpoint(outdir)
    ds = tree["state"].get("dynamic_scale")
    skipped = [m.group(4) for m in _verdicts(text, SCALE_LINE_RE)]
    del tree
    shutil.rmtree(outdir, ignore_errors=True)
    if not isinstance(ds, dict) or not np.isfinite(np.asarray(ds["scale"])):
        raise RuntimeError(f"DDP ViT-B/16 float16 checkpoint dynamic_scale "
                           f"{ds!r}")
    n, val = row["train_steps"], 1
    want = {"flash_fwd": LAYERS * (n + val), "flash_bwd_dq": LAYERS * n,
            "flash_bwd_dkv": LAYERS * n}
    got = {k: row["launches"][k] for k in fa.KERNELS}
    first = ("=> flash kernels launched by the first train step: 36 "
             "(flash_fwd 12, flash_bwd_dq 12, flash_bwd_dkv 12)")
    if n != 2 or got != want or first not in text.splitlines():
        raise RuntimeError(f"DDP flash launches {got} for {n} steps; want "
                           f"{want} and the line {first!r}")
    out = {"phase": "train_vit_ddp", "arch": "vit_b_16", "batch": VIT_B,
           "world": 1, "dtype": "float16", **row, "flash_launches": got,
           "dynamic_scale": {k: float(np.asarray(v)) for k, v in ds.items()},
           "steps_skipped": [int(k) for k in skipped]}
    emit(out)
    return out


def phase_ddp_vs_plain() -> dict:
    """Three SGD steps (resnet18, batch 256, bf16, --fused-bn on, lr 0.1)
    of the world-1 data-parallel step against the one-card step, from one
    seed on the same device batches, in the order plain, DDP, DDP, plain.
    Averaging over one rank is a copy and a division by 1, and the step
    repeats bit for bit, so every pair must be bit-equal in its losses,
    parameters and BN buffers; the phase fails otherwise and reports the
    largest difference of each pair. Then the DDP step's breakdown, beside
    the plain one."""
    port = launch_lib.find_free_port()
    dist_lib.initialize_runtime(f"127.0.0.1:{port}", 1, 0, device="cuda")
    try:
        batches = [_device_batch(300 + i) for i in range(TRAIN_CMP_STEPS)]
        runs, launches = [], {}
        for mode in ("plain", "ddp", "ddp", "plain"):
            model, step = _train_setup(True, ddp=mode == "ddp")
            fn.reset_counts()
            losses = [float(step(x, y, 0.1)["loss"]) for x, y in batches]
            torch.cuda.synchronize()
            launches[mode] = dict(fn.LAUNCHES)
            runs.append((mode, losses, _leaves(model)))
            del model, step

        def diff(a, b):
            loss = max(abs(x - y) for x, y in zip(a[1], b[1]))
            leaf = max((a[2][k] - b[2][k]).abs().max().item() for k in a[2])
            return {"loss_max_abs_diff": loss, "state_max_abs_diff": leaf,
                    "bit_equal": loss == 0 and leaf == 0 and all(
                        torch.equal(a[2][k], b[2][k]) for k in a[2])}

        pairs = {"ddp_vs_plain": diff(runs[1], runs[0]),
                 "ddp_vs_plain_2": diff(runs[2], runs[3]),
                 "plain_vs_plain": diff(runs[0], runs[3]),
                 "ddp_vs_ddp": diff(runs[1], runs[2])}
        want = {k: 9 * TRAIN_CMP_STEPS if not k.endswith("_res")
                else 8 * TRAIN_CMP_STEPS for k in fn.KERNELS}
        if launches["ddp"] != want:
            raise RuntimeError(f"DDP step launches {launches['ddp']}; want "
                               f"{want}")
        if not all(p["bit_equal"] for p in pairs.values()):
            raise RuntimeError(f"world-1 DDP and the one-card step are not "
                               f"all bit-equal: {pairs}")
        out = {"phase": "ddp_vs_plain", "steps": TRAIN_CMP_STEPS,
               "batch": TRAIN_B, "dtype": "bfloat16", "backend":
               dist_lib.backend(), "losses": {m: l for m, l, _ in runs},
               "ddp_launches": launches["ddp"], **pairs}
        emit(out)
        out["breakdown"] = phase_train_breakdown(ddp=True)
    finally:
        dist_lib.shutdown()
    return out


# -- phase 7: checkpoints, resume and serving from a checkpoint ---------------

CKPT_R18_ARGS = ["-a", "resnet18", "--use_amp", "--amp-dtype", "float16",
                 "--fused-bn", "on", "-b",
                 str(TRAIN_B), "--synthetic", "--image-size", str(TRAIN_PX),
                 "--num-classes", "1000", "--epochs", "2", "--synthetic-size",
                 "2048", "--step", "1", "-p", "4"]
CKPT_VIT_ARGS = ["--synthetic", "-a", "vit_b_16", "--image-size", "224",
                 "--num-classes", "1000", "-b", str(VIT_B), "--use_amp",
                 "--flash", "on", "--optimizer", "adamw", "--lr", "1e-3",
                 "--weight-decay", "0.05", "--model-ema-decay", "0.999",
                 "--telemetry", "--seed", "0", "--synthetic-size",
                 str(CKPT_VIT_SYNTHETIC), "--step", "1", "-p", "4",
                 "--keep-checkpoints", "0"]
R18_PER_STEP = {"bn_act_fwd": 9, "bn_act_fwd_res": 8, "bn_act_bwd": 9,
                "bn_act_bwd_res": 8}
# The parts of a resnet18 checkpoint a resumed run must end bit-equal in:
# the float16 loss scale (fin_steps and scale) and the optimizer count
# (the steps that landed) among them.
CKPT_R18_PARTS = {"params": ("state", "params"),
                  "batch_stats": ("state", "batch_stats"),
                  "momentum": ("state", "opt_state", "inner_state", "1",
                               "trace"),
                  "opt_count": ("state", "opt_state", "count"),
                  "step": ("state", "step"),
                  "dynamic_scale": ("state", "dynamic_scale")}
RESUMED_RE = re.compile(r"=> resumed from '([^']*)' \(epoch (\d+), "
                        r"best_acc1 ")


def _rss_bytes() -> int:
    with open("/proc/self/status") as f:
        for ln in f:
            if ln.startswith("VmRSS:"):
                return int(ln.split()[1]) * 1024
    return 0


@contextlib.contextmanager
def _rss_of_checkpoint_io():
    """While active, each ``save_checkpoint``,
    ``load_checkpoint_with_fallback`` and ``restore`` (onto the model,
    optimizer and EMA) of this process records its seconds, the host RSS
    before it and the peak RSS above that during it (polled every 5 ms)."""
    records = []
    originals = {n: getattr(ckpt_lib, n) for n in
                 ("save_checkpoint", "load_checkpoint_with_fallback",
                  "restore")}

    def watched(name, fn_):
        def call(*a, **k):
            base = _rss_bytes()
            peak, stop = [base], threading.Event()

            def poll():
                while not stop.wait(0.005):
                    peak[0] = max(peak[0], _rss_bytes())
            t = threading.Thread(target=poll, daemon=True)
            t.start()
            t0 = time.perf_counter()
            try:
                return fn_(*a, **k)
            finally:
                seconds = time.perf_counter() - t0
                stop.set()
                t.join()
                records.append({
                    "fn": name, "seconds": seconds,
                    "rss_before_gb": base / 1e9,
                    "rss_peak_above_before_gb":
                        (max(peak[0], _rss_bytes()) - base) / 1e9})
        return call

    for name, fn_ in originals.items():
        setattr(ckpt_lib, name, watched(name, fn_))
    try:
        yield records
    finally:
        for name, fn_ in originals.items():
            setattr(ckpt_lib, name, fn_)


def _host_io_rates(root: str, mb: int = 512) -> dict:
    """MB/s of what a checkpoint's save and restore are made of, on this
    host: sha256, a write of ``mb`` MB to ``root`` and its read back (the
    page cache, as a save and the restore after it see it), and a pageable
    copy of ``mb`` MB from the card to the host and back."""
    data = np.random.default_rng(0).integers(0, 255, mb << 20, np.uint8)
    path = os.path.join(root, "io_probe.bin")
    out = {}
    t0 = time.perf_counter()
    hashlib.sha256(memoryview(data)).hexdigest()
    out["sha256_mb_s"] = mb / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        f.write(memoryview(data))
    out["write_mb_s"] = mb / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    with open(path, "rb") as f:
        f.read()
    out["read_mb_s"] = mb / (time.perf_counter() - t0)
    os.remove(path)
    dev = torch.from_numpy(data).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev.cpu()
    out["d2h_pageable_mb_s"] = mb / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    torch.from_numpy(data).cuda()
    torch.cuda.synchronize()
    out["h2d_pageable_mb_s"] = mb / (time.perf_counter() - t0)
    return out


def _leaves_of(node, path=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves_of(v, f"{path}/{k}")
    elif isinstance(node, torch.Tensor):
        yield path, node.view(torch.int16).numpy()      # bfloat16 bits
    elif isinstance(node, (np.ndarray, np.generic)):
        yield path, np.asarray(node)


def _compare_parts(ta: dict, tb: dict, parts: dict) -> dict:
    """Per part of two checkpoint trees (``parts``: name → path of keys):
    bit-equal or not, and the largest absolute difference of a leaf."""
    out = {}
    for name, keys in parts.items():
        a, b = ta, tb
        for k in keys:
            a, b = a[k], b[k]
        la, lb = dict(_leaves_of(a)), dict(_leaves_of(b))
        if set(la) != set(lb) or not la:
            raise RuntimeError(f"checkpoint part {name}: leaves differ "
                               f"({len(la)} vs {len(lb)})")
        equal, diff = True, 0.0
        for k, x in la.items():
            y = lb[k]
            if x.shape != y.shape or x.dtype != y.dtype:
                raise RuntimeError(f"{name}{k}: {x.shape} {x.dtype} vs "
                                   f"{y.shape} {y.dtype}")
            equal = equal and x.tobytes() == y.tobytes()
            if x.size:
                diff = max(diff, float(np.abs(x.astype(np.float64)
                                              - y.astype(np.float64)).max()))
        out[name] = {"bit_equal": equal, "max_abs_diff": diff,
                     "leaves": len(la)}
    return out


def _resumed_vs_straight(ta: dict, tb: dict, parts: dict, rerun) -> dict:
    """The final trees of a straight and a resumed run must be bit-equal.
    If they are not, ``rerun()`` gives a second straight run's tree: when
    two straight runs differ too (a nondeterministic op), the resumed run
    is held within 3x that run-to-run spread, part by part."""
    cmp = _compare_parts(ta, tb, parts)
    out = {"resumed_vs_straight": cmp,
           "bit_equal": all(c["bit_equal"] for c in cmp.values())}
    if out["bit_equal"]:
        return out
    spread = _compare_parts(ta, rerun(), parts)
    bound = {k: 3 * v["max_abs_diff"] for k, v in spread.items()}
    out.update(straight_vs_straight=spread, bound=bound)
    bad = {k: c for k, c in cmp.items() if not c["bit_equal"]
           and not c["max_abs_diff"] <= bound[k]}
    if bad:
        raise RuntimeError(f"resumed and straight runs differ beyond 3x the "
                           f"run-to-run spread: {bad}; spread {spread}")
    return out


def _checkpoint_numbers(events: list, path: str) -> dict:
    saves = [e for e in events if e["type"] == "checkpoint_save"]
    restores = [e for e in events if e["type"] == "checkpoint_restore"]
    size = os.path.getsize(path)
    return {"file_bytes": size,
            "save_s": [e["seconds"] for e in saves],
            "restore_s": [e["seconds"] for e in restores],
            "save_mb_per_s": [size / 1e6 / e["seconds"] for e in saves],
            "restore_mb_per_s": [size / 1e6 / e["seconds"]
                                 for e in restores]}


def phase_checkpoint_resume(root: str, card: dict, straight: dict) -> dict:
    """resnet18 at train_ddp's settings (float16) for 2 epochs through the
    launcher: run A is train_ddp's run, straight through; run B with
    ``--max-restarts 1 --resume auto --overwrite keep`` under
    CRASH_WRAPPER, whose attempt 0 dies after the first epoch's save. The
    launcher must restart it once, attempt 1 must resume at epoch 1 or
    later, B1–B4 must launch 9/8/9/8 times a step in both attempts, and
    A's and B's final checkpoints must hold the same parameters, BN
    statistics, momentum, step and dynamic loss scale, read back with the
    port's reader (the scale and fin_steps are restored exactly)."""
    run_a, run_b = straight["run_dir"], os.path.join(root, "r18_b")
    row_a, ev_a = straight, straight["events"]
    wrapper = os.path.join(root, "crash_after_epoch_1.py")
    with open(wrapper, "w") as f:
        f.write(CRASH_WRAPPER)
    text_b, row_b, ev_b = _launch_trainer(
        CKPT_R18_ARGS + ["--resume", "auto", "--overwrite", "keep"],
        "the interrupted resnet18 run", outdir=run_b, trainer=[wrapper],
        launch_args=("--max-restarts", "1"))
    crash = json.loads(next(ln for ln in text_b.splitlines()
                            if ln.startswith("CRASH ")).split(" ", 1)[1])
    resumed = RESUMED_RE.search(text_b)
    steps_a = sum(e["type"] == "step" for e in ev_a)
    steps_b1 = sum(e["type"] == "step" and e["attempt"] == 1 for e in ev_b)
    want = {"a": {k: v * steps_a for k, v in R18_PER_STEP.items()},
            "b0": {k: v * crash["step"] for k, v in R18_PER_STEP.items()},
            "b1": {k: v * steps_b1 for k, v in R18_PER_STEP.items()}}
    got = {"a": {k: row_a["launches"][k] for k in fn.KERNELS},
           "b0": {k: crash["launches"][k] for k in fn.KERNELS},
           "b1": {k: row_b["launches"][k] for k in fn.KERNELS}}
    if not any("restart 1/1" in ln for ln in row_b["launcher_lines"]) \
            or resumed is None or int(resumed.group(2)) < 1 \
            or steps_a != 16 or crash["step"] != 8 or steps_b1 != 8 \
            or got != want:
        raise RuntimeError(
            f"checkpoint_resume: launcher {row_b['launcher_lines']}, resumed "
            f"{resumed and resumed.group(0)}, steps A {steps_a}, B attempt 0 "
            f"{crash['step']}, attempt 1 {steps_b1}; launches {got}, want "
            f"{want}")
    parts = CKPT_R18_PARTS
    tree_a, tree_b = (ckpt_lib.load_checkpoint(d) for d in (run_a, run_b))

    def rerun():
        again = os.path.join(root, "r18_a2")
        _launch_trainer(CKPT_R18_ARGS, "the second straight resnet18 run",
                        outdir=again)
        tree = ckpt_lib.load_checkpoint(again)
        shutil.rmtree(again, ignore_errors=True)
        return tree
    held = _resumed_vs_straight(tree_a, tree_b, parts, rerun)
    live = os.path.join(run_a, ckpt_lib.CKPT_NAME)
    out = {"phase": "checkpoint_resume", "arch": "resnet18",
           "batch": TRAIN_B, "dtype": "float16", "epochs": 2,
           "card": card["nvidia_smi"],
           "files_equal": open(live + ".sha256").read().split()[0]
           == open(os.path.join(run_b, ckpt_lib.CKPT_NAME)
                   + ".sha256").read().split()[0],
           **held, "resumed_line": resumed.group(0),
           "launcher_lines": row_b["launcher_lines"],
           "fused_norm_launches": got,
           "steps": {"a": steps_a, "b_attempt0": crash["step"],
                     "b_attempt1": steps_b1},
           "a": {**_checkpoint_numbers(ev_a, live),
                 "run_end": row_a["run_end"], "wall_s": row_a["wall_s"]},
           "b": {**_checkpoint_numbers(ev_b, os.path.join(
               run_b, ckpt_lib.CKPT_NAME)),
                 "run_end": row_b["run_end"], "wall_s": row_b["wall_s"]},
           "run_dir": run_a}
    emit(out)
    return out


def _run_cli(argv: list, what: str) -> tuple[str, list, dict]:
    """``python -m tpudist_torch ARGV`` in this process (the kernel
    counts set to 0 just before it): its output (printed), this run's
    events (validated) and the launches it made."""
    outdir = argv[argv.index("--outpath") + 1]
    path = telemetry_lib.events_path(outdir, 0)
    skip = 0
    if os.path.exists(path):
        with open(path) as f:
            skip = sum(1 for _ in f)
    fa.reset_counts()
    fn.reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_cli.main(argv)
    launches = {**fn.LAUNCHES, **fa.LAUNCHES}
    text = buf.getvalue()
    print(text, end="", flush=True)
    if rc != 0 or not text.splitlines()[-1].startswith("best_acc1="):
        raise RuntimeError(f"{what} exited {rc}")
    with open(path) as f:
        events = [json.loads(ln) for ln in f][skip:]
    for ev in events:
        telemetry_lib.validate_event(ev)
    return text, events, launches


def _train_in_process(argv: list, what: str, val_batches: int):
    """``_run_cli`` of a ViT run, which must launch each flash kernel 12
    times a train step and the forward 12 times a validation batch: its
    output, events, flash launches and wall seconds."""
    t0 = time.perf_counter()
    text, events, launches = _run_cli(argv, what)
    wall_s = time.perf_counter() - t0
    launches = {k: launches[k] for k in fa.KERNELS}
    n = sum(e["type"] == "step" for e in events)
    want = {"flash_fwd": LAYERS * (n + val_batches),
            "flash_bwd_dq": LAYERS * n, "flash_bwd_dkv": LAYERS * n}
    if launches != want or any(fn.LAUNCHES.values()):
        raise RuntimeError(f"{what}: flash launches {launches} for {n} "
                           f"steps and {val_batches} validation batches; "
                           f"want {want}")
    return text, events, launches, wall_s


def phase_checkpoint_vit(root: str, card: dict) -> dict:
    """ViT-B/16 at 224 px, batch 128, bf16, --flash on, AdamW,
    --model-ema-decay 0.999, 512 images, --keep-checkpoints 0: two epochs
    straight through against one epoch and a --resume for the second. The
    final params, AdamW moments, EMA and step must be bit-equal (or within
    3x the run-to-run spread). Each save and restore is timed, with the
    host RSS it adds."""
    straight = os.path.join(root, "vit_straight")
    resumed = os.path.join(root, "vit_resumed")
    val = math.ceil(CKPT_VIT_SYNTHETIC // 2 / VIT_B)
    runs = {}
    host_rates = _host_io_rates(root)
    with _rss_of_checkpoint_io() as io_records:
        for name, out, epochs, extra, val_batches in (
                ("straight", straight, "2", [], 2 * val),
                ("first_epoch", resumed, "1", [], val),
                ("resumed", resumed, "2",
                 ["--resume", "auto", "--overwrite", "keep"], val)):
            text, events, launches, wall_s = _train_in_process(
                CKPT_VIT_ARGS + ["--epochs", epochs, "--outpath", out]
                + extra, f"the ViT-B/16 {name} run", val_batches)
            live = os.path.join(out, ckpt_lib.CKPT_NAME)
            runs[name] = {"wall_s": wall_s, "flash_launches": launches,
                          "train_steps": sum(e["type"] == "step"
                                             for e in events),
                          **_checkpoint_numbers(events, live),
                          "run_end": {k: events[-1][k] for k in (
                              "wall_s", "productive_s", "goodput",
                              "compile_s", "eval_s", "checkpoint_s")},
                          "io": list(io_records)}
            io_records.clear()
            if name == "straight":
                tree_s = ckpt_lib.load_checkpoint(straight)
                shutil.rmtree(straight, ignore_errors=True)
            if name == "resumed":
                resumed_line = RESUMED_RE.search(text)
    if resumed_line is None or int(resumed_line.group(2)) != 1 \
            or "=> checkpoint has no EMA copy" in text:
        raise RuntimeError(f"the resumed ViT run did not resume the EMA "
                           f"checkpoint of epoch 1: "
                           f"{resumed_line and resumed_line.group(0)}")
    parts = {"params": ("state", "params"),
             "mu": ("state", "opt_state", "inner_state", "0", "mu"),
             "nu": ("state", "opt_state", "inner_state", "0", "nu"),
             "ema": ("state", "ema_params", "params"),
             "step": ("state", "step"),
             "adam_count": ("state", "opt_state", "inner_state", "0",
                            "count")}
    tree_r = ckpt_lib.load_checkpoint(resumed)

    def rerun():
        again = os.path.join(root, "vit_straight2")
        _train_in_process(CKPT_VIT_ARGS + ["--epochs", "2", "--outpath",
                                           again],
                          "the second straight ViT-B/16 run", 2 * val)
        tree = ckpt_lib.load_checkpoint(again)
        shutil.rmtree(again, ignore_errors=True)
        return tree
    held = _resumed_vs_straight(tree_s, tree_r, parts, rerun)
    del tree_s, tree_r
    out = {"phase": "checkpoint_vit", "arch": "vit_b_16", "batch": VIT_B,
           "dtype": "bfloat16", "optimizer": "adamw", "ema_decay": 0.999,
           "card": card["nvidia_smi"], **held,
           "resumed_line": resumed_line.group(0), "runs": runs,
           "host_io_mb_s": host_rates,
           "launches_per_train_step": {k: LAYERS for k in fa.KERNELS},
           "run_dir": resumed}
    emit(out)
    return out


def _rebuilt_logits(tree: dict, arch: str, images: np.ndarray,
                    ema: bool) -> np.ndarray:
    """An eval forward, in bf16 on the card, of ``arch`` holding a
    checkpoint tree's EMA (or live) weights, rebuilt without the serving
    code."""
    state = tree["state"]
    v = state["ema_params"] if ema else state
    kw = dict(image_size=224, flash=True) if arch.startswith("vit") else {}
    model = create_model(arch, dtype=torch.bfloat16, **kw)
    model.load_state_dict(state_dict_from_jax(arch, v["params"],
                                              v["batch_stats"]))
    model.cuda().eval()
    with torch.inference_mode():
        return model(torch.from_numpy(images).cuda()).float().cpu().numpy()


def _serve_run(argv: list, what: str):
    outdir = tempfile.mkdtemp(prefix="tpudist_torch_serve_ckpt_")
    fa.reset_counts()
    fn.reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_cli.main(argv + ["--telemetry", "--outpath", outdir])
    launches = {**fa.LAUNCHES, **fn.LAUNCHES}
    text = buf.getvalue()
    print(text, end="", flush=True)
    summary = json.loads(next(ln for ln in text.splitlines()
                              if ln.startswith("SERVE_SUMMARY "))
                         .split(" ", 1)[1])
    with open(telemetry_lib.events_path(outdir, 0)) as f:
        events = [json.loads(ln) for ln in f]
    shutil.rmtree(outdir, ignore_errors=True)
    for ev in events:
        telemetry_lib.validate_event(ev)
    if rc != 0 or summary.get("n_errors", 1) != 0 \
            or not summary.get("n_requests"):
        raise RuntimeError(f"{what}: exit {rc}, {summary}")
    calls = sum(e["type"] in ("serve_batch", "compile") for e in events)
    return text, summary, launches, calls


def phase_serve_checkpoint(vit_dir: str, r18_dir: str, card: dict) -> dict:
    """``python -m tpudist_torch.serve --checkpoint``: ViT-B/16 from the
    checkpoint_vit run (the log must say the EMA weights are served; the
    flash forward launches 12 times a bucket call) and resnet18 from
    checkpoint_resume's run A (no kernel in eval). The served logits of a
    fixed batch must equal, within the serve bound, an eval forward of
    the model rebuilt from the same file (the EMA weights for the ViT),
    and differ from the ViT's live weights' by more."""
    rng = np.random.default_rng(0)
    images = rng.standard_normal((8, 224, 224, 3)).astype(np.float32)
    out = {"phase": "serve_checkpoint", "card": card["nvidia_smi"]}
    for arch, run_dir, buckets in (("vit_b_16", vit_dir, BUCKETS),
                                   ("resnet18", r18_dir, (1, 8))):
        text, summary, launches, calls = _serve_run(
            ["-a", arch, "--image-size", "224", "--buckets",
             ",".join(map(str, buckets)), "--flash", "on", "--checkpoint",
             run_dir, "--load-rate", "20", "--load-duration", "1.5",
             "--seed", "0"], f"serving {arch} from its checkpoint")
        vit = arch.startswith("vit")
        ema_line = "=> serving the EMA weights" in text
        want = {k: 0 for k in launches}
        if vit:
            want["flash_fwd"] = LAYERS * calls
        if launches != want or ema_line != vit:
            raise RuntimeError(f"serving {arch} from {run_dir}: launches "
                               f"{launches} for {calls} bucket calls (want "
                               f"{want}), EMA line {ema_line}")
        model = load_serve_state(arch, run_dir, flash="on")
        served = ServeEngine(model, image_size=224, buckets=(8,)).infer(
            images)
        del model
        tree = ckpt_lib.load_checkpoint(run_dir)
        want_l = _rebuilt_logits(tree, arch, images, ema=vit)
        scale = max(1.0, float(np.abs(want_l).max()))
        diff = float(np.abs(served - want_l).max())
        row = {"summary": summary, "launches": launches,
               "bucket_calls": calls, "ema_served": ema_line,
               "logits_vs_rebuilt_max_abs": diff,
               "logits_tol": LOGITS_TOL * scale}
        if vit:
            live = _rebuilt_logits(tree, arch, images, ema=False)
            row["logits_vs_live_weights_max_abs"] = float(
                np.abs(served - live).max())
        del tree
        if not np.isfinite(served).all() or served.shape != (8, 1000) \
                or not diff <= LOGITS_TOL * scale or (
                    vit and not row["logits_vs_live_weights_max_abs"] > diff):
            raise RuntimeError(f"serving {arch} from its checkpoint: {row}")
        out[arch] = row
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
        # float16 through the same tensor-core kernels, at the bf16 shapes.
        (f"f16_train_b{VIT_B}", VIT_B, SERVE_T, SERVE_T, SERVE_H, SERVE_D,
         torch.float16, False),
        ("f16_d80", 2, SERVE_T, SERVE_T, 4, 80, torch.float16, False),
        ("f16_causal_cross", 2, 150, 197, 4, 64, torch.float16, True),
        ("f16_d32_masked_rows", 2, 100, 60, 3, 32, torch.float16, True),
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
        shares = {n: (a != w).float().mean().item()
                  for n, a, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
        if dtype == torch.float16 and max(shares.values()) > BWD_F16_SHARE:
            raise RuntimeError(f"{label}: not bit-equal shares {shares} "
                               f"(at most {BWD_F16_SHARE})")
        large = b >= VIT_B
        row = {"case": label, "shape": [b, tq, tk, h, d],
               "dtype": str(dtype).replace("torch.", ""), "causal": causal,
               "tol": tol, "errors": errs,
               "relative_errors": {
                   n: errs[n] / max(1e-30, w.float().abs().max().item())
                   for n, w in zip(("dq", "dk", "dv"), want)},
               "not_bit_equal_share": shares,
               "plain_ms": time_ms(
                   lambda: fa.flash_attention_bwd_reference(*args),
                   reps=5 if large else 25, inner=2 if large else 10)}
        rate = peaks["f32" if dtype == torch.float32 else "bf16"]
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
           "nonfinite": _nonfinite_bwd(),
           "library": "torch.nn.functional.scaled_dot_product_attention "
                      "backward (torch.autograd.grad from a retained "
                      "graph)"}
    emit(out)
    return out


def _nonfinite_bwd() -> dict:
    """B6 and B7 in float16 with inf and NaN planted in dO (the gradient
    an overflowed float16 step brings): dq, dk and dv are non-finite
    exactly where the plain version's are."""
    b, t, h, d = 2, SERVE_T, 4, SERVE_D
    q, k, v = _qkv_views(b, t, t, h, d, torch.float16, seed=95)
    g = torch.Generator(device="cuda").manual_seed(96)
    do = torch.randn(b, t, h, d, generator=g, device="cuda").half()
    do = _planted(do, 97, frac=2e-5)
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta, lse = fa.backward_rows(o, lse, do)
    args = (q, k, v, do, lse, delta, False)
    got = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_reference(*args)
    out = {"shape": [b, t, t, h, d], "dtype": "float16",
           "planted_in_do": int((~torch.isfinite(do)).sum()),
           **{n: _nonfinite_share(a, w)
              for n, a, w in zip(("dq", "dk", "dv"), got, want)}}
    if any(out[n]["pattern_mismatches"] for n in ("dq", "dk", "dv")) \
            or not all(out[n]["nan"] + out[n]["inf"]
                       for n in ("dq", "dk", "dv")):
        raise RuntimeError(f"flash backward float16 with inf/NaN in dO: "
                           f"the kernels' non-finite outputs differ from "
                           f"the plain version's: {out}")
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
            "--keep-checkpoints", "0", "--outpath", outdir]
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
    shutil.rmtree(os.path.dirname(outdir), ignore_errors=True)
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
                                           "data_wait_s", "eval_s",
                                           "checkpoint_s")}}
    emit(out)
    return out


def _vit_setup(flash: bool, dtype=torch.bfloat16, seed: int = 0,
               optimizer: str = "sgd", scaler=None):
    cfg = config_lib.Config(arch="vit_b_16", batch_size=VIT_B,
                            image_size=TRAIN_PX, optimizer=optimizer,
                            flash="on" if flash else "off")
    model = create_model("vit_b_16", dtype=dtype, flash=flash,
                         image_size=TRAIN_PX)
    if seed == 0:
        model.load_state_dict(_seed0_weights("vit_b_16",
                                             image_size=TRAIN_PX))
    else:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    model.cuda()
    opt = train_lib.make_optimizer(model, cfg)
    step = train_lib.make_train_step(model, opt, cfg,
                                     scaler=scaler or _scaler(dtype))
    step.optimizer = opt
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


# float16 (--amp-dtype float16) kernels on vs off, SGD, three steps from a
# loss scale that lands: resnet18 at TRAIN_B (lr 0.1) and ViT-B/16 at VIT_B
# (lr FP16_VIT_LR). Losses relative to max(1, |loss|) and every leaf after
# step one against its change in the step, as the bf16 rows above. Read on
# an H100 80GB HBM3 at 700 W: resnet18 2.3e-4 and 0.135, ViT-B/16 1.1e-5
# and 0.043 (float16 keeps 3 more mantissa bits than bf16, so the two
# epilogues and attentions round apart less); the bounds sit about 3x
# above.
FP16_LOSS_TOL = {"float16": 1e-3}
FP16_STATE_TOL = {"float16": 0.4}
FP16_VIT_LR = 1e-3
FP16_VIT_LOSS_TOL = {"float16": 4e-5}
FP16_VIT_STATE_TOL = {"float16": 0.13}
# Steps tried from flax's default scale (65,536) before a float16 step must
# have landed.
LANDING_LIMIT = 32


def _first_landing(setup, batch: int, lr: float) -> dict:
    """Train steps (kernels on) from flax's default scale, one fresh device
    batch each, until one lands: the steps skipped, the scale each step
    ran at, and the kernel launches a step (skipped steps included)."""
    scaler = DynamicScale()
    model, step = setup(True, torch.float16, scaler=scaler)
    before = {**fn.LAUNCHES, **fa.LAUNCHES}
    scales = []
    for i in range(LANDING_LIMIT):
        x, y = _device_batch(400 + i, batch)
        scales.append(scaler.scale)
        m = step(x, y, lr)
        if m["finite"]:
            break
    else:
        raise RuntimeError(f"no float16 step landed in {LANDING_LIMIT} "
                           f"steps from 65536 (scales {scales})")
    n = len(scales)
    launches = {k: (v - before[k]) / n for k, v in {
        **fn.LAUNCHES, **fa.LAUNCHES}.items() if v != before[k]}
    del model, step
    return {"skipped_from_65536": n - 1, "landed_at_scale": scales[-1],
            "scales": scales, "first_landed_loss": float(m["loss"]),
            "launches_per_step": launches}


def _poisoned_step(setup, batch: int, lr: float, scale: float) -> dict:
    """One landed float16 step (kernels on) from ``scale``, then a batch of
    infs: the kernels launch as in any step, the step is skipped, the
    parameters and the optimizer state keep their bits, the scale halves
    and fin_steps restarts."""
    scaler = DynamicScale(scale=scale)
    model, step = setup(True, torch.float16, scaler=scaler)
    x, y = _device_batch(7, batch)
    landed = bool(step(x, y, lr)["finite"])

    def opt_tensors():
        return [v for st in step.optimizer.state.values()
                for v in st.values() if isinstance(v, torch.Tensor)]
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt_state = [v.clone() for v in opt_tensors()]
    before = {**fn.LAUNCHES, **fa.LAUNCHES}
    m = step(torch.full_like(x, float("inf")), y, lr)
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in {
        **fn.LAUNCHES, **fa.LAUNCHES}.items() if v != before[k]}
    kept = all(torch.equal(v, params[k])
               for k, v in model.named_parameters())
    now = opt_tensors()
    kept_opt = len(now) == len(opt_state) > 0 and all(
        torch.equal(a, b) for a, b in zip(now, opt_state))
    del model, step
    return {"first_landed": landed, "skipped": not m["finite"],
            "params_kept": kept, "optimizer_state_kept": kept_opt,
            "scale_after": scaler.scale, "fin_steps_after": scaler.fin_steps,
            "launches": launches}


def _step_wall_ms(setup, dtype, batch: int, lr: float, scale=None,
                  n: int = 10) -> dict:
    """The synchronised wall of one train step (kernels on) on a
    device-resident batch, median of ``n`` after 2 warm steps; in float16
    from ``scale``, with the steps that landed counted."""
    scaler = _scaler(dtype, scale)
    model, step = (setup(True, dtype) if scaler is None
                   else setup(True, dtype, scaler=scaler))
    x, y = _device_batch(7, batch)
    for _ in range(2):
        step(x, y, lr)
    torch.cuda.synchronize()
    walls, landed = [], 0
    for _ in range(n):
        t0 = time.perf_counter()
        m = step(x, y, lr)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        landed += bool(m.get("finite", True))
    del model, step
    return {"wall_ms_p50": statistics.median(walls),
            "wall_ms_min": min(walls), "steps": n, "landed": landed}


def phase_fp16_train() -> dict:
    """Float16 training in this process (SGD): from flax's default scale
    until a step lands (reported: the steps skipped and the scale), then
    three steps kernels on against off from that scale on the same
    batches, held to FP16_* bounds; B1–B4 launch 9/8/9/8 and B5–B7
    12/12/12 a step, skipped steps included (a step of infs is skipped:
    the kernels launch, the weights and optimizer state keep their bits,
    the scale halves); and the synchronised float16 step beside the bf16
    one at the same batch (the difference is what the scaler's multiply,
    unscale, finite check and host read cost)."""
    out = {"phase": "fp16_train", "optimizer": "sgd",
           "steps": TRAIN_CMP_STEPS}
    for arch, setup, batch, lr, tols, per_step in (
            ("resnet18", _train_setup, TRAIN_B, 0.1,
             (FP16_LOSS_TOL, FP16_STATE_TOL), R18_PER_STEP),
            ("vit_b_16", _vit_setup, VIT_B, FP16_VIT_LR,
             (FP16_VIT_LOSS_TOL, FP16_VIT_STATE_TOL),
             dict.fromkeys(fa.KERNELS, LAYERS))):
        land = _first_landing(setup, batch, lr)
        row = compare_on_off(setup, torch.float16, batch, lr,
                             scale=land["landed_at_scale"])
        bad = _held_on_off(row, *tols, f"{arch} float16 on vs off")
        want = {k: v * TRAIN_CMP_STEPS for k, v in per_step.items()}
        if land["launches_per_step"] != per_step:
            bad.append(f"launches a step from 65536 "
                       f"{land['launches_per_step']}, want {per_step}")
        if row["launches_on"] != want:
            bad.append(f"launches {row['launches_on']}, want {want}")
        if row["landed_on"] != row["landed_off"] \
                or not any(row["landed_on"]):
            bad.append(f"steps landed on {row['landed_on']} and off "
                       f"{row['landed_off']}: the two must skip alike and "
                       f"land at least once")
        poisoned = _poisoned_step(setup, batch, lr, land["landed_at_scale"])
        if poisoned != dict(poisoned, first_landed=True, skipped=True,
                            params_kept=True, optimizer_state_kept=True,
                            scale_after=land["landed_at_scale"] / 2,
                            fin_steps_after=0, launches=per_step):
            bad.append(f"a step of infs: {poisoned}")
        if bad:
            raise RuntimeError(f"{'; '.join(bad)}: {land}, {row}")
        walls = {"bfloat16": _step_wall_ms(setup, torch.bfloat16, batch, lr),
                 "float16": _step_wall_ms(setup, torch.float16, batch, lr,
                                          land["landed_at_scale"])}
        out[arch] = {"batch": batch, "lr": lr, "landing": land,
                     "poisoned_step": poisoned,
                     "row": dict(row, loss_tol_relative=tols[0]["float16"],
                                 state_tol=tols[1]["float16"]),
                     "launches_per_step": per_step, "step_walls": walls,
                     "fp16_minus_bf16_ms":
                         walls["float16"]["wall_ms_p50"]
                         - walls["bfloat16"]["wall_ms_p50"]}
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
        "      pack_a<E>(aP, s[2 * kk], s[2 * kk + 1]);\n",
        "      pack_a<E>(aP, s[2 * kk], s[2 * kk + 1]);\n"
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
    bound that can see it, then the B3 faults in each zoo model, in its
    on/off training (``zoo_mutations``) and against the CPU
    (``zoo_vs_cpu_mutations``): 0 if every fault breaks a bound (a flash
    backward fault: the training bounds in both dtypes)."""
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
    caught.update(zoo_mutations())
    caught.update(zoo_vs_cpu_mutations())
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


# -- the measurement dispatch, accumulation and mixing ----------------------

# tpudist's own commands at full width: --fused-bn and --flash left at
# their default, auto; two optimizer steps of two microbatches each.
DISPATCH_R18 = ["--synthetic", "-a", "resnet18", "--image-size", str(TRAIN_PX),
                "--num-classes", "1000", "-b", str(TRAIN_B), "--use_amp",
                "--accum-steps", "2", "--mixup-alpha", "0.2",
                "--cutmix-alpha", "1.0", "--label-smoothing", "0.1",
                "--synthetic-size", str(2 * TRAIN_B), "--epochs", "1",
                "-p", "1", "--keep-checkpoints", "0", "--telemetry",
                "--seed", "0"]
DISPATCH_VIT = ["--synthetic", "-a", "vit_b_16", "--image-size",
                str(TRAIN_PX), "--num-classes", "1000", "-b", str(2 * VIT_B),
                "--use_amp", "--accum-steps", "2", "--optimizer", "adamw",
                "--lr", "1e-3", "--weight-decay", "0.05", "--mixup-alpha",
                "0.2", "--cutmix-alpha", "1.0", "--label-smoothing", "0.1",
                "--synthetic-size", str(4 * VIT_B), "--epochs", "1", "-p",
                "1", "--keep-checkpoints", "0", "--telemetry", "--seed", "0"]
ACCUM = 2
NORM_VERDICT_RE = re.compile(
    r"^=>   (m\d+_c\d+_\w+_(plain|res)) \((\d+) sites?\)(?:: cuda "
    r"([\d.]+) ms vs plain ([\d.]+) ms, margin ([\d.]+)%)? → (cuda|plain) "
    r"\((\w+)\)$")
ATTN_VERDICT_RE = re.compile(
    r"^=> (?:serve )?attention dispatch: (flash|plain) attention \(mode "
    r"auto, (\w+)(?:: [^;]*)?(?:; (b\S+): flash ([\d.]+) ms vs plain "
    r"([\d.]+) ms, margin ([\d.]+)%)?\)$")
LAUNCH_LINE_RE = re.compile(r"^=> (?:fused-norm|flash) kernels launched by "
                            r"the first train step: \d+ \((.*)\)$")
PROBE_LINE_RE = re.compile(r"^=> dispatch probes launched \d+ kernels "
                           r"\((.*)\)$")


def _counts(text: str, pattern) -> dict:
    """``{kernel: n}`` from the first line of ``text`` that ``pattern``
    matches ("name n, name n"), {} where none does."""
    for ln in text.splitlines():
        m = pattern.match(ln)
        if m:
            return {k: int(v) for k, v in (kv.rsplit(" ", 1) for kv in
                                           m.group(1).split(", "))}
    return {}


def _verdicts(text: str, regex) -> list[dict]:
    rows = []
    for ln in text.splitlines():
        m = regex.match(ln)
        if m:
            rows.append(m)
    return rows


def _dispatch_run(argv: list, root: str, tag: str, vit: bool) -> dict:
    """One in-process run of a dispatch command: its verdicts, its probe
    launches, and its launches a step checked against the verdicts (each
    site that chose the kernel launches it once a microbatch, each that
    chose plain nothing; validation launches the forward alone)."""
    outdir = os.path.join(root, tag)
    t0 = time.perf_counter()
    text, events, launches = _run_cli(argv + ["--outpath", outdir], tag)
    wall_s = time.perf_counter() - t0
    shutil.rmtree(outdir, ignore_errors=True)
    n = sum(e["type"] == "step" for e in events)
    probe = _counts(text, PROBE_LINE_RE)
    per_step = dict.fromkeys(fa.KERNELS if vit else fn.KERNELS, 0)
    if vit:
        rows = [{"key": m.group(3), "kernel": m.group(1),
                 "source": m.group(2), "flash_ms": float(m.group(4)),
                 "plain_ms": float(m.group(5)),
                 "margin": float(m.group(6)) / 100}
                for m in _verdicts(text, ATTN_VERDICT_RE) if m.group(3)]
        if len(rows) != 1:
            raise RuntimeError(f"{tag}: attention verdicts {rows}")
        fused = rows[0]["kernel"] == "flash"
        if fused:
            per_step = dict.fromkeys(fa.KERNELS, LAYERS * ACCUM)
        val = {"flash_fwd": LAYERS if fused else 0}
    else:
        rows = [{"key": m.group(1), "sites": int(m.group(3)),
                 "cuda_ms": m.group(4) and float(m.group(4)),
                 "plain_ms": m.group(5) and float(m.group(5)),
                 "margin": m.group(6) and float(m.group(6)) / 100,
                 "kernel": m.group(7), "source": m.group(8)}
                for m in _verdicts(text, NORM_VERDICT_RE)]
        if len(rows) != 9 or sum(r["sites"] for r in rows) != \
                SITES_PER_STEP or any(r["cuda_ms"] is None for r in rows):
            raise RuntimeError(f"{tag}: fused-norm verdicts {rows}")
        for r in rows:
            if r["kernel"] == "cuda":
                res = r["key"].endswith("_res")
                for k in (("bn_act_fwd_res", "bn_act_bwd_res") if res
                          else ("bn_act_fwd", "bn_act_bwd")):
                    per_step[k] += ACCUM * r["sites"]
        val = {}
    first = _counts(text, LAUNCH_LINE_RE)
    want = {k: n * v + val.get(k, 0) + probe.get(k, 0)
            for k, v in per_step.items()}
    got = {k: launches[k] for k in per_step}
    others = {k: v for k, v in launches.items() if k not in per_step and v}
    if (first or dict.fromkeys(per_step, 0)) != per_step or got != want \
            or others or n != 2:
        raise RuntimeError(f"{tag}: launches {launches} over {n} steps "
                           f"(probes {probe}, first step {first}); the "
                           f"verdicts {rows} want {per_step} a step")
    sources = {r["source"] for r in rows}
    return {"wall_s": wall_s, "steps": n, "verdicts": rows,
            "sources": sorted(sources), "probe_launches": probe,
            "launches": got, "launches_per_step": per_step}


# -- float16 through the CLI ---------------------------------------------------

SCALE_LINE_RE = re.compile(
    r"^=> dynamic loss scale after epoch (\d+): scale (\S+), fin_steps "
    r"(\d+); (\d+) of (\d+) steps skipped")
FP16_STEPS = 4                    # train steps of each in-process CLI run


def _fp16_facts(text: str, run_dir: str, arch: str) -> dict:
    """What a float16 run of the CLI left: its log's loss-scale lines (the
    steps each epoch skipped) and its checkpoint's ``dynamic_scale``, step
    and optimizer count (the steps that landed), and how many parameters
    differ from their seed-0 init. Raises unless the file carries a finite
    ``dynamic_scale`` as flax writes it (an int32 ``fin_steps``, an f32
    ``scale``), at least one step landed and the parameters moved."""
    epochs = [{"epoch": int(m.group(1)), "scale": float(m.group(2)),
               "fin_steps": int(m.group(3)), "skipped": int(m.group(4)),
               "steps": int(m.group(5))}
              for m in _verdicts(text, SCALE_LINE_RE)]
    tree = ckpt_lib.load_checkpoint(run_dir)
    state = tree["state"]
    ds = state.get("dynamic_scale")
    step, count = int(np.asarray(state["step"])), ckpt_lib.optimizer_count(
        tree)
    kw = {"image_size": TRAIN_PX} if arch.startswith("vit") else {}
    init = create_model(arch, num_classes=1000, **kw)
    init.reset_parameters(torch.Generator().manual_seed(0))
    saved = state_dict_from_jax(arch, state["params"])
    moved = sum(not torch.equal(saved[k].float(), v.float())
                for k, v in init.named_parameters())
    out = {"log": epochs, "step": step, "landed": count,
           "skipped": step - count, "params_moved": moved,
           "params": len(saved)}
    if not isinstance(ds, dict) or set(ds) != {"fin_steps", "scale"} \
            or np.asarray(ds["scale"]).dtype != np.float32 \
            or np.asarray(ds["fin_steps"]).dtype != np.int32:
        raise RuntimeError(f"{arch} float16 checkpoint dynamic_scale {ds!r}")
    out["dynamic_scale"] = {"scale": float(np.asarray(ds["scale"])),
                            "fin_steps": int(np.asarray(ds["fin_steps"]))}
    if not np.isfinite(out["dynamic_scale"]["scale"]) or count < 1 \
            or not moved or not epochs \
            or sum(e["skipped"] for e in epochs) != step - count:
        raise RuntimeError(f"{arch} float16 run: {out}")
    return out


def _fp16_cli_run(argv: list, tag: str, arch: str, per_step: dict,
                  val_per_batch: dict, root: str) -> dict:
    """One in-process float16 CLI run: its launches a step (skipped steps
    included) against ``per_step``, and ``_fp16_facts``."""
    outdir = os.path.join(root, tag)
    t0 = time.perf_counter()
    text, events, launches = _run_cli(argv + ["--outpath", outdir], tag)
    wall_s = time.perf_counter() - t0
    n = sum(e["type"] == "step" for e in events)
    val = FP16_STEPS // 2          # the validation set is half the train set
    probe = _counts(text, PROBE_LINE_RE)
    want = {k: n * v + val * val_per_batch.get(k, 0) + probe.get(k, 0)
            for k, v in per_step.items()}
    got = {k: launches[k] for k in per_step}
    facts = _fp16_facts(text, outdir, arch)
    shutil.rmtree(outdir, ignore_errors=True)
    if n != FP16_STEPS or got != want:
        raise RuntimeError(f"{tag}: launches {got} over {n} steps and {val} "
                           f"validation batches (probes {probe}); want "
                           f"{want}")
    return {"argv": argv, "wall_s": wall_s, "steps": n,
            "launches": got, "launches_per_step": per_step,
            "probe_launches": probe, **facts}


def phase_fp16_cli() -> dict:
    """The slice's commands through the CLI, in this process, at full width
    (224 px, 1000 classes, synthetic data, FP16_STEPS steps of one epoch):
    resnet18 ``--use_amp --amp-dtype float16 -b 256`` with ``--fused-bn``
    at its default, ``auto`` (a fresh dispatch cache: the probes time the
    float16 kernels, each verdict keyed ``..._float16_...``), the same at
    ``--accum-steps 2 --fused-bn on`` (B1–B4 18/16/18/16 a step), and
    ViT-B/16 ``-b 128 --optimizer adamw --flash on`` (B5–B7 12/12/12 a
    step, 12 forwards a validation batch). In each, at least one step
    lands, the checkpoint carries a finite ``dynamic_scale`` and the
    parameters moved (``_fp16_facts``). Then ViT-B/16 at ``--flash auto``:
    its probe times the float16 kernels at the float16 key, and its steps
    launch them as the verdict says."""
    root = tempfile.mkdtemp(prefix="tpudist_torch_fp16_")
    prev = os.environ.get("TPUDIST_DISPATCH_CACHE")
    os.environ["TPUDIST_DISPATCH_CACHE"] = os.path.join(root, "cache")
    common = ["--synthetic", "--image-size", str(TRAIN_PX), "--num-classes",
              "1000", "--use_amp", "--amp-dtype", "float16", "--epochs", "1",
              "-p", "4", "--keep-checkpoints", "0", "--telemetry", "--seed",
              "0"]
    r18 = common + ["-a", "resnet18", "-b", str(TRAIN_B),
                    "--synthetic-size", str(FP16_STEPS * TRAIN_B)]
    try:
        out = {"phase": "fp16_cli"}
        # --fused-bn auto: the launches a step follow the verdicts.
        outdir = os.path.join(root, "resnet18_auto")
        text, events, launches = _run_cli(r18 + ["--outpath", outdir],
                                          "resnet18 float16 auto")
        rows = [{"key": m.group(1), "sites": int(m.group(3)),
                 "cuda_ms": m.group(4) and float(m.group(4)),
                 "plain_ms": m.group(5) and float(m.group(5)),
                 "kernel": m.group(7), "source": m.group(8)}
                for m in _verdicts(text, NORM_VERDICT_RE)]
        per_step = dict.fromkeys(fn.KERNELS, 0)
        for r in rows:
            if r["kernel"] == "cuda":
                res = r["key"].endswith("_res")
                for k in (("bn_act_fwd_res", "bn_act_bwd_res") if res
                          else ("bn_act_fwd", "bn_act_bwd")):
                    per_step[k] += r["sites"]
        probe = _counts(text, PROBE_LINE_RE)
        n = sum(e["type"] == "step" for e in events)
        want = {k: n * v + probe.get(k, 0) for k, v in per_step.items()}
        got = {k: launches[k] for k in fn.KERNELS}
        facts = _fp16_facts(text, outdir, "resnet18")
        shutil.rmtree(outdir, ignore_errors=True)
        if len(rows) != 9 or any(not r["key"].endswith(
                ("_float16_plain", "_float16_res")) or r["cuda_ms"] is None
                or r["source"] != "measured" for r in rows) \
                or not sum(probe.values()) or got != want \
                or n != FP16_STEPS:
            raise RuntimeError(f"resnet18 float16 --fused-bn auto: verdicts "
                               f"{rows}, probes {probe}, launches {got} "
                               f"over {n} steps, want {want}")
        out["resnet18_auto"] = {"verdicts": rows, "probe_launches": probe,
                                "launches": got, "launches_per_step":
                                per_step, "steps": n, **facts}
        out["resnet18_accum2_on"] = _fp16_cli_run(
            r18 + ["--accum-steps", "2", "--fused-bn", "on"],
            "resnet18_accum2_on", "resnet18",
            {k: 2 * v for k, v in R18_PER_STEP.items()}, {}, root)
        vit = common + ["-a", "vit_b_16", "-b", str(VIT_B), "--optimizer",
                        "adamw", "--lr", "1e-3", "--weight-decay", "0.05",
                        "--synthetic-size", str(FP16_STEPS * VIT_B)]
        out["vit_b_16_flash_on"] = _fp16_cli_run(
            vit + ["--flash", "on"], "vit_b_16_flash_on", "vit_b_16",
            dict.fromkeys(fa.KERNELS, LAYERS), {"flash_fwd": LAYERS}, root)
        # --flash auto: the attention probe times the float16 kernels, and
        # the step launches them or not as the verdict says.
        outdir = os.path.join(root, "vit_b_16_auto")
        text, events, launches = _run_cli(
            vit + ["--flash", "auto", "--outpath", outdir],
            "ViT-B/16 float16 --flash auto")
        shutil.rmtree(outdir, ignore_errors=True)
        verdicts = [m for m in _verdicts(text, ATTN_VERDICT_RE)
                    if m.group(3)]
        probe = _counts(text, PROBE_LINE_RE)
        n = sum(e["type"] == "step" for e in events)
        flash = bool(verdicts) and verdicts[0].group(1) == "flash"
        want = {k: (LAYERS * (n + (FP16_STEPS // 2 if k == "flash_fwd"
                                    else 0)) if flash else 0)
                + probe.get(k, 0) for k in fa.KERNELS}
        got = {k: launches[k] for k in fa.KERNELS}
        if len(verdicts) != 1 or verdicts[0].group(2) != "measured" \
                or verdicts[0].group(3) != \
                f"b{VIT_B}_t{SERVE_T}_h{SERVE_H}_d{SERVE_D}_float16_train_full" \
                or not sum(probe.values()) or got != want:
            raise RuntimeError(f"ViT-B/16 float16 --flash auto: verdicts "
                               f"{[v.group(0) for v in verdicts]}, probes "
                               f"{probe}, launches {got}, want {want}")
        v = verdicts[0]
        out["vit_b_16_flash_auto"] = {
            "key": v.group(3), "kernel": v.group(1),
            "flash_ms": float(v.group(4)), "plain_ms": float(v.group(5)),
            "margin": float(v.group(6)) / 100, "probe_launches": probe,
            "launches": got, "steps": n}
    finally:
        if prev is None:
            os.environ.pop("TPUDIST_DISPATCH_CACHE", None)
        else:
            os.environ["TPUDIST_DISPATCH_CACHE"] = prev
        shutil.rmtree(root, ignore_errors=True)
    emit(out)
    return out


# A probe's kernel side against this run's event-timed kernels at the same
# rows or larger: a probe that read the host's pace (PR 11's first design
# read 0.56-1.9 ms a call whatever the rows) lands far above, a device-timed
# one at most the kernels plus the probe's own small ops (the fold, a cast
# and a sum, autograd's fills). And from resnet18's smallest workload (layer4,
# 3.2 M elements) to its stem (103 M) device time must grow.
PROBE_KERNEL_FACTOR, PROBE_SLACK_MS, PROBE_GROWTH = 3.0, 0.1, 3.0


def _norm_probe_faults(verdicts: list, norm: dict) -> list:
    """What is wrong with the measured fused-norm verdicts as device
    times: each kernel side within ``PROBE_KERNEL_FACTOR`` × (B1 + B3 or
    B2 + B4 at twice its rows, ``fused_norm_vs_plain``) +
    ``PROBE_SLACK_MS``; both sides of the largest workload
    ``PROBE_GROWTH`` × those of the smallest."""
    kms = {(r["kernel"], r["shape"][0], r["shape"][1]): r["kernel_ms"]
           for r in norm["cases"] if r["dtype"] == "bfloat16"}
    bad, sized = [], []
    for r in verdicts:
        m = re.match(r"m(\d+)_c(\d+)_", r["key"])
        rows, c = int(m.group(1)), int(m.group(2))
        res = "_res" if r["key"].endswith("_res") else ""
        kernels = kms[(f"bn_act_fwd{res}", ACCUM * rows, c)] \
            + kms[(f"bn_act_bwd{res}", ACCUM * rows, c)]
        r["kernels_ms_at_batch"] = kernels
        if r["cuda_ms"] > PROBE_KERNEL_FACTOR * kernels + PROBE_SLACK_MS:
            bad.append(f"{r['key']}: probe {r['cuda_ms']} ms against its "
                       f"kernels' {kernels:.4f} ms at {ACCUM * rows} rows")
        sized.append((rows * c, r))
    lo, hi = min(sized, key=lambda t: t[0])[1], max(sized,
                                                     key=lambda t: t[0])[1]
    for side in ("cuda_ms", "plain_ms"):
        if hi[side] < PROBE_GROWTH * lo[side]:
            bad.append(f"{side} {hi[side]} at {hi['key']} is not "
                       f"{PROBE_GROWTH}x {lo[side]} at {lo['key']}")
    return bad


def _flash_probe_fault(flash_ms: float, kernels_ms: float,
                       key: str) -> list:
    """The attention probe's flash side against this run's event-timed
    B5 (+ B6 + B7) at the same shape."""
    if flash_ms > PROBE_KERNEL_FACTOR * kernels_ms + PROBE_SLACK_MS:
        return [f"{key}: probe {flash_ms} ms against its kernels' "
                f"{kernels_ms:.4f} ms"]
    return []


def _step_ms_by_epilogue(root: str, steps: int = 8) -> dict:
    """The synchronised wall of one resnet18 step of ``DISPATCH_R18`` (two
    microbatches, mixed) with the cached ``auto`` verdicts, every site on
    the kernels (``on``) and none (``off``), on one device batch, in turns
    auto, on, off, off, on, auto: ms a step (median of ``steps`` after 2)
    per turn."""
    from tpudist_torch.trainer import Trainer
    images, labels = _device_batch(7)
    out = {}
    for mode in ("auto", "on", "off", "off", "on", "auto"):
        argv = [a for a in DISPATCH_R18 if a != "--telemetry"]
        tr = Trainer(config_lib.from_args(argv + [
            "--fused-bn", mode, "--outpath", os.path.join(root, "steps"),
            "--overwrite", "delete"]))
        times = []
        for _ in range(steps + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_step(images, labels, 0.1)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out.setdefault(mode, []).append(statistics.median(times[2:]))
        del tr
    shutil.rmtree(os.path.join(root, "steps"), ignore_errors=True)
    return out


def phase_dispatch_auto(card: dict, kern: dict, bwd: dict,
                        norm: dict) -> dict:
    """``--fused-bn auto`` and ``--flash auto`` (the default) on the card:
    resnet18 and ViT-B/16 at full width with ``--accum-steps 2`` and
    mixup/cutmix, twice each under a fresh ``TPUDIST_DISPATCH_CACHE``.
    The first run measures every workload (each verdict printed with both
    sides' ms and the margin), the second reads every verdict from the
    cache and measures nothing. One resnet18 step is then timed under the
    cached verdicts, all kernels and none (``_step_ms_by_epilogue``), and
    ViT-B/16 is served with no ``--flash`` flag: the eval workload of the
    largest bucket. Every measured kernel side must read as device time
    against the kernels this run timed (``_norm_probe_faults``,
    ``_flash_probe_fault``)."""
    fwd = {r["shape"][0]: r["kernel_ms"] for r in kern["cases"]
           if r["case"].startswith(("serve_", "train_"))}
    train_flash = fwd[VIT_B] + bwd["cases"][0]["flash_bwd_dq"]["kernel_ms"] \
        + bwd["cases"][0]["flash_bwd_dkv"]["kernel_ms"]
    root = tempfile.mkdtemp(prefix="tpudist_torch_dispatch_")
    prev = os.environ.get("TPUDIST_DISPATCH_CACHE")
    os.environ["TPUDIST_DISPATCH_CACHE"] = os.path.join(root, "cache")
    out = {"phase": "dispatch_auto", "card": card["nvidia_smi"],
           "accum_steps": ACCUM}
    try:
        for arch, argv, vit in (("resnet18", DISPATCH_R18, False),
                                ("vit_b_16", DISPATCH_VIT, True)):
            first = _dispatch_run(argv, root, f"{arch}_measure", vit)
            again = _dispatch_run(argv, root, f"{arch}_cached", vit)
            if first["sources"] != ["measured"] \
                    or again["sources"] != ["cache"] \
                    or again["probe_launches"] or not first["probe_launches"] \
                    or [(r["key"], r["kernel"]) for r in first["verdicts"]] \
                    != [(r["key"], r["kernel"]) for r in again["verdicts"]]:
                raise RuntimeError(f"dispatch_auto {arch}: the second run "
                                   f"did not read the first's verdicts: "
                                   f"{first} then {again}")
            rows = first["verdicts"]
            bad = (_flash_probe_fault(rows[0]["flash_ms"], train_flash,
                                      rows[0]["key"]) if vit
                   else _norm_probe_faults(rows, norm))
            if bad:
                raise RuntimeError(f"dispatch_auto {arch}: the probe did "
                                   f"not time the card: {'; '.join(bad)}")
            out[arch] = {"measure": first, "cached": again}
        out["resnet18"]["step_ms"] = _step_ms_by_epilogue(root)
        text, summary, launches, calls = _serve_run(
            ["-a", "vit_b_16", "--image-size", "224", "--buckets",
             ",".join(map(str, BUCKETS)), "--load-rate", "20",
             "--load-duration", "1", "--seed", "0"],
            "serving ViT-B/16 under --flash auto")
        m = [m for m in _verdicts(text, ATTN_VERDICT_RE) if m.group(3)]
        if len(m) != 1 or m[0].group(2) != "measured":
            raise RuntimeError(f"serve --flash auto verdict: {text[-2000:]}")
        bad = _flash_probe_fault(float(m[0].group(4)), fwd[max(BUCKETS)],
                                 m[0].group(3))
        if bad:
            raise RuntimeError(f"serve --flash auto: the probe did not time "
                               f"the card: {bad}")
        flash = m[0].group(1) == "flash"
        probe = launches["flash_fwd"] - (LAYERS * calls if flash else 0)
        # dispatch.measure_ms's calls of one side, one launch each: 2 warm,
        # then 10 for each of 3 repeats (and 10 for each repeat the host
        # fell behind).
        if probe < 32 or (probe - 2) % 10 or launches["flash_bwd_dq"] \
                or launches["flash_bwd_dkv"]:
            raise RuntimeError(f"serve --flash auto: launches {launches} "
                               f"for {calls} bucket calls, verdict "
                               f"{m[0].group(0)}")
        out["serve"] = {"key": m[0].group(3), "kernel": m[0].group(1),
                        "flash_ms": float(m[0].group(4)),
                        "plain_ms": float(m[0].group(5)),
                        "margin": float(m[0].group(6)) / 100,
                        "bucket_calls": calls, "launches": launches,
                        "probe_launches": probe, "summary": summary}
    finally:
        if prev is None:
            os.environ.pop("TPUDIST_DISPATCH_CACHE", None)
        else:
            os.environ["TPUDIST_DISPATCH_CACHE"] = prev
        shutil.rmtree(root, ignore_errors=True)
    emit(out)
    return out


def _accum_setup(vit: bool):
    """``setup(on, dtype)`` for ``compare_on_off``: resnet18 (batch
    TRAIN_B) or ViT-B/16 (SGD) under ``--accum-steps 2`` with mixup and
    cutmix, the kernels on or off. The mixing draws are seeded by (seed 0,
    optimizer step, rank 0), so both runs mix alike."""
    def setup(on: bool, dtype):
        common = dict(image_size=TRAIN_PX, accum_steps=ACCUM,
                      mixup_alpha=0.2, cutmix_alpha=1.0,
                      label_smoothing=0.1, seed=0)
        if vit:
            cfg = config_lib.Config(arch="vit_b_16", batch_size=VIT_CMP_B,
                                    flash="on" if on else "off", **common)
            model = create_model("vit_b_16", dtype=dtype, flash=on,
                                 image_size=TRAIN_PX)
            model.load_state_dict(_seed0_weights("vit_b_16",
                                                 image_size=TRAIN_PX))
        else:
            cfg = config_lib.Config(batch_size=TRAIN_B,
                                    fused_bn="on" if on else "off",
                                    **common)
            model = create_model("resnet18", dtype=dtype, fused_bn=on)
            model.reset_parameters(torch.Generator().manual_seed(0))
        model.cuda()
        return model, train_lib.make_train_step(
            model, train_lib.make_optimizer(model, cfg), cfg)
    return setup


def _blend_ms() -> dict:
    """The mixup blend on the card at batch TRAIN_B, 224 px: ``apply_mix``
    (rounded once, through f64) against the same blend in f32 rounded
    twice, ms a call (CUDA events, median of 25 × 10), and whether the
    two differ anywhere."""
    images, labels = _device_batch(11)
    draw = mixup.MixDraw(torch.randperm(TRAIN_B), True, 0.3711,
                         (0, 0, 0, 0))
    lam = float(np.float32(draw.lam))
    rest = float(np.float32(1.0) - np.float32(draw.lam))
    perm = draw.perm.cuda()

    def twice():
        return images * lam + images[perm] * rest
    once_out = mixup.apply_mix(images, labels, draw)[0]
    return {"batch": TRAIN_B, "once_f64_ms": time_ms(
                lambda: mixup.apply_mix(images, labels, draw)),
            "twice_f32_ms": time_ms(twice),
            "share_differing": (once_out != twice()).float().mean().item()}


def phase_accum_mixup() -> dict:
    """Optimizer steps of two microbatches on mixed batches, kernels on
    against kernels off from one seed on the same batches and the same
    draws, held to the on/off bounds of ``fused_vs_plain_train`` (resnet18)
    and ``flash_vs_plain_train`` (ViT-B/16); the kernels must launch once a
    site a microbatch: B1–B4 18/16/18/16 and B5–B7 24/24/24 a step."""
    out = {"phase": "accum_mixup", "accum_steps": ACCUM, "steps":
           TRAIN_CMP_STEPS}
    for arch, vit, batch, lr, tols, kernels, per_mb in (
            ("resnet18", False, TRAIN_B, 0.1,
             (TRAIN_LOSS_TOL, TRAIN_STATE_TOL), fn.KERNELS, R18_PER_STEP),
            ("vit_b_16", True, VIT_CMP_B, VIT_CMP_LR,
             (VIT_LOSS_TOL, VIT_STATE_TOL), fa.KERNELS,
             dict.fromkeys(fa.KERNELS, LAYERS))):
        rows = []
        for dtype in (torch.bfloat16, torch.float32):
            fn.reset_counts()
            fa.reset_counts()
            row = compare_on_off(_accum_setup(vit), dtype, batch, lr)
            launches = {**fn.LAUNCHES, **fa.LAUNCHES}
            want = {k: ACCUM * v * TRAIN_CMP_STEPS for k, v in per_mb.items()}
            bad = _held_on_off(row, *tols, f"{arch} accum/mixup on vs off")
            if {k: launches[k] for k in kernels} != want:
                bad.append(f"launches {launches}, want {want}")
            if bad:
                raise RuntimeError(f"{'; '.join(bad)}: {row}")
            rows.append(dict(row, launches_per_step={
                k: launches[k] // TRAIN_CMP_STEPS for k in kernels},
                loss_tol_relative=tols[0][row["dtype"]],
                state_tol=tols[1][row["dtype"]]))
        out[arch] = {"batch": batch, "lr": lr, "rows": rows}
    out["blend"] = _blend_ms()
    emit(out)
    return out


# -- the fault planes in this process: the doctor and the flight recorder ----

# resnet18 through the trainer at full width, bf16, --fused-bn on: one
# 8-step epoch of synthetic ImageNet-sized data (lr 0.01, where the
# natural loss stays far under a 6-sigma spike), probes every 4 steps.
DOCTOR_R18 = ["-a", "resnet18", "--use_amp", "--fused-bn", "on", "-b",
              str(TRAIN_B), "--synthetic", "--image-size", str(TRAIN_PX),
              "--num-classes", "1000", "--synthetic-size", str(8 * TRAIN_B),
              "-p", "4",
              "--lr", "0.01", "--telemetry", "--seed", "0", "--doctor",
              "--doctor-probe-freq", "4", "--keep-checkpoints", "1"]
# The step the guard's cost is timed over: guard off and on alternate in
# blocks, each step synchronised and timed between CUDA events.
GUARD_BLOCKS, GUARD_STEPS = 4, 5
# ViT-B/16's nanbomb case: full width, a small batch.
DOCTOR_VIT_B = 32


class _SkippedStep:
    """Wraps the trainer's ``make_train_step``: at the first step function
    made, call ``index`` (the NaN batch's) is held — the state before it
    (parameters, buffers, the optimizer's state, the EMA) against the
    state after it, bit for bit, and the kernel launches it made."""

    def __init__(self, index: int):
        self.index = index
        self.row: dict | None = None
        self.made = 0
        self.real = None

    def make(self, model, optimizer, cfg, ema=None, **kw):
        step = self.real(model, optimizer, cfg, ema=ema, **kw)
        self.made += 1
        if self.made > 1:              # a rollback's rebuilt step
            return step
        net = getattr(model, "module", model)
        calls = [0]

        def held(images, labels, lr):
            i = calls[0]
            calls[0] += 1
            if i != self.index:
                return step(images, labels, lr)
            torch.cuda.synchronize()
            before = _state_bits(net, optimizer, ema)
            counts = {**fn.LAUNCHES, **fa.LAUNCHES}
            out = step(images, labels, lr)
            torch.cuda.synchronize()
            after = _state_bits(net, optimizer, ema)
            self.row = {
                "tensors": len(before),
                "changed": sorted(k for k in before
                                  if not torch.equal(before[k], after[k])),
                "notfinite": float(out["notfinite"]),
                "gnorm_finite": bool(torch.isfinite(out["gnorm"])),
                "launches": {k: v - counts[k] for k, v in {
                    **fn.LAUNCHES, **fa.LAUNCHES}.items()
                    if v != counts[k]}}
            return out

        return held


def _state_bits(net, optimizer, ema) -> dict:
    """Every tensor a step moves, as a copy of its raw bytes."""
    out = dict(net.state_dict())
    out = {f"model/{k}": v for k, v in out.items()}
    for i, p in enumerate(net.parameters()):
        for k, v in optimizer.state.get(p, {}).items():
            if torch.is_tensor(v):
                out[f"opt/{i}/{k}"] = v
    if ema is not None:
        out.update({f"ema/{k}": v for k, v in ema.state_dict().items()})
    return {k: v.detach().contiguous().clone().reshape(-1).view(torch.uint8)
            for k, v in out.items()}


def _doctor_run(args: list, what: str, skipped: int | None = None):
    """``_run_cli`` of a ``--doctor`` run, its train step wrapped by
    ``_SkippedStep(skipped)``: the output, events, launches and the held
    step's row."""
    from tpudist_torch import trainer as trainer_lib
    hold = _SkippedStep(-1 if skipped is None else skipped)
    hold.real = trainer_lib.make_train_step
    trainer_lib.make_train_step = hold.make
    try:
        text, events, launches = _run_cli(args, what)
    finally:
        trainer_lib.make_train_step = hold.real
    return text, events, launches, hold.row


def _guard_cost(setup, batch, lr: float) -> dict:
    """The synchronised step with the guard and without it, on the same
    model and batch: ``setup(guard)`` → (model, step); the blocks
    alternate off, on, ...; each step between CUDA events."""
    times = {False: [], True: []}
    steps = {}
    for guard in (False, True):
        steps[guard] = setup(guard)
        for _ in range(2):             # warm: allocator, cuDNN, copies
            steps[guard][1](*batch, lr)
    for _ in range(GUARD_BLOCKS):
        for guard in (False, True):
            step = steps[guard][1]
            for _ in range(GUARD_STEPS):
                torch.cuda.synchronize()
                a, b = torch.cuda.Event(True), torch.cuda.Event(True)
                a.record()
                step(*batch, lr)
                b.record()
                b.synchronize()
                times[guard].append(a.elapsed_time(b))
    off, on = (statistics.median(times[g]) for g in (False, True))
    del steps
    return {"off_ms": off, "on_ms": on, "guard_ms": on - off,
            "guard_share": (on - off) / off, "off_ms_min": min(times[False]),
            "on_ms_min": min(times[True]), "steps": len(times[True])}


def _r18_guarded(guard: bool):
    cfg = config_lib.Config(batch_size=TRAIN_B, image_size=TRAIN_PX,
                            fused_bn="on", doctor=guard)
    model = create_model("resnet18", dtype=torch.bfloat16, fused_bn=True)
    model.load_state_dict(_seed0_weights("resnet18"))
    model.cuda()
    opt = train_lib.make_optimizer(model, cfg)
    return model, train_lib.make_train_step(model, opt, cfg, guard=guard)


def _vit_guarded(guard: bool):
    cfg = config_lib.Config(arch="vit_b_16", batch_size=DOCTOR_VIT_B,
                            image_size=TRAIN_PX, optimizer="adamw",
                            flash="on", doctor=guard)
    model = create_model("vit_b_16", dtype=torch.bfloat16, flash=True,
                         image_size=TRAIN_PX)
    model.load_state_dict(_seed0_weights("vit_b_16", image_size=TRAIN_PX))
    model.cuda()
    opt = train_lib.make_optimizer(model, cfg)
    step = train_lib.make_train_step(model, opt, cfg, guard=guard)
    step.optimizer = opt
    return model, step


def _doctor_events(events: list) -> list:
    return [(e["action"], e.get("step")) for e in events
            if e["type"] == "doctor"]


def phase_doctor(root: str, card: dict) -> dict:
    """The doctor and the flight recorder on the card, in this process.

    - ``guard_cost``: resnet18's synchronised step (batch 256, bf16, B1–B4)
      with the guard and without it, and ViT-B/16's (batch 32, AdamW,
      B5–B7; its step count lives on the card, capturable).
    - ``nanbomb``: resnet18 through the trainer with ``--doctor
      --blackbox``, ``nanbomb`` at steps 3, 4 and 5 under
      ``--doctor-max-skips 3``: step 3 leaves every parameter, momentum
      buffer and BN running buffer bit for bit as it found it while B1–B4
      launch 9/8/9/8 in it; three ``skip_step`` events, then a
      ``persistent_nonfinite`` rollback (no checkpoint yet: the seeded
      initial state) and epoch 0's replay minus the three batches (5
      steps). The recorder dumps on the ``fault`` and the ``doctor``
      triggers, and its deep capture's ``torch.profiler`` trace holds
      B1–B4 9/8/9/8 a step.
    - ``lossbomb``: two epochs, ``lossbomb@step=10`` under
      ``--doctor-spike-min-steps 4``: the probe at step 8 stamps epoch 0's
      checkpoint good, the spike at step 10 rolls back to it (the walk
      says probe-verified good) and epoch 1 replays minus step 10's batch
      (7 steps, 15 landed updates in the file).
    - ``vit``: ViT-B/16 at batch 32 with ``--flash on`` and AdamW, a NaN
      batch: skipped, B5–B7 12/12/12 in it, the state bit-equal (the
      AdamW step count included)."""
    torch.backends.cudnn.allow_tf32 = False
    out = {"phase": "doctor", "card": card["nvidia_smi"]}
    # The guard's cost.
    r18_batch = _device_batch(11)
    out["guard_cost_resnet18"] = dict(
        _guard_cost(_r18_guarded, r18_batch, 0.01), batch=TRAIN_B,
        dtype="bfloat16")
    vit_batch = _device_batch(12, batch=DOCTOR_VIT_B)
    out["guard_cost_vit_b_16"] = dict(
        _guard_cost(_vit_guarded, vit_batch, 1e-3), batch=DOCTOR_VIT_B,
        dtype="bfloat16", optimizer="adamw")
    del r18_batch, vit_batch
    gc.collect()
    torch.cuda.empty_cache()

    # nanbomb: the skip, the escalation, the recorder.
    d1 = os.path.join(root, "doctor_nanbomb")
    text, events, launches, held = _doctor_run(
        DOCTOR_R18 + ["--epochs", "1", "--doctor-max-skips", "3",
                      "--blackbox", "--blackbox-capture-steps", "2",
                      "--inject",
                      "nanbomb@step=3;nanbomb@step=4;nanbomb@step=5",
                      "--outpath", d1], "the nanbomb run", skipped=3)
    acts = _doctor_events(events)
    rb = [e for e in events if e["type"] == "doctor"
          and e["action"] == "rollback"]
    steps = sum(e["type"] == "step" for e in events)
    want = {k: v * steps for k, v in R18_PER_STEP.items()}
    got = {k: launches[k] for k in fn.KERNELS}
    if held is None or held["changed"] or held["notfinite"] != 1.0 \
            or held["launches"] != R18_PER_STEP \
            or acts[:4] != [("skip_step", 3), ("skip_step", 4),
                            ("skip_step", 5), ("rollback", 5)] \
            or rb[0]["reason"] != "persistent_nonfinite" \
            or (rb[0]["window_start"], rb[0]["window_end"]) != (
                3 * TRAIN_B, 6 * TRAIN_B) \
            or "rolling back to the seeded initial state" not in text \
            or steps != 7 + 5 or got != want:
        raise RuntimeError(f"doctor nanbomb: held step {held}, doctor "
                           f"{acts}, rollback {rb}, {steps} steps, "
                           f"launches {got}")
    bbdir = os.path.join(d1, "blackbox")
    dumps = sorted(f for f in os.listdir(bbdir) if f.startswith("dump."))
    with open(os.path.join(bbdir, dumps[0])) as f:
        first_dump = json.load(f)
    triggers = []
    for name in dumps:
        with open(os.path.join(bbdir, name)) as f:
            triggers.append(json.load(f)["trigger"])
    traces = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(bbdir)
                    for f in fs if f.endswith(".pt.trace.json"))
    if not traces:
        raise RuntimeError(f"doctor nanbomb: no deep-capture trace in "
                           f"{os.listdir(bbdir)}")
    capture = _trace_norm_launches(traces[0], range(4, 6))
    incidents = [(e["trigger"], e["captured"]) for e in events
                 if e["type"] == "incident"]
    if triggers[:2] != ["fault", "doctor"] \
            or capture["total"] != {k: 2 * v for k, v in
                                    R18_PER_STEP.items()} \
            or ("doctor", 1) not in incidents:
        raise RuntimeError(f"doctor nanbomb's recorder: dumps {triggers}, "
                           f"capture {capture}, incidents {incidents}")
    out["nanbomb"] = {
        "skipped_step": held, "doctor": acts, "rollback": rb[0],
        "train_steps": steps, "fused_norm_launches": got,
        "dumps": triggers, "first_dump_ring_rows": len(first_dump["ring"]),
        "capture_trace": os.path.basename(traces[0]),
        "capture_norm_launches": capture["total"],
        "capture_kernel_events": capture["kernel_events"],
        "capture_mb": capture["mb"], "incidents": incidents}
    shutil.rmtree(d1, ignore_errors=True)

    # lossbomb: the spike and the rollback to the verified-good file.
    d2 = os.path.join(root, "doctor_lossbomb")
    text, events, launches, _ = _doctor_run(
        DOCTOR_R18 + ["--epochs", "2", "--doctor-spike-min-steps", "4",
                      "--inject", "lossbomb@step=10", "--outpath", d2],
        "the lossbomb run")
    acts = _doctor_events(events)
    rb = [e for e in events if e["type"] == "doctor"
          and e["action"] == "rollback"]
    epochs = [e["epoch"] for e in events if e["type"] == "step"]
    tree = ckpt_lib.load_checkpoint(d2)
    got = {k: launches[k] for k in fn.KERNELS}
    want = {k: v * len(epochs) for k, v in R18_PER_STEP.items()}
    spike = next((e for e in events if e["type"] == "doctor"
                  and e["action"] == "spike"), None)
    if spike is None or spike["step"] != 10 or len(rb) != 1 \
            or rb[0]["reason"] != "loss_spike" or rb[0]["to_epoch"] != 1 \
            or (rb[0]["window_epoch"], rb[0]["window_start"],
                rb[0]["window_end"]) != (1, 2 * TRAIN_B, 3 * TRAIN_B) \
            or "(probe-verified good)" not in text \
            or "excised (7 steps remain)" not in text \
            or epochs != [0] * 8 + [1] * 4 + [1] * 7 \
            or int(tree["state"]["opt_state"]["count"]) != 15 \
            or int(tree["state"]["step"]) != 15 or got != want:
        raise RuntimeError(f"doctor lossbomb: doctor {acts}, rollback {rb}, "
                           f"epochs {epochs}, count "
                           f"{tree['state']['opt_state']['count']}, "
                           f"launches {got}")
    del tree
    out["lossbomb"] = {"doctor": acts, "spike": spike, "rollback": rb[0],
                       "steps_by_epoch": {str(e): epochs.count(e)
                                          for e in sorted(set(epochs))},
                       "replayed_steps": 7, "fused_norm_launches": got}
    shutil.rmtree(d2, ignore_errors=True)

    # ViT-B/16: the NaN batch through B5–B7.
    faults.configure("nanbomb@step=1")
    try:
        model, step = _vit_guarded(True)
        images, labels = _device_batch(13, batch=DOCTOR_VIT_B)
        step(images, labels, 1e-3)     # a landed step: AdamW's moments
        hold = _SkippedStep(0)
        hold.real = lambda *a, **k: step
        held_step = hold.make(model, step.optimizer, None)
        held_out = held_step(faults.maybe_nanbomb(1, images), labels, 1e-3)
        vit = dict(hold.row,
                   loss_finite=bool(torch.isfinite(held_out["loss"])),
                   batch=DOCTOR_VIT_B, optimizer="adamw")
    finally:
        faults.configure("")
    if vit["changed"] or vit["notfinite"] != 1.0 \
            or vit["launches"] != {k: LAYERS for k in fa.KERNELS}:
        raise RuntimeError(f"doctor vit: {vit}")
    out["vit_b_16"] = vit
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    return out


# -- phase 8: ImageFolder data on the card's host ------------------------------

# The corpus: 8 classes of make_synth_imagefolder.py's stationary textures,
# 160 train and 32 val images a class, at 384 px (about ImageNet's mean
# edge).
CORPUS_SHAPE = (8, 160, 32, 384)
CORPUS_TRAIN, CORPUS_VAL = 8 * 160, 8 * 32
TRUNCATED = os.path.join("train", "class_003", "00077.jpg")
HOST_IMAGES = 32                 # images of the single-thread host check
# tests/test_native.py's tolerances: the native kernel against the numpy
# bilinear reference of the same box (:49), and a native path against the
# PIL stack (:131-132; mean and max |Δ| in normalized units).
NATIVE_REF_TOL = 1e-4
NATIVE_PIL_TOL = {"mean": 0.05, "max": 0.5}


def _first_line(cmd: list) -> str:
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except OSError as e:
        return f"not found ({e})"
    lines = (r.stdout or r.stderr).strip().splitlines()
    return lines[0] if lines else f"exit {r.returncode}"


def phase_image_decode() -> dict:
    """What the card's host offers for decoding images, and the data path
    the port takes on it: PIL's version, torchvision or not, ``jpeglib.h``,
    ``libjpeg.so`` and nvJPEG, the cores and the compiler; the native
    libraries are built here (``g++``, at first use)."""
    import ctypes.util
    import glob
    import importlib.util

    import PIL
    t0 = time.perf_counter()
    native_ok = data_native.available()
    jpeg_ok = data_native.jpeg_available()
    build_s = time.perf_counter() - t0
    cuda = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    nvjpeg = sorted(glob.glob(os.path.join(cuda, "include", "nvjpeg.h"))
                    + glob.glob(os.path.join(cuda, "lib64", "libnvjpeg.so*"))
                    + glob.glob(os.path.join(cuda, "targets", "*", "lib",
                                             "libnvjpeg.so*")))

    def paths(**kw):
        return {split: f"{p} ({why})" for split, (p, why) in
                data_lib.choose_paths(config_lib.Config(data="DIR", **kw))
                .items()}

    out = {"phase": "image_decode", "pil": PIL.__version__,
           "torchvision": importlib.util.find_spec("torchvision")
           is not None,
           "jpeglib_h": data_native.jpeg_header(),
           "libjpeg_so": ctypes.util.find_library("jpeg"),
           "nvjpeg": nvjpeg, "cpu_count": os.cpu_count(),
           "cpu_affinity": len(os.sched_getaffinity(0)),
           "gxx": _first_line([data_native.compiler() or "g++",
                               "--version"]),
           "native_transforms": native_ok, "native_jpeg": jpeg_ok,
           "native_build_s": build_s,
           "data_path": paths(),
           "data_path_with_augments": paths(auto_augment="ra",
                                            random_erase=0.25)}
    emit(out)
    if not native_ok:
        raise RuntimeError("csrc/transforms.cc was not built on the card's "
                           "host: no g++")
    return out


# One writer of the corpus: every shards-th image of the tree, drawn by
# benchmarks/make_synth_imagefolder.py's render() from a generator seeded
# by its (split, class, index), so the tree does not depend on the shards.
CORPUS_WRITER = r"""
import importlib.util, os, sys
import numpy as np
script, root = sys.argv[1], sys.argv[2]
classes, train, val, size, shard, shards = map(int, sys.argv[3:9])
spec = importlib.util.spec_from_file_location("synth", script)
synth = importlib.util.module_from_spec(spec)
spec.loader.exec_module(synth)
jobs = [(split, c, i) for split, per in (("train", train), ("val", val))
        for c in range(classes) for i in range(per)]
for split, c, i in jobs[shard::shards]:
    d = os.path.join(root, split, f"class_{c:03d}")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng([0, split == "val", c, i])
    synth.render(rng, size, c).save(os.path.join(d, f"{i:05d}.jpg"),
                                    quality=88)
"""


def phase_imagefolder_corpus(root: str) -> dict:
    """A JPEG tree of ``benchmarks/make_synth_imagefolder.py``'s images (its
    ``render``, 8 base classes at 384 px), written by one process a host
    core; one train JPEG is then cut to half its bytes (a corrupt sample
    for the skip path)."""
    import glob
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "benchmarks", "make_synth_imagefolder.py")
    shards = max(1, min(len(os.sched_getaffinity(0)), 32))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", CORPUS_WRITER, script, root,
         *map(str, CORPUS_SHAPE), str(k), str(shards)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(shards)]
    errors = []
    for proc in procs:
        _, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            errors.append(f"exit {proc.returncode}: {err[-1000:]}")
    seconds = time.perf_counter() - t0
    if errors:
        raise RuntimeError(f"writing the corpus failed: {errors}")
    counts = {split: len(glob.glob(os.path.join(root, split, "*", "*.jpg")))
              for split in ("train", "val")}
    if counts != {"train": CORPUS_TRAIN, "val": CORPUS_VAL}:
        raise RuntimeError(f"the corpus holds {counts}")
    sizes = [os.path.getsize(f) for f in glob.glob(
        os.path.join(root, "*", "*", "*.jpg"))]
    bad = os.path.join(root, TRUNCATED)
    with open(bad, "rb") as f:
        data = f.read()
    with open(bad, "wb") as f:
        f.write(data[:len(data) // 2])
    out = {"phase": "imagefolder_corpus", "seconds": seconds,
           "writers": shards, "files": sum(counts.values()), **counts,
           "mean_kb": statistics.mean(sizes) / 1024,
           "truncated": {"file": TRUNCATED, "bytes": len(data) // 2,
                         "of": len(data)}}
    emit(out)
    return out


def _bilinear_ref(src: np.ndarray, box, out_size: int, flip: bool):
    """numpy reference of ``crop_resize_normalize`` (tpudist's
    ``tests/test_native.py::_bilinear_ref``), in float64."""
    x0, y0, cw, ch = box
    h, w = src.shape[:2]
    oy, ox = np.meshgrid(np.arange(out_size), np.arange(out_size),
                         indexing="ij")
    fy = (oy + 0.5) * (ch / out_size) - 0.5 + y0
    fx = (ox + 0.5) * (cw / out_size) - 0.5 + x0
    y1, x1 = np.floor(fy).astype(int), np.floor(fx).astype(int)
    wy, wx = (fy - y1)[..., None], (fx - x1)[..., None]
    y1c, y2c = np.clip(y1, 0, h - 1), np.clip(y1 + 1, 0, h - 1)
    x1c, x2c = np.clip(x1, 0, w - 1), np.clip(x1 + 1, 0, w - 1)
    s = src.astype(np.float64)
    top = s[y1c, x1c] + (s[y1c, x2c] - s[y1c, x1c]) * wx
    bot = s[y2c, x1c] + (s[y2c, x2c] - s[y2c, x1c]) * wx
    out = top + (bot - top) * wy
    if flip:
        out = out[:, ::-1]
    return (out / 255.0 - data_tf.IMAGENET_MEAN) / data_tf.IMAGENET_STD


def _per_image_ms(fn, items) -> float:
    fn(items[0])
    t0 = time.perf_counter()
    for it in items:
        fn(it)
    return (time.perf_counter() - t0) / len(items) * 1e3


def _threaded_rate(fn, items, threads: int) -> float:
    """Items a second through ``fn`` from ``threads`` threads."""
    it, lock = iter(items), threading.Lock()

    def work():
        while True:
            with lock:
                item = next(it, None)
            if item is None:
                return
            fn(item)

    pool = [threading.Thread(target=work) for _ in range(threads)]
    t0 = time.perf_counter()
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    return len(items) / (time.perf_counter() - t0)


def _diff(a, b) -> tuple[float, float]:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.mean()), float(d.max())


def _val_box(w: int, h: int, size: int, resize: int) -> tuple:
    """The source box ``val_resize_crop_normalize`` crops (its float32
    arithmetic, rounded half away from zero)."""
    f = np.float32
    scale = f(min(w, h)) / f(resize)
    crop = f(size) * scale
    return tuple(int(math.floor(float(v) + 0.5)) for v in (
        (f(w) - crop) * f(0.5), (f(h) - crop) * f(0.5), crop, crop))


def _off_reference(got, ref) -> float:
    """``got``'s largest distance from ``ref``, or raise past 1e-4 + 1e-4
    |ref| (tests/test_native.py:49, :79)."""
    d = np.abs(got - ref)
    if not np.all(d <= NATIVE_REF_TOL + NATIVE_REF_TOL * np.abs(ref)):
        raise RuntimeError(f"a native transform is {d.max()} off its numpy "
                           f"bilinear reference")
    return float(d.max())


def phase_native_vs_plain_host(root: str) -> dict:
    """The port's native train and val transforms against the numpy
    reference and its PIL stack, on the corpus's images, one thread, at
    224 px (val resized to 256):

    - each native transform equals the numpy bilinear reference of its
      box (train: the box and flip its generator draws) within 1e-4;
    - on the same box and flip, PIL's crop-resize is within 0.05 mean and
      0.5 max |Δ| of it where the crop grows or keeps its size; where the
      image shrinks (train crops larger than 224 px, and val's resize to
      256) PIL filters over a wider support (antialiasing) and the native
      kernel samples two pixels a side, so only the mean is held, the max
      reported;
    - ms per image for PIL decode, each native transform and each PIL
      transform (and the native JPEG decode where it was built).

    tpudist's native and PIL train paths draw the crop offset in another
    order (x first; y first), so for one generator they crop different
    windows; the port keeps both orders, and the difference of the two
    whole transforms is reported, not held."""
    import glob

    from PIL import Image
    files = sorted(f for f in glob.glob(os.path.join(root, "train", "*",
                                                     "*.jpg"))
                   if not f.endswith(TRUNCATED))
    files = files[::len(files) // HOST_IMAGES][:HOST_IMAGES]
    raw = []
    for f in files:
        with open(f, "rb") as fh:
            raw.append(fh.read())
    imgs = [Image.open(io.BytesIO(b)).convert("RGB") for b in raw]
    size, resize = TRAIN_PX, 256
    ref_err = {"train": 0.0, "val": 0.0}
    errs = {"train_same_box_grow": [], "train_same_box_shrink": [],
            "val": [], "whole_train": []}
    for i, img in enumerate(imgs):
        arr = np.asarray(img)
        w, h = img.size
        got = data_native.train_transform(img, size,
                                          np.random.default_rng(i))
        rng = np.random.default_rng(i)
        box = data_native.sample_rrc_box(w, h, rng)
        flip = bool(rng.random() < 0.5)
        ref_err["train"] = max(ref_err["train"], _off_reference(
            got, _bilinear_ref(arr, box, size, flip)))
        x0, y0, cw, ch = box
        pil = img.resize((size, size), Image.BILINEAR,
                         box=(x0, y0, x0 + cw, y0 + ch))
        if flip:
            pil = pil.transpose(0)
        key = "train_same_box_" + ("grow" if max(cw, ch) <= size
                                   else "shrink")
        errs[key].append(_diff(got, data_tf.to_normalized_array(pil)))
        val = data_native.val_transform(img, size, resize)
        ref_err["val"] = max(ref_err["val"], _off_reference(
            val, _bilinear_ref(arr, _val_box(w, h, size, resize), size,
                               False)))
        errs["val"].append(_diff(val, data_tf.val_transform(img, size,
                                                            resize)))
        errs["whole_train"].append(_diff(got, data_tf.train_transform(
            img, size, np.random.default_rng(i))))
    summary = {k: {"n": len(v), "mean": max((m for m, _ in v), default=0.0),
                   "max": max((x for _, x in v), default=0.0)}
               for k, v in errs.items()}
    bad = [k for k in ("train_same_box_grow", "train_same_box_shrink",
                       "val") if summary[k]["mean"] >= NATIVE_PIL_TOL["mean"]]
    if summary["train_same_box_grow"]["max"] > NATIVE_PIL_TOL["max"]:
        bad.append("train_same_box_grow (max)")
    ms = {"pil_decode": _per_image_ms(
              lambda b: Image.open(io.BytesIO(b)).convert("RGB"), raw),
          "native_train": _per_image_ms(
              lambda im: data_native.train_transform(
                  im, size, np.random.default_rng(0)), imgs),
          "pil_train": _per_image_ms(
              lambda im: data_tf.train_transform(
                  im, size, np.random.default_rng(0)), imgs),
          "pil_train_ra_erase": _per_image_ms(
              lambda im: data_tf.train_transform(
                  im, size, np.random.default_rng(0),
                  aa=data_aa.build("ra"), random_erase=0.25), imgs),
          "native_val": _per_image_ms(
              lambda im: data_native.val_transform(im, size, resize), imgs),
          "pil_val": _per_image_ms(
              lambda im: data_tf.val_transform(im, size, resize), imgs)}
    # How far each stage of a sample scales over the loader's threads: PIL
    # decode, the uint8 copy, the native crop (the GIL released), all of it.
    workers = min(os.cpu_count() or 1, 32)
    arrs = [np.asarray(im) for im in imgs]
    stages = {
        "pil_decode": (lambda b: Image.open(io.BytesIO(b)).convert("RGB"),
                       raw),
        "to_uint8": (lambda im: np.asarray(im, dtype=np.uint8), imgs),
        "native_crop": (lambda a: data_native.crop_resize_normalize(
            a, (24, 24, 336, 336), size, False), arrs),
        "decode_and_native_train": (
            lambda b: data_native.train_transform(
                Image.open(io.BytesIO(b)).convert("RGB"), size,
                np.random.default_rng(0)), raw)}
    scaling = {name: {f"j{n}": _threaded_rate(fn, items * 4, n)
                      for n in (1, workers)}
               for name, (fn, items) in stages.items()}
    if data_native.jpeg_available():
        ms["native_jpeg_train"] = _per_image_ms(
            lambda b: data_native.decode_train_transform(
                b, size, np.random.default_rng(0)), raw)
    else:
        ms["native_jpeg_train"] = "not measured: no jpeglib.h on this host"
    out = {"phase": "native_vs_plain_host", "images": len(imgs),
           "image_px": list(imgs[0].size), "size": size,
           "val_resize": resize,
           "tolerance": {"reference": NATIVE_REF_TOL, **NATIVE_PIL_TOL},
           "reference_max_abs_err": ref_err, "against_pil": summary,
           "ms_per_image_one_thread": ms,
           "images_per_s_by_threads": scaling,
           "cpu_count": os.cpu_count()}
    emit(out)
    if bad:
        raise RuntimeError(f"native against the PIL stack out of bounds: "
                           f"{bad}")
    return out


def _loader_rate(loader, epochs: int = 2) -> dict:
    """Images/s of ``loader`` alone (nothing consumes the batches):
    over each whole epoch, and 256 over the median time between batches."""
    per_epoch, gaps, skipped = [], [], []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        n = 0
        t0 = t_prev = time.perf_counter()
        for images, _ in loader:
            now = time.perf_counter()
            gaps.append((now - t_prev, len(images)))
            t_prev = now
            n += len(images)
            if not np.isfinite(images).all():
                raise RuntimeError("a loader yielded a non-finite image")
        per_epoch.append(n / (time.perf_counter() - t0))
        skipped.append(loader.samples_skipped)
    gap, n = sorted(gaps)[len(gaps) // 2]
    return {"images_per_s_epoch": per_epoch,
            "images_per_s_median_batch": n / gap,
            "samples_skipped": skipped}


def phase_loader_rates(root: str, step: dict) -> dict:
    """The port's loaders alone at batch 256, 224 px, ``-j`` = the host's
    cores (at most 32): the card's train path (and at ``-j 1``, which says
    how far the worker threads scale), the PIL stack, the PIL stack with
    ``--auto-augment ra --random-erase 0.25`` and the val loader, beside
    the device-resident resnet18 rate of ``train_step_breakdown``."""
    workers = min(os.cpu_count() or 1, 32)
    base = dict(data=root, image_size=TRAIN_PX, batch_size=TRAIN_B,
                workers=workers, seed=0, data_skip_budget=1)
    rows = {}
    for name, kw, native_on, epochs in (
            ("train_card_path", {}, True, 2),
            ("train_card_path_j1", dict(workers=1), True, 1),
            ("train_pil_stack", {}, False, 1),
            ("train_pil_ra_erase", dict(auto_augment="ra",
                                        random_erase=0.25), False, 1)):
        train, val = data_lib.build_train_val_loaders(
            config_lib.Config(**{**base, **kw}).finalize(1),
            use_native=native_on)
        rows[name] = {"path": list(train.data_path), "workers":
                      train.num_workers, **_loader_rate(train, epochs)}
        if rows[name]["samples_skipped"] != [1] * epochs:
            raise RuntimeError(f"{name}: samples_skipped "
                               f"{rows[name]['samples_skipped']} a epoch; "
                               f"the truncated JPEG is one")
        if name == "train_card_path":
            rows["val"] = {"path": list(val.data_path),
                           **_loader_rate(val)}
    device = step["images_per_s"]
    for row in rows.values():
        row["share_of_device_rate"] = (row["images_per_s_median_batch"]
                                       / device)
    out = {"phase": "loader_rates", "batch": TRAIN_B, "size": TRAIN_PX,
           "workers": workers, "cpu_count": os.cpu_count(), **rows,
           "device_resident_resnet18_images_per_s": device}
    emit(out)
    return out


def _imagefolder_run(args: list, what: str, path_line: str,
                     launch_args: tuple = (),
                     outdir: str | None = None,
                     pace_epoch: int | None = None) -> tuple[dict, list]:
    """One ImageFolder run: through the launcher, or with ``outdir`` in
    this process (the kernel counts set to 0 just before it). Its pace
    (images/s, the host's p50s, the waits for data and their shares)
    reads every step after the first (which compiles), the waits' shares
    of the run's wall; with ``pace_epoch``, that epoch's steps alone, the
    shares of their seconds."""
    if outdir is None:
        text, row, events = _launch_trainer(args, what, timeout=600,
                                            launch_args=launch_args)
    else:
        t0 = time.perf_counter()
        text, events, launches = _run_cli(
            args + ["--telemetry", "--seed", "0", "--outpath", outdir], what)
        row = {"wall_s": time.perf_counter() - t0, "launches": launches,
               "train_steps": sum(e["type"] == "step" for e in events)}
    if path_line not in text.splitlines():
        raise RuntimeError(f"{what}: the trainer did not log {path_line!r}")
    epochs = [e for e in events if e["type"] == "epoch"]
    skipped = [e.get("samples_skipped", 0) for e in epochs]
    retried = [e.get("samples_retried", 0) for e in epochs]
    data_lines = [ln for ln in text.splitlines()
                  if ln.startswith("||==> Data: Epoch[")]
    if skipped != [1] * len(epochs) or len(data_lines) != len(epochs):
        raise RuntimeError(f"{what}: samples_skipped {skipped} a epoch "
                           f"and Data lines {data_lines}; the truncated "
                           f"JPEG is one sample")
    best = float(text.splitlines()[-1].split("=")[1])
    if not math.isfinite(best):
        raise RuntimeError(f"{what}: best_acc1 {best}")
    steps = [e for e in events if e["type"] == "step"]
    end = events[-1]
    b = TRAIN_B if "resnet18" in args else VIT_B
    # With --device_prefetch the wait for the loader's next batch falls in
    # the staging call (``prefetch_s``), not in ``data_s``.
    paced = steps[1:] if pace_epoch is None else [
        e for e in steps if e["epoch"] == pace_epoch]
    step_s = sum(e["step_s"] for e in paced)
    wait_s = sum(e["data_s"] + (e.get("prefetch_s") or 0.0) for e in paced)
    if pace_epoch is None:
        prefetch_s = sum(e.get("prefetch_s") or 0.0 for e in steps)
        data_wait_s, span_s = end["data_wait_s"], end["wall_s"]
    else:
        prefetch_s = sum(e.get("prefetch_s") or 0.0 for e in paced)
        data_wait_s, span_s = sum(e["data_s"] for e in paced), step_s
    return events, {**row, "best_acc1": best, "samples_skipped": skipped,
            "samples_retried": retried, "data_lines": data_lines,
            "pace_epoch": pace_epoch, "pace_steps": len(paced),
            "images_per_s": b * len(paced) / step_s,
            "host_data_s_p50": statistics.median(
                e["data_s"] for e in paced),
            "host_compute_s_p50": statistics.median(
                e["compute_s"] for e in paced),
            "host_prefetch_s_p50": statistics.median(
                e.get("prefetch_s") or 0.0 for e in paced),
            "data_wait_s": data_wait_s, "wall_s": end["wall_s"],
            "data_wait_share": data_wait_s / span_s,
            "prefetch_share": prefetch_s / span_s,
            "loader_wait_share_of_steps": wait_s / step_s}


def phase_train_imagefolder(root: str) -> dict:
    """``python -m tpudist_torch --data DIR`` in this process: resnet18
    (batch 256, bf16, --fused-bn on, two epochs of 5 steps,
    ``--data-skip-budget 1``, and ``--inject decode_fail:p=0.1,fails=1``
    that ``decode_fail`` reads; the launcher's ``--inject`` is driven by
    preempt_resume) launches B1–B4
    9/8/9/8 times a step, skips the truncated JPEG once an epoch and logs
    it; its pace reads epoch 1 alone, where no load fails (``fails=1``
    healed every injected failure in epoch 0: 0 retried there, or the
    phase fails); then ViT-B/16 in this process
    (batch 128, bf16, --flash on, AdamW, one epoch of 10 steps, the train
    split on the PIL stack under ``--auto-augment ta_wide --random-erase
    0.25``) launches B5–B7 12/12/12 a step and B5 12 a val batch."""
    workers = str(min(os.cpu_count() or 1, 32))
    paths = data_lib.choose_paths(config_lib.Config(data=root))
    line = "=> data path: " + "; ".join(
        f"{s} {p} ({why})" for s, (p, why) in paths.items())
    r18_events, r18 = _imagefolder_run(
        ["-a", "resnet18", "--use_amp", "--fused-bn", "on", "-b",
         str(TRAIN_B), "--data", root, "--image-size", str(TRAIN_PX),
         "--num-classes", "1000", "--epochs", "2", "--step", "1", "-p", "1",
         "--data-skip-budget", "1", "-j", workers, "--inject",
         "decode_fail:p=0.1,fails=1"],
        "the ImageFolder resnet18 run under decode_fail", line,
        outdir=os.path.join(os.path.dirname(root), "r18_run"), pace_epoch=1)
    if r18["samples_retried"][1:] != [0]:
        raise RuntimeError(f"ImageFolder resnet18: retried "
                           f"{r18['samples_retried']} a epoch; the pace's "
                           f"epoch 1 must retry none")
    n = r18["train_steps"]
    want = {"bn_act_fwd": 9 * n, "bn_act_fwd_res": 8 * n,
            "bn_act_bwd": 9 * n, "bn_act_bwd_res": 8 * n}
    r18["launches"] = {k: r18["launches"][k] for k in fn.KERNELS}
    if n != 2 * CORPUS_TRAIN // TRAIN_B or r18["launches"] != want:
        raise RuntimeError(f"ImageFolder resnet18: fused-norm launches "
                           f"{r18['launches']} for {n} steps; want {want}")
    aug = data_lib.choose_paths(config_lib.Config(
        data=root, auto_augment="ta_wide", random_erase=0.25))
    _, vit = _imagefolder_run(
        ["-a", "vit_b_16", "--use_amp", "--flash", "on", "--optimizer",
         "adamw", "--lr", "1e-3", "--weight-decay", "0.05", "-b",
         str(VIT_B), "--data", root, "--image-size", str(TRAIN_PX),
         "--num-classes", "1000", "--epochs", "1", "-p", "1",
         "--auto-augment", "ta_wide", "--random-erase", "0.25",
         "--keep-checkpoints", "0", "--data-skip-budget", "1", "-j",
         workers],
        "the ImageFolder ViT-B/16 run", "=> data path: " + "; ".join(
            f"{s} {p} ({why})" for s, (p, why) in aug.items()),
        outdir=os.path.join(os.path.dirname(root), "vit_run"))
    n, val = vit["train_steps"], -(-CORPUS_VAL // VIT_B)
    want = {"flash_fwd": LAYERS * (n + val), "flash_bwd_dq": LAYERS * n,
            "flash_bwd_dkv": LAYERS * n}
    vit["launches"] = {k: vit["launches"][k] for k in fa.KERNELS}
    if n != CORPUS_TRAIN // VIT_B or vit["launches"] != want:
        raise RuntimeError(f"ImageFolder ViT-B/16: flash launches "
                           f"{vit['launches']} for {n} steps; want {want}")
    out = {"phase": "train_imagefolder", "workers": int(workers),
           "cpu_count": os.cpu_count(), "resnet18": r18, "vit_b_16": vit}
    emit(out)
    return dict(out, resnet18_events=r18_events)


# -- phase 9: preemption, fault injection and the reference's files ---------

# The step of resnet18's epoch 1 (8 steps) at which the launcher is sent
# SIGTERM: its log line at -p 1. The drain lands a step or two later.
PREEMPT_AT = "Epoch[1]:\t[2/8]"
# Given to that launcher: its --inject reaching the rank, at no cost.
PREEMPT_INJECT = "slow_peer:ms=1@step=0"
HERE = os.path.dirname(os.path.abspath(__file__))


def _runs(events: list) -> list:
    """The events of each run in an events file, run_start to run_end."""
    runs = []
    for e in events:
        if e["type"] == "run_start":
            runs.append([])
        runs[-1].append(e)
    return runs


def _norm_launches(run: list) -> tuple[int, dict, dict]:
    """A run's train steps, its B1–B4 launches (from run_end) and the
    9/8/9/8 a step it must have made."""
    n = sum(e["type"] == "step" for e in run)
    got = {k: run[-1]["kernel_launches"][k] for k in fn.KERNELS}
    return n, got, {k: v * n for k, v in R18_PER_STEP.items()}


def phase_preempt_resume(root: str, card: dict, run_a: str) -> dict:
    """resnet18 at checkpoint_resume's settings through ``python -m
    tpudist_torch.launch -n 1 -- ... --resume auto --overwrite keep``:
    SIGTERM to the launcher at PREEMPT_AT; the launcher's ``--inject
    slow_peer:ms=1@step=0`` reaches the rank (one ``fault`` event at step
    0, a 1 ms stall that moves no number). The rank must drain (its
    ``caught SIGTERM`` and ``exiting 75 (resumable)`` lines, a
    ``preempt`` event, a ``checkpoint_save`` of kind ``emergency``), the
    launcher exit 130, and the live file verify against its sidecar with
    a cursor of whole steps in epoch 1. The same command then continues
    epoch 1 at that cursor and ends where checkpoint_resume's straight
    run A ended (bit-equal, or within 3x the run-to-run spread), B1–B4
    launching 9/8/9/8 times a step in both runs."""
    out = os.path.join(root, "r18_preempt")
    args = CKPT_R18_ARGS + ["-p", "1", "--resume", "auto", "--overwrite",
                            "keep", "--blackbox"]
    cmd = [sys.executable, "-m", "tpudist_torch.launch", "-n", "1",
           "--inject", PREEMPT_INJECT, "--incident-keep", "2", "--",
           sys.executable, "-m",
           "tpudist_torch", "--distributed", *args, "--telemetry", "--seed",
           "0", "--outpath", out]
    proc = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    watchdog = threading.Timer(300, proc.kill)
    watchdog.start()
    lines, t_sig = [], None
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith(PREEMPT_AT):
                proc.send_signal(signal.SIGTERM)
                t_sig = time.time()
                break
        rest, err = proc.communicate(timeout=120)
    finally:
        watchdog.cancel()
    t_exit = time.time()
    text = "".join(lines) + rest
    print(text, end="", flush=True)
    if t_sig is None or proc.returncode != 130 \
            or "=> caught SIGTERM — draining for preemption" not in text \
            or "=> emergency checkpoint complete; exiting 75 (resumable)" \
            not in text:
        raise RuntimeError(f"preempt_resume: launcher exit "
                           f"{proc.returncode}, SIGTERM sent {t_sig}: "
                           f"{err[-3000:]}")
    live = os.path.join(out, ckpt_lib.CKPT_NAME)
    tree = ckpt_lib.load_checkpoint(out)
    cursor = tree.get("data_cursor") or {}
    consumed = int(cursor.get("consumed", 0))
    with open(telemetry_lib.events_path(out, 0)) as f:
        first = [json.loads(ln) for ln in f]
    for ev in first:
        telemetry_lib.validate_event(ev)
    preempt = [e for e in first if e["type"] == "preempt"]
    saves = [e for e in first if e["type"] == "checkpoint_save"]
    injected = [(e["point"], e.get("step")) for e in first
                if e["type"] == "fault"]
    if injected != [("slow_peer", 0)]:
        raise RuntimeError(f"preempt_resume: the launcher's --inject "
                           f"{PREEMPT_INJECT} fired {injected} in the rank")
    if not (os.path.exists(live + ".sha256")
            and ckpt_lib.verify_checkpoint(live)) or tree["epoch"] != 1 \
            or cursor.get("epoch") != 1 or not 0 < consumed < 2048 \
            or consumed % TRAIN_B or [e["signal"] for e in preempt] \
            != ["SIGTERM"] or [e["kind"] for e in saves] \
            != ["epoch", "emergency"] \
            or int(tree["state"]["step"]) != 8 + consumed // TRAIN_B:
        raise RuntimeError(f"preempt_resume: the emergency file: epoch "
                           f"{tree['epoch']}, cursor {cursor}, step "
                           f"{tree['state']['step']}, preempt {preempt}, "
                           f"saves {saves}")
    emergency = saves[-1]
    end = first[-1]
    del tree
    # The flight recorder: the slow_peer fault and the preempt dumped,
    # and the launcher's last sweep left them in one bundle.
    from tpudist_torch import blackbox as blackbox_lib
    bundles = blackbox_lib.list_incidents(out)
    dumped = sorted(d["trigger"] for m in bundles for d in m["dumps"])
    chain = []
    if bundles:
        with open(os.path.join(bundles[0]["dir"], "events.jsonl")) as f:
            chain = [json.loads(ln)["type"] for ln in f]
    if len(bundles) != 1 or "preempt" not in dumped \
            or "events.jsonl" not in bundles[0]["artifacts"] \
            or "preempt" not in chain \
            or "incident bundler armed (keep 2" not in err:
        raise RuntimeError(f"preempt_resume: bundles "
                           f"{[m.get('id') for m in bundles]}, dumps "
                           f"{dumped}, chain {chain}: {err[-1500:]}")
    incident = {"bundle": bundles[0]["id"], "dumps": dumped,
                "artifacts": bundles[0]["artifacts"],
                "chain": sorted(set(chain))}
    shutil.rmtree(os.path.join(out, "incidents"), ignore_errors=True)
    text_r, row_r, events = _launch_trainer(
        args, "the resumed resnet18 run", outdir=out)
    resumed = RESUMED_RE.search(text_r)
    cont = (f"=> checkpoint carries a mid-epoch sample cursor: epoch 1 "
            f"continues at global sample {consumed} (no replay, no drop)")
    runs = _runs(events)
    counts = {name: _norm_launches(run)
              for name, run in zip(("preempted", "relaunch"), runs)}
    if resumed is None or int(resumed.group(2)) != 1 or cont not in text_r \
            or len(runs) != 2 or any(got != want for _, got, want
                                     in counts.values()) \
            or sum(n for n, _, _ in counts.values()) != 16:
        raise RuntimeError(f"preempt_resume: resumed "
                           f"{resumed and resumed.group(0)}, cursor line "
                           f"{cont in text_r}, launches {counts}")
    parts = CKPT_R18_PARTS

    def rerun():
        again = os.path.join(root, "r18_a3")
        _launch_trainer(CKPT_R18_ARGS, "another straight resnet18 run",
                        outdir=again)
        tree = ckpt_lib.load_checkpoint(again)
        shutil.rmtree(again, ignore_errors=True)
        return tree
    held = _resumed_vs_straight(ckpt_lib.load_checkpoint(run_a),
                                ckpt_lib.load_checkpoint(out), parts, rerun)
    shutil.rmtree(out, ignore_errors=True)
    row = {"phase": "preempt_resume", "arch": "resnet18", "batch": TRAIN_B,
           "dtype": "float16", "card": card["nvidia_smi"], **held,
           "cursor": cursor, "steps": {k: n for k, (n, _, _)
                                       in counts.items()},
           "fused_norm_launches": {k: got for k, (_, got, _)
                                   in counts.items()},
           "emergency_save_s": emergency["seconds"],
           "sigterm_to_boundary_s": preempt[0]["t"] - t_sig,
           "sigterm_to_rank_exit_s": end["t"] - t_sig,
           "sigterm_to_launcher_exit_s": t_exit - t_sig,
           "resumed_line": resumed.group(0),
           "relaunch_wall_s": row_r["wall_s"], "incident": incident}
    emit(row)
    return row


def _bitflip_on_card(root: str) -> dict:
    """``bitflip`` on the card. A resnet18 and its twin from one seed:
    ``bitflip@step=1`` flips bit 23 of ``bn1.bias[0]`` (tpudist's first f32
    leaf) in one, which then differs from the twin's in that bit and in
    no other, and the probe's digest tells the two apart. Then resnet18
    through the trainer (float16, 2 epochs of 4 steps) with ``--doctor
    --doctor-probe-freq 2 --inject bitflip@step=1``: the point fires once,
    every probe at world 1 sees no divergence (one replica cannot see
    SDC) and stamps what was written good: epoch 0's history copy carries
    a ``good`` verdict for its bytes."""
    from tpudist_torch.doctor import probes
    flipped = create_model("resnet18", dtype=torch.float16, fused_bn=True)
    flipped.load_state_dict(_seed0_weights("resnet18"))
    twin = create_model("resnet18", dtype=torch.float16, fused_bn=True)
    twin.load_state_dict(_seed0_weights("resnet18"))
    flipped.cuda()
    twin.cuda()
    faults.configure("bitflip@step=1")
    try:
        hit = (faults.maybe_bitflip(0, flipped),
               faults.maybe_bitflip(1, flipped))
    finally:
        faults.configure("")
    a, b = flipped.state_dict(), twin.state_dict()
    differ = sorted(k for k in a if not torch.equal(a[k], b[k]))
    xor = int(a["bn1.bias"].view(torch.int32)[0].item()
              ^ b["bn1.bias"].view(torch.int32)[0].item())
    same_rest = torch.equal(a["bn1.bias"][1:], b["bn1.bias"][1:])
    digests = [probes.replicated_digest(probes.state_leaves(m))
               for m in (flipped, twin)]
    row = {"fired": list(hit), "differ": differ, "xor": xor,
           "flipped_value": float(a["bn1.bias"][0]),
           "twin_value": float(b["bn1.bias"][0]),
           "digests_differ": digests[0] != digests[1]}
    del flipped, twin, a, b
    out = os.path.join(root, "r18_bitflip")
    text, events, launches = _run_cli(
        CKPT_R18_ARGS[:CKPT_R18_ARGS.index("--synthetic-size")]
        + ["--synthetic-size", str(4 * TRAIN_B), "--step", "1", "-p", "4",
           "--doctor", "--doctor-probe-freq", "2", "--inject",
           "bitflip@step=1", "--telemetry", "--seed", "0", "--outpath",
           out], "the bitflip resnet18 run")
    fired = [(e["point"], e.get("step")) for e in events
             if e["type"] == "fault"]
    sdc = [(e["step"], e["world"], e["divergent"]) for e in events
           if e["type"] == "sdc_probe"]
    verdict = ckpt_lib.read_verdict(os.path.join(
        out, "checkpoint-ep00001.msgpack"))
    n, got, want = _norm_launches(events)
    shutil.rmtree(out, ignore_errors=True)
    row.update(run_fired=fired, probes=sdc, verdict=verdict,
               run_steps=n, run_fused_norm_launches=got)
    if row["fired"] != [None, "bn1.bias"] \
            or differ != ["bn1.bias"] or xor != 1 << 23 or not same_rest \
            or not row["digests_differ"] or fired != [("bitflip", 1)] \
            or [p[0] for p in sdc] != [2, 4, 6] \
            or any(w != 1 or d for _, w, d in sdc) \
            or (verdict or {}).get("verdict") != "good" or got != want:
        raise RuntimeError(f"faults_on_card's bitflip: {row}")
    return row


def phase_faults_on_card(root: str, card: dict) -> dict:
    """``--inject`` on the card. ``checkpoint_corrupt@step=2``: resnet18
    (batch 256, 2 steps an epoch, 10 classes so that an epoch marks best,
    ``--model-ema-decay``, ``--torch_checkpoints``) trains 2 epochs, the
    second save's live file and history copy are flipped after their
    sidecars; ``--resume auto`` for a third epoch must quarantine both,
    fall back to the first epoch's history file and emit the ``fault``
    events. Then ``bitflip`` (``_bitflip_on_card``). The run dir is
    torch_checkpoint's."""
    out = os.path.join(root, "r18_faults")
    args = CKPT_R18_ARGS + ["--synthetic-size", "512", "--num-classes", "10",
                            "--model-ema-decay", "0.9", "--torch_checkpoints",
                            "--telemetry", "--seed", "0", "--outpath", out]
    text1, ev1, l1 = _run_cli(args + ["--epochs", "2", "--inject",
                                      "checkpoint_corrupt@step=2"],
                              "the corrupted resnet18 run")
    text2, ev2, l2 = _run_cli(args + ["--epochs", "3", "--resume", "auto",
                                      "--overwrite", "keep"],
                              "the fallback resnet18 run")
    fired = [(e["point"], e.get("step")) for e in ev1 if e["type"] == "fault"]
    quarantined = [e["path"] for e in ev2 if e["type"] == "fault"
                   and e["point"] == "checkpoint_quarantine"]
    resumed = RESUMED_RE.search(text2)
    counts = {"corrupt_run": _norm_launches(ev1),
              "fallback_run": _norm_launches(ev2)}
    if fired != [("checkpoint_corrupt", 2)] \
            or text1.count("[tpudist.faults] checkpoint_corrupt flipped 64 "
                           "bytes in") != 2 \
            or text2.count("fails sha256 verification — quarantined to") != 2 \
            or sorted(quarantined) != ["checkpoint-ep00002.msgpack.corrupt",
                                       "checkpoint.msgpack.corrupt"] \
            or resumed is None or not resumed.group(1).endswith(
                "checkpoint-ep00001.msgpack") or int(resumed.group(2)) != 1 \
            or ckpt_lib.load_checkpoint(out)["epoch"] != 3 \
            or any(got != want for _, got, want in counts.values()):
        raise RuntimeError(f"faults_on_card: fired {fired}, quarantined "
                           f"{quarantined}, resumed "
                           f"{resumed and resumed.group(0)}, launches "
                           f"{counts}")
    bitflip = _bitflip_on_card(root)
    launched = {k: got for k, (_, got, _) in counts.items()}
    launched["bitflip_run"] = bitflip["run_fused_norm_launches"]
    row = {"phase": "faults_on_card", "part": "checkpoint_corrupt",
           "card": card["nvidia_smi"], "fired": fired,
           "quarantined": sorted(quarantined),
           "resumed_line": resumed.group(0),
           "steps": {k: n for k, (n, _, _) in counts.items()},
           "fused_norm_launches": launched, "bitflip": bitflip,
           "run_dir": out}
    emit(row)
    return row


def phase_decode_fail(rates: dict, images: dict, card: dict) -> dict:
    """``--inject decode_fail:p=0.1,fails=1`` given to train_imagefolder's
    resnet18 run (two epochs of its JPEG tree). Each
    failed load heals on its first retry, and a sample fails once in the
    run (``fails=1``): ``samples_retried`` > 0 in the first epoch, a
    ``fault`` event each, and ``samples_skipped`` a epoch those of the
    same loader path over the same tree without injection (loader_rates'
    ``train_card_path``: the truncated JPEG alone), B1–B4 9/8/9/8 a
    step."""
    events = images["resnet18_events"]
    epoch = [e for e in events if e["type"] == "epoch"]
    fired = sum(e["type"] == "fault" and e["point"] == "decode_fail"
                for e in events)
    n, got, want = _norm_launches(events)
    skipped = [e.get("samples_skipped", 0) for e in epoch]
    retried = [e.get("samples_retried", 0) for e in epoch]
    clean = rates["train_card_path"]["samples_skipped"]
    if skipped != clean or len(epoch) != 2 \
            or not retried[0] > 0 or fired != sum(retried) or got != want:
        raise RuntimeError(f"decode_fail: skipped {skipped} (without "
                           f"injection {clean}), retried {retried}, "
                           f"fault events {fired}, launches {got}, want "
                           f"{want}")
    out = {"phase": "faults_on_card", "part": "decode_fail",
           "card": card["nvidia_smi"], "samples_skipped": skipped,
           "samples_skipped_without_injection": clean,
           "samples_retried": retried, "fault_events": fired,
           "train_steps": n, "fused_norm_launches": got,
           "wall_s": images["resnet18"]["wall_s"]}
    emit(out)
    return out


def _state_dicts_equal(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].is_contiguous() and torch.equal(a[k], b[k]) for k in a)


def phase_torch_checkpoint(root: str, card: dict, r18_dir: str,
                           vit_dir: str) -> dict:
    """The reference's ``.pth.tar`` files on the card. faults_on_card's
    run wrote ``checkpoint.pth.tar`` (the live weights) and
    ``model_best.pth.tar`` (the EMA weights): each loads with
    ``torch.load(weights_only=False)``, holds the reference's four keys
    and equals the msgpack file's weights in torchvision's names;
    ``--evaluate`` from ``--pretrained --pretrained-path`` of the first
    gives the top-1 of ``--resume`` of the msgpack file. ViT-B/16:
    checkpoint_vit's final tree, exported and imported into a fresh model,
    gives bit-equal bf16 logits at batch 8 with ``--flash on`` (B5 12 a
    forward); two training steps from ``--pretrained-path`` of that file
    launch B5–B7 12/12/12 a step. ``--pretrained`` with an empty
    ``$TORCH_HOME`` fails, naming the directory it searched."""
    out = {"phase": "torch_checkpoint", "card": card["nvidia_smi"]}
    tree = ckpt_lib.load_checkpoint(r18_dir)
    files = {}
    for name, src in (("checkpoint.pth.tar", tree["state"]),
                      ("model_best.pth.tar", ckpt_lib.load_checkpoint(
                          os.path.join(r18_dir, ckpt_lib.BEST_NAME))[
                              "state"]["ema_params"])):
        ref = torch.load(os.path.join(r18_dir, name), map_location="cpu",
                         weights_only=False)
        want = torch_ckpt.flax_to_torch_state_dict(
            src["params"], src["batch_stats"], "resnet18")
        if sorted(ref) != ["arch", "best_acc1", "epoch", "state_dict"] \
                or ref["arch"] != "resnet18" \
                or not _state_dicts_equal(ref["state_dict"], want):
            raise RuntimeError(f"torch_checkpoint: {name} is not the "
                               f"reference's file of the run's weights")
        files[name] = {"epoch": ref["epoch"], "best_acc1": ref["best_acc1"],
                       "tensors": len(ref["state_dict"]),
                       "bytes": os.path.getsize(os.path.join(r18_dir, name))}
    evals = {}
    for how, extra in (
            ("resume_msgpack", ["--resume", os.path.join(
                r18_dir, ckpt_lib.CKPT_NAME)]),
            ("pretrained_pth", ["--pretrained", "--pretrained-path",
                                os.path.join(r18_dir, "checkpoint.pth.tar")])):
        text, _, _ = _run_cli(
            CKPT_R18_ARGS + ["--synthetic-size", "512", "--num-classes", "10",
                             "--evaluate", "--telemetry", "--seed", "0",
                             "--outpath", os.path.join(root, how)] + extra,
            f"--evaluate from {how}")
        evals[how] = [ln for ln in text.splitlines()
                      if ln.startswith("||==> Val: Epoch[-1]")]
    if len(evals["resume_msgpack"]) != 1 \
            or evals["resume_msgpack"] != evals["pretrained_pth"]:
        raise RuntimeError(f"torch_checkpoint: --evaluate differs: {evals}")
    out["resnet18"] = {"files": files, "evaluate": evals}
    # ViT-B/16: the round trip through the reference's file.
    vtree = ckpt_lib.load_checkpoint(vit_dir)
    kw = dict(image_size=224, flash=True, dtype=torch.bfloat16)
    live = create_model("vit_b_16", **kw)
    live.load_state_dict(state_dict_from_jax("vit_b_16",
                                             vtree["state"]["params"]))
    live.cuda().eval()
    path = os.path.join(root, "vit_b_16.pth.tar")
    t0 = time.perf_counter()
    torch_ckpt.save_reference_checkpoint(path, live, "vit_b_16",
                                         int(vtree["epoch"]) - 1,
                                         float(vtree["best_acc1"]))
    export_s = time.perf_counter() - t0
    del vtree
    fresh = create_model("vit_b_16", **kw).cuda().eval()
    t0 = time.perf_counter()
    epoch, best = torch_ckpt.restore_from_torch(fresh, path, "vit_b_16")
    import_s = time.perf_counter() - t0
    images = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 224, 224, 3)).astype(np.float32)).cuda()
    with torch.inference_mode():
        want = live(images)
        fa.reset_counts()
        got = fresh(images)
        torch.cuda.synchronize()
        b5 = dict(fa.LAUNCHES)
    del live, fresh
    if not torch.equal(got, want) or b5 != {"flash_fwd": LAYERS,
                                            "flash_bwd_dq": 0,
                                            "flash_bwd_dkv": 0} \
            or not torch.isfinite(got).all() or got.shape != (8, 1000):
        raise RuntimeError(f"torch_checkpoint: the ViT-B/16 round trip: "
                           f"max |diff| {(got - want).abs().max().item()}, "
                           f"launches {b5}")
    vit = {"bytes": os.path.getsize(path), "export_s": export_s,
           "import_s": import_s, "epoch": epoch, "best_acc1": best,
           "logits_bit_equal": True, "logits_launches": b5}
    steps_dir = os.path.join(root, "vit_pretrained")
    text, events, launches, wall_s = _train_in_process(
        CKPT_VIT_ARGS + ["--pretrained", "--pretrained-path", path,
                         "--synthetic-size", str(2 * VIT_B), "--epochs",
                         "1",
                         "--outpath", steps_dir],
        "two ViT-B/16 steps from the reference's file", val_batches=1)
    steps = sum(e["type"] == "step" for e in events)
    if steps != 2 or f"=> using pre-trained model 'vit_b_16' (from " \
            f"{path})" not in text:
        raise RuntimeError(f"torch_checkpoint: {steps} ViT steps from "
                           f"{path}")
    vit.update(train_steps=steps, train_launches=launches,
               train_wall_s=wall_s)
    out["vit_b_16"] = vit
    # --pretrained with nothing on disk (in this process, under an empty
    # $TORCH_HOME).
    home = os.path.join(root, "empty_torch_home")
    os.makedirs(home)
    saved = {k: os.environ.pop(k, None)
             for k in ("TPUDIST_PRETRAINED_DIR", "TORCH_HOME")}
    os.environ["TORCH_HOME"] = home
    try:
        train_cli.main(CKPT_R18_ARGS + ["--pretrained", "--outpath",
                                        os.path.join(root, "no_weights")])
    except FileNotFoundError as e:
        missing = str(e)
    else:
        missing = None
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    searched = f"searched ['{os.path.join(home, 'hub', 'checkpoints')}']"
    if missing is None or searched not in missing:
        raise RuntimeError(f"torch_checkpoint: --pretrained without a file: "
                           f"{missing!r}")
    out["pretrained_missing"] = missing
    emit(out)
    return out


# -- phase 11: the BatchNorm+ReLU conv families --------------------------------

# (arch, input px, fused sites a step): tpudist's count of act="relu"
# BatchNorm calls of each model, which tests/test_torch_zoo.py holds the
# port's train-mode forward to on the CPU. B2 and B4 (the residual
# epilogue) have no site in these families.
ZOO_MODELS = [("vgg16_bn", 224, 13), ("densenet121", 224, 121),
              ("googlenet", 224, 57), ("inception_v3", 299, 96),
              ("mobilenet_v3_large", 224, 11), ("regnet_y_400mf", 224, 33)]
ZOO_B = 256
ZOO_LR = 0.1
ZOO_TIMED = 3
# Each zoo model trains kernels on against off twice from the same seed on
# the same batches at ZOO_LR: in bf16 at batch 256 for TRAIN_CMP_STEPS
# steps (timed after), and in f32 at batch ZOO_F32_B for ZOO_F32_STEPS.
# The two runs of one epilogue are bit-equal (the plain run twice reads 0
# everywhere), so what parts them is the two epilogues' rounding of
# x·a + b, which these nets' backward at init amplifies: on the CPU,
# inception_v3's f32 gradients at batch 8 and 299 px differ from its
# float64 ones by 3-5 % per leaf (tests/test_torch_inception.py). In bf16
# (2^-8, 65536x f32's 2^-24) that saturates: after step one the weights'
# ‖on − off‖₂ / ‖Δoff‖₂ reads 0.10 (mobilenet_v3_large) to 1.18
# (inception_v3) and its median over leaves 0.05 to 0.71, with the worst
# max|on − off| / max|Δoff| on the conv biases ahead of a batch-statistics
# BatchNorm (vgg16_bn: their gradient is 0 but for rounding) and on BN
# scales and biases. So the bf16 run holds the losses and that no leaf is
# left unmoved (its L2 ratios reported), and the f32 run holds the weights:
# its largest weight ratio (0.0019 mobilenet_v3_large, 0.0079 vgg16_bn,
# 0.0097 densenet121, 0.0101 googlenet, 0.0132 regnet_y_400mf, 0.0268
# inception_v3) and its median leaf (0.00047 to 0.0157), each bound at
# about 3x its reading. A B3 that zeroes dx at one site reads 1.0-1.1 on
# the weights there, one that drops a site's backward 1.0 and leaves its
# bias unmoved, and dx 10 % low at every site 0.60-0.97: every bound set
# breaks (python3 chip_smoke.py --mutations). The losses: resnet18's
# bound (TRAIN_LOSS_TOL, 2e-3 of max(1, |loss|)) where a model reads
# within a third of it, else about 3x the reading (bf16: vgg16_bn 7.9e-3
# after its loss climbs at lr 0.1; inception_v3 1.8e-2 in bf16 at step 3
# and 1.56e-2 in f32 at step 2, since its padded branch pool is routed
# around torch's faulty CUDA backward (layers.avg_pool_padded): its first
# SGD step now follows the true gradient, after which the two epilogues'
# losses part more, while the weights after step one part as before,
# 0.0276 against 0.0268; under the faulty backward the readings were
# 3.7e-3 and 4.7e-3). Read on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md
# §6).
ZOO_F32_B = 64
ZOO_F32_STEPS = 2
ZOO_LOSS_TOL = {
    "bfloat16": {"vgg16_bn": 2.5e-2, "densenet121": 2e-3, "googlenet": 2e-3,
                 "inception_v3": 5.5e-2, "mobilenet_v3_large": 2e-3,
                 "regnet_y_400mf": 2e-3},
    "float32": {"vgg16_bn": 2e-3, "densenet121": 2e-3, "googlenet": 2e-3,
                "inception_v3": 4.7e-2, "mobilenet_v3_large": 2e-3,
                "regnet_y_400mf": 2e-3}}
ZOO_F32_WEIGHT_TOL = {"vgg16_bn": 0.024, "densenet121": 0.03,
                      "googlenet": 0.03, "inception_v3": 0.08,
                      "mobilenet_v3_large": 0.006, "regnet_y_400mf": 0.04}
ZOO_F32_MEDIAN_TOL = {"vgg16_bn": 0.019, "densenet121": 0.013,
                      "googlenet": 0.015, "inception_v3": 0.047,
                      "mobilenet_v3_large": 0.0015, "regnet_y_400mf": 0.025}
# The B1/B3 cases at the new families' (rows, C), batch 256 in bf16:
# vgg16_bn's first two BatchNorms (822 M elements, 6.4x resnet18's stem),
# googlenet's 5x5 reduce (16 channels, 28x28), inception_v3's 1x1 to 80
# channels on its 73x73 map (299 px) and its 48-channel 5x5 reduce on
# 35x35, mobilenet_v3_large's 72 and 120 channels, regnet_y_400mf's 104
# (56x56) and 440 (14x14), densenet121's widest norm1 (992 channels, 14x14)
# and densenet161's norm5 (2,208 channels, 7x7).
ZOO_SHAPES = [("vgg16_bn_c64", 256 * 224 * 224, 64),
              ("googlenet_c16", 256 * 28 * 28, 16),
              ("inception_c80", 256 * 73 * 73, 80),
              ("inception_c48", 256 * 35 * 35, 48),
              ("mobilenet_c72", 256 * 56 * 56, 72),
              ("mobilenet_c120", 256 * 28 * 28, 120),
              ("regnet_c104", 256 * 56 * 56, 104),
              ("regnet_c440", 256 * 14 * 14, 440),
              ("densenet_c992", 256 * 14 * 14, 992),
              ("densenet161_c2208", 256 * 7 * 7, 2208)]


def _zoo_setup(arch: str, px: int, batch: int):
    """``setup(on, dtype)`` for ``compare_on_off``: ``arch`` at full width
    with seed-0 weights, SGD at ``ZOO_LR``, every BN+ReLU site on the
    kernels (``on``) or the plain epilogue."""
    def setup(fused: bool, dtype):
        cfg = config_lib.Config(arch=arch, batch_size=batch, image_size=px,
                                fused_bn="on" if fused else "off")
        model = create_model(arch, dtype=dtype, fused_bn=fused)
        model.load_state_dict(_seed0_weights(arch))
        model.cuda()
        opt = train_lib.make_optimizer(model, cfg)
        step = train_lib.make_train_step(model, opt, cfg)
        step.optimizer = opt
        return model, step
    return setup


def _held_zoo(row: dict, arch: str) -> list[str]:
    """What breaks the zoo's on/off bounds in one comparison row (none:
    []): the losses and every leaf moved; in f32 also the largest weight's
    and the median leaf's ‖on − off‖₂ / ‖Δoff‖₂ after step one."""
    dtype = row["dtype"]
    tol = ZOO_LOSS_TOL[dtype][arch]
    what = f"{arch} {dtype} --fused-bn on vs off"
    bad = [f"{what} losses {row['losses_on']} vs {row['losses_off']}"
           for d, ref in zip(row["loss_abs_diff"], row["losses_off"])
           if not np.isfinite(d) or d > tol * max(1.0, abs(ref))][:1]
    if row["unmoved_on"]:
        bad.append(f"{what}: the on run left {row['unmoved_on'][:4]} "
                   f"unmoved")
    if dtype == "float32":
        for key, bound in (("weight_l2_ratio_max", ZOO_F32_WEIGHT_TOL[arch]),
                           ("state_l2_ratio_median",
                            ZOO_F32_MEDIAN_TOL[arch])):
            if not row[key] <= bound:
                bad.append(f"{what}: {key} {row[key]} (bound {bound}; worst "
                           f"weight {row['weight_l2_ratio_worst_leaf']})")
    return bad


def _zoo_f32_runs(arch: str, px: int):
    """The f32 comparison's setup and batches for ``arch``."""
    return (_zoo_setup(arch, px, ZOO_F32_B),
            _cmp_batches(ZOO_F32_B, px, ZOO_F32_STEPS))


def phase_zoo_train() -> dict:
    """The six families at full width, kernels on against off
    (``_held_zoo``): in bf16 at batch 256 (inception_v3 at 299 px with its
    aux head), three SGD steps, B1 and B3 launched once a step at each of
    tpudist's fused sites (B2, B4 never), then ``ZOO_TIMED`` synchronised
    steps of each run (median wall) and its ``max_memory_allocated``; and
    in f32 at batch ``ZOO_F32_B``, ``ZOO_F32_STEPS`` steps. A model that
    does not fit at batch 256 fails the phase, and so does a launch of the
    scalar variant (every site's rows are 16-byte vectors)."""
    rows, bad = {}, []
    scalar = fn.VARIANT_LAUNCHES["scalar"]
    for arch, px, sites in ZOO_MODELS:
        row = compare_on_off(_zoo_setup(arch, px, ZOO_B), torch.bfloat16,
                             ZOO_B, ZOO_LR, px=px, timed=ZOO_TIMED)
        want = {"bn_act_fwd": TRAIN_CMP_STEPS * sites,
                "bn_act_bwd": TRAIN_CMP_STEPS * sites}
        if row["launches_on"] != want:
            bad.append(f"{arch}: launches {row['launches_on']} over "
                       f"{TRAIN_CMP_STEPS} steps, want {want}")
        setup, batches = _zoo_f32_runs(arch, px)
        f32 = _on_off_row(
            _steps(setup, True, torch.float32, batches, ZOO_LR),
            _steps(setup, False, torch.float32, batches, ZOO_LR),
            torch.float32)
        want = {k: ZOO_F32_STEPS * sites for k in want}
        if f32["launches_on"] != want:
            bad.append(f"{arch} float32: launches {f32['launches_on']} over "
                       f"{ZOO_F32_STEPS} steps, want {want}")
        bad += _held_zoo(row, arch) + _held_zoo(f32, arch)
        rows[arch] = dict(row, batch=ZOO_B, image_size=px, sites=sites,
                          launches_per_step={k: v / TRAIN_CMP_STEPS
                                             for k, v in
                                             row["launches_on"].items()},
                          images_per_s=ZOO_B / row["step_ms_p50"]["on"]
                          * 1e3,
                          loss_tol_relative=ZOO_LOSS_TOL["bfloat16"][arch],
                          float32=dict(
                              f32, batch=ZOO_F32_B, steps=ZOO_F32_STEPS,
                              loss_tol_relative=ZOO_LOSS_TOL["float32"][arch],
                              weight_l2_tol=ZOO_F32_WEIGHT_TOL[arch],
                              median_l2_tol=ZOO_F32_MEDIAN_TOL[arch]))
        gc.collect()
        torch.cuda.empty_cache()
    scalar = fn.VARIANT_LAUNCHES["scalar"] - scalar
    if scalar:
        bad.append(f"the scalar variant launched {scalar} times")
    out = {"phase": "zoo_train", "steps": TRAIN_CMP_STEPS, "lr": ZOO_LR,
           "dtype": "bfloat16", "scalar_variant_launches": scalar,
           "models": rows}
    emit(out)
    if bad:
        raise RuntimeError("zoo_train: " + "; ".join(bad))
    return out


@contextlib.contextmanager
def _b3_fault(kind: str, sites: int):
    """B3's result made wrong inside the block, in a model with ``sites``
    fused sites a step: ``zero_dx`` zeroes dx at one site (the middle call
    of each backward), ``dropped`` zeroes all that site's results (dx and
    the scale's and bias's partials), ``dx_90`` scales dx by 0.9 at every
    site. Only the card's calls are faulted: a CPU reference run beside
    them stays sound."""
    real, calls = fn.bn_act_bwd, [0]

    def faulty(x2, r2, dy2, a, b):
        dx, dr, da_p, db_p = real(x2, r2, dy2, a, b)
        if not dy2.is_cuda:
            return dx, dr, da_p, db_p
        site = calls[0] % sites
        calls[0] += 1
        if kind == "dx_90":
            dx = dx * 0.9
        elif site == sites // 2:
            dx = torch.zeros_like(dx)
            if kind == "dropped":
                da_p, db_p = torch.zeros_like(da_p), torch.zeros_like(db_p)
        return dx, dr, da_p, db_p

    fn.bn_act_bwd = faulty
    try:
        yield
    finally:
        fn.bn_act_bwd = real


ZOO_FAULTS = ("zero_dx", "dropped", "dx_90")


def zoo_mutations() -> dict:
    """Each of ``ZOO_FAULTS`` in B3, in each zoo model's f32 on run
    against its sound off run (``phase_zoo_train``'s f32 comparison):
    whether ``_held_zoo`` fails it."""
    caught = {}
    for arch, px, sites in ZOO_MODELS:
        setup, batches = _zoo_f32_runs(arch, px)
        off = _steps(setup, False, torch.float32, batches, ZOO_LR)
        for kind in ZOO_FAULTS:
            on = _steps(setup, True, torch.float32, batches, ZOO_LR,
                        patch=lambda: _b3_fault(kind, sites))
            row = _on_off_row(on, off, torch.float32)
            why = _held_zoo(row, arch)
            caught[f"{arch}/{kind}"] = bool(why)
            emit({"phase": "mutation", "mutation": f"b3_{kind}",
                  "arch": arch, "breaks_bounds": bool(why), "why": why,
                  "row": row})
        del on, off
        gc.collect()
        torch.cuda.empty_cache()
    return caught


# B1 and B3's device ms a densenet121 step (batch 256, bf16) when both ran
# one element a thread, on an NVIDIA H100 80GB HBM3 at 700 W.
ZOO_BREAKDOWN_SCALAR_MS = {"bn_act_fwd": 10.59, "bn_act_bwd": 14.17}
ZOO_CLI = ["--synthetic", "-a", "densenet121", "--image-size", "224",
           "--num-classes", "1000", "-b", str(ZOO_B), "--use_amp",
           "--synthetic-size", str(4 * ZOO_B), "--epochs", "1", "-p", "1",
           "--keep-checkpoints", "0", "--telemetry", "--seed", "0"]
DENSENET_SITES = 121


def _zoo_cli_run(mode: str, root: str) -> dict:
    """``python -m tpudist_torch`` on ``ZOO_CLI`` at ``--fused-bn mode`` in
    this process: its launches a step from the counters (validation
    launches none), the dispatch's verdicts and the seconds it took (its
    probes under ``auto``), and the host step's data/compute split from
    the ``step`` events."""
    from tpudist_torch.trainer import Trainer
    spent = []
    resolve = Trainer._resolve_fused_norm_dispatch

    def timed(self):
        t0 = time.perf_counter()
        try:
            return resolve(self)
        finally:
            spent.append(time.perf_counter() - t0)

    Trainer._resolve_fused_norm_dispatch = timed
    outdir = os.path.join(root, mode)
    try:
        t0 = time.perf_counter()
        text, events, launches = _run_cli(
            ZOO_CLI + ["--fused-bn", mode, "--outpath", outdir],
            f"densenet121 --fused-bn {mode}")
        wall_s = time.perf_counter() - t0
        variants = dict(fn.VARIANT_LAUNCHES)
    finally:
        Trainer._resolve_fused_norm_dispatch = resolve
        shutil.rmtree(outdir, ignore_errors=True)
    steps = [e for e in events if e["type"] == "step"]
    n = len(steps)
    probe = _counts(text, PROBE_LINE_RE)
    verdicts = [{"key": m.group(1), "sites": int(m.group(3)),
                 "cuda_ms": m.group(4) and float(m.group(4)),
                 "plain_ms": m.group(5) and float(m.group(5)),
                 "kernel": m.group(7), "source": m.group(8)}
                for m in _verdicts(text, NORM_VERDICT_RE)]
    fused = sum(v["sites"] for v in verdicts if v["kernel"] == "cuda")
    per_step = {k: (launches[k] - probe.get(k, 0)) / n for k in fn.KERNELS}
    want = {"bn_act_fwd": fused, "bn_act_fwd_res": 0, "bn_act_bwd": fused,
            "bn_act_bwd_res": 0}
    first = _counts(text, LAUNCH_LINE_RE)
    if sum(v["sites"] for v in verdicts) != DENSENET_SITES \
            or per_step != want or (fused and first != want) or n != 4 \
            or variants["scalar"]:
        raise RuntimeError(f"densenet121 --fused-bn {mode}: {n} steps, "
                           f"launches {launches} (probes {probe}, first "
                           f"step {first}, variants {variants}), verdicts "
                           f"{verdicts}")
    split = {k: statistics.median(e[k] for e in steps[1:])
             for k in ("data_s", "h2d_s", "compute_s", "step_s")}
    agg = [e for e in events if e["type"] == "fused_norm_dispatch"][-1]
    return {"wall_s": wall_s, "steps": n, "dispatch_s": spent[-1],
            "n_workloads": agg.get("n_sites"), "n_fused": agg.get("n_fused"),
            "source": agg.get("source"), "verdicts": verdicts,
            "fused_sites": fused, "probe_launches": probe,
            "launches": {k: launches[k] for k in fn.KERNELS},
            "variant_launches": variants,
            "launches_per_step": per_step,
            "host_step_median_s": split}


def phase_zoo_cli() -> dict:
    """densenet121 at full width through the CLI, one 4-step epoch: at
    ``--fused-bn on`` every one of its 121 sites launches B1 and B3 once a
    step; at the default ``auto``, under a fresh ``TPUDIST_DISPATCH_CACHE``,
    the dispatch times every workload and each site that chose the kernel
    launches it once a step."""
    root = tempfile.mkdtemp(prefix="tpudist_torch_zoo_cli_")
    prev = os.environ.get("TPUDIST_DISPATCH_CACHE")
    os.environ["TPUDIST_DISPATCH_CACHE"] = os.path.join(root, "cache")
    try:
        out = {"phase": "zoo_cli", "arch": "densenet121", "batch": ZOO_B,
               "on": _zoo_cli_run("on", root),
               "auto": _zoo_cli_run("auto", root)}
    finally:
        if prev is None:
            os.environ.pop("TPUDIST_DISPATCH_CACHE", None)
        else:
            os.environ["TPUDIST_DISPATCH_CACHE"] = prev
        shutil.rmtree(root, ignore_errors=True)
    if out["auto"]["source"] != "measured":
        raise RuntimeError(f"zoo_cli: --fused-bn auto did not measure: "
                           f"{out['auto']}")
    emit(out)
    return out


def _zoo_category(kernel: str) -> str:
    n = kernel.lower()
    if "catarray" in n or "cat_" in n:
        return "concat_copies"
    return _train_category(kernel)


@contextlib.contextmanager
def _norm_bytes_moved(total: dict):
    """Add to ``total[kernel]`` the bytes (``_norm_bytes``) of every
    fused-norm wrapper call made inside the block."""
    fwd, bwd = fn.bn_act_fwd, fn.bn_act_bwd

    def count(x2, r2):
        name = "bn_act_fwd" + ("_res" if r2 is not None else "")
        total[name] = total.get(name, 0) + _norm_bytes(
            name, *x2.shape, x2.element_size())

    def fwd_counted(x2, r2, a, b):
        count(x2, r2)
        return fwd(x2, r2, a, b)

    def bwd_counted(x2, r2, dy2, a, b):
        name = "bn_act_bwd" + ("_res" if r2 is not None else "")
        total[name] = total.get(name, 0) + _norm_bytes(
            name, *x2.shape, x2.element_size())
        return bwd(x2, r2, dy2, a, b)

    fn.bn_act_fwd, fn.bn_act_bwd = fwd_counted, bwd_counted
    try:
        yield total
    finally:
        fn.bn_act_fwd, fn.bn_act_bwd = fwd, bwd


def phase_zoo_breakdown() -> dict:
    """One densenet121 train step (batch 256, 224 px, bf16, every site on
    the kernels) on a device-resident batch: synchronised wall (median of
    5), device ms by category over 3 steps under torch.profiler (conv,
    BatchNorm statistics, fused-norm, casts, elementwise, the channel
    concatenations), busy, the idle share and the backward's re-layouts;
    each fused-norm kernel's device ms a step beside its bytes bound (the
    sum over its launches, ``_norm_bytes``) and the scalar kernels'
    reading (``ZOO_BREAKDOWN_SCALAR_MS``). The scalar variant must not
    launch."""
    model, step = _zoo_setup("densenet121", TRAIN_PX, ZOO_B)(
        True, torch.bfloat16)
    x, y = _device_batch(7, ZOO_B)
    for _ in range(2):
        step(x, y, ZOO_LR)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(x, y, ZOO_LR)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    n = 3
    fn.reset_counts()
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof, \
            _norm_bytes_moved({}) as moved:
        for _ in range(n):
            step(x, y, ZOO_LR)
        torch.cuda.synchronize()
    total = dict(fn.LAUNCHES)
    launches = {k: v / n for k, v in total.items()}
    relayouts = fn.RELAYOUTS / n
    variants = dict(fn.VARIANT_LAUNCHES)
    if variants["scalar"]:
        raise RuntimeError(f"zoo_breakdown: the scalar fused-norm variant "
                           f"launched ({variants})")
    hbm = peaks_for(torch.cuda.get_device_name(0))[1]["hbm"]
    bound = {k: v / n / hbm * 1e3 for k, v in moved.items()}
    by_cat, kernels = _device_kernels(prof, n, _zoo_category)
    busy = sum(by_cat.values())
    del model, step
    out = {"phase": "zoo_breakdown", "arch": "densenet121", "batch": ZOO_B,
           "image_size": TRAIN_PX, "dtype": "bfloat16", "fused_bn": "on",
           "wall_ms_p50": wall, "images_per_s": ZOO_B / wall * 1e3,
           "device_busy_ms": busy if busy else "not measured",
           "idle_share": 1.0 - busy / wall if busy else "not measured",
           "by_category_ms": by_cat or "not measured",
           "kernel_launches_per_step": sum(k["calls"] for k in kernels),
           "fused_norm_launches_per_step": launches,
           "fused_norm_launches": total,
           "fused_norm_device_ms_per_step": _fused_norm_device_ms(prof, n)
           or "not measured",
           "fused_norm_bound_ms_per_step": bound,
           "fused_norm_scalar_kernels_ms_per_step": ZOO_BREAKDOWN_SCALAR_MS,
           "variant_launches": variants,
           "relayouts_per_step": relayouts,
           "top_kernels": kernels[:20]}
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    return out


# zoo_vs_cpu: the BatchNorm+ReLU conv families through --fused-bn on, the
# card against the CPU in f32 (TF32 off) at batch ZOO_CMP_B, inception_v3 at
# 299 px with its aux loss at ZOO_AUX_WEIGHT (tpudist's). Each model's
# bounds on ‖card − cpu‖₂ / ‖cpu‖₂, of the worst leaf and of the median
# leaf, are about 3x their first readings on the card (an NVIDIA H100
# 80GB HBM3 at 700 W, PERF.md §6): worst vgg16_bn 6.4e-3, densenet121
# 1.9e-2, googlenet 2.0e-2, inception_v3 5.1e-2, mobilenet_v3_large
# 8.9e-6, regnet_y_400mf 3.2e-2; median 3.6e-3, 2.8e-3, 1.1e-2, 3.5e-2,
# 5.9e-6, 1.5e-2. Four read above 1e-2, and that is f32 itself, not a
# kernel: BatchNorm over 2 images divides each f32 rounding by a tiny
# spread and every ReLU after it flips where a pre-activation sits at 0.
# chip_numerics.py (the same models, seed-0 weights) shows it: the card
# with the plain epilogue (no kernel of the port) reads as far from the
# CPU as the card with B1/B3 (googlenet 2.8e-2 / 3.0e-2, inception_v3
# 5.0e-2 / 4.9e-2, regnet_y_400mf 2.5e-2 / 2.3e-2, densenet121 1.4e-2 /
# 9.9e-3), and the f32 CPU is itself that far from the same step in
# float64 (inception_v3 4.7e-2, regnet_y_400mf 3.6e-2, densenet121
# 1.9e-2), as far as the card is (3.4e-2, 3.8e-2, 1.9e-2). A leaf under
# ZOO_GRAD_FLOOR of the largest's norm is 0 but for rounding (vgg16_bn's
# conv biases ahead of a batch-statistics BatchNorm, densenet121's
# norm0.scale at 3.8e-7) and is held by REST_CMP_TOL · (1 + max|cpu|).
ZOO_CMP_B = 2
ZOO_AUX_WEIGHT = 0.4
ZOO_GRAD_FLOOR = 1e-5
ZOO_GRAD_TOL = {"vgg16_bn": 2e-2, "densenet121": 6e-2, "googlenet": 6e-2,
                "inception_v3": 0.15, "mobilenet_v3_large": 3e-5,
                "regnet_y_400mf": 0.1}
ZOO_GRAD_MEDIAN_TOL = {"vgg16_bn": 1.1e-2, "densenet121": 9e-3,
                       "googlenet": 3.5e-2, "inception_v3": 0.1,
                       "mobilenet_v3_large": 2e-5, "regnet_y_400mf": 4.5e-2}


def _zoo_cmp_inputs():
    """Each ZOO_MODELS arch with its batch of ZOO_CMP_B images and labels,
    drawn from one seeded generator in the models' order."""
    rng = np.random.default_rng(23)
    labels = torch.from_numpy(rng.integers(0, 1000, ZOO_CMP_B))
    for arch, px, sites in ZOO_MODELS:
        images = torch.from_numpy(rng.standard_normal(
            (ZOO_CMP_B, px, px, 3)).astype(np.float32))
        yield arch, px, sites, images, labels


def _zoo_vs_cpu_row(arch: str, px: int, images, labels) -> dict:
    """``arch``'s seed-0 weights on the CPU and on the card through
    ``--fused-bn on``, one train-mode step each (``_card_vs_cpu_row``
    against ZOO_GRAD_TOL and ZOO_GRAD_MEDIAN_TOL above ZOO_GRAD_FLOOR),
    with the card's launches."""
    cpu_model = create_model(arch, dtype=torch.float32, fused_bn=True)
    cpu_model.load_state_dict(_seed0_weights(arch))
    card = create_model(arch, dtype=torch.float32, fused_bn=True)
    card.load_state_dict(_seed0_weights(arch))
    card.cuda()
    fn.reset_counts()
    fa.reset_counts()
    row = _card_vs_cpu_row(
        arch, cpu_model, card, images, labels, ZOO_GRAD_TOL[arch],
        aux_weight=ZOO_AUX_WEIGHT if arch == "inception_v3" else 0.0,
        floor=ZOO_GRAD_FLOOR, median_tol=ZOO_GRAD_MEDIAN_TOL[arch])
    row.update(image_size=px, launches={**fn.LAUNCHES, **fa.LAUNCHES})
    del cpu_model, card
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_zoo_vs_cpu() -> dict:
    """The card computes what the CPU tests hold, for the conv families:
    each ZOO_MODELS arch at full width, f32 with TF32 off, the same seed-0
    weights and dropout masks, batch ZOO_CMP_B, one train-mode forward and
    backward with every BN+ReLU site on the fused ``Function`` (B1 and B3
    on the card, their plain bodies on the CPU), held by
    ``_zoo_vs_cpu_row``. Each model's card run launches B1 and B3 once a
    fused site and B2/B4 never."""
    rows, bad = {}, []
    for arch, px, _, images, labels in _zoo_cmp_inputs():
        row = rows[arch] = _zoo_vs_cpu_row(arch, px, images, labels)
        got = row["launches"]
        if not row["ok"] or not got["bn_act_fwd"] \
                or got["bn_act_fwd"] != got["bn_act_bwd"] \
                or got["bn_act_fwd_res"] or got["bn_act_bwd_res"] \
                or any(got[k] for k in fa.KERNELS):
            bad.append(f"{arch}: {row}")
    out = {"phase": "zoo_vs_cpu", "batch": ZOO_CMP_B, "dtype": "float32",
           "tf32": False, "fused_bn": "on", "masks": "drawn on the host in "
           "the CPU run, replayed on the card", "models": rows}
    emit(out)
    if bad:
        raise RuntimeError("zoo_vs_cpu: " + "; ".join(bad))
    return out


def zoo_vs_cpu_mutations() -> dict:
    """Each of ``ZOO_FAULTS`` in the card's B3, in each zoo model's
    ``zoo_vs_cpu`` comparison against the sound CPU: whether its bounds
    fail it."""
    caught = {}
    for arch, px, sites, images, labels in _zoo_cmp_inputs():
        for kind in ZOO_FAULTS:
            with _b3_fault(kind, sites):
                row = _zoo_vs_cpu_row(arch, px, images, labels)
            caught[f"vs_cpu/{arch}/{kind}"] = not row["ok"]
            emit({"phase": "mutation", "mutation": f"b3_{kind}",
                  "against": "zoo_vs_cpu", "arch": arch,
                  "breaks_bounds": not row["ok"], "row": row})
    return caught


def phase_zoo_serve() -> dict:
    """Each family served at bucket 8 in bf16 (fresh seed-0 weights): the
    served logits against the model's own eval forward of the same images
    (within ``LOGITS_TOL`` × max(1, max|logit|); eval-mode BatchNorm is the
    plain epilogue, so no kernel launches)."""
    rows = {}
    fn.reset_counts()
    for arch, px, _ in ZOO_MODELS:
        model = load_serve_state(arch, num_classes=1000, image_size=px,
                                 max_batch=8, dtype=torch.bfloat16,
                                 seed=0)
        engine = ServeEngine(model, image_size=px, buckets=(8,))
        images = np.random.default_rng(5).standard_normal(
            (8, px, px, 3)).astype(np.float32)
        t0 = time.perf_counter()
        got = engine.infer(images)
        served_ms = (time.perf_counter() - t0) * 1e3
        with torch.inference_mode():
            want = model(torch.from_numpy(images).cuda()).float().cpu() \
                .numpy()
        err = float(np.abs(got.astype(np.float32) - want).max())
        bound = LOGITS_TOL * max(1.0, float(np.abs(want).max()))
        rows[arch] = {"image_size": px, "logits_max_abs_diff": err,
                      "bound": bound, "served_ms": served_ms,
                      "finite": bool(np.isfinite(got).all())}
        if not err <= bound or not rows[arch]["finite"] \
                or got.shape != (8, 1000):
            raise RuntimeError(f"zoo_serve {arch}: {rows[arch]}")
        del engine, model
    if any(fn.LAUNCHES.values()):
        raise RuntimeError(f"zoo_serve: eval launched {fn.LAUNCHES}")
    gc.collect()
    torch.cuda.empty_cache()
    out = {"phase": "zoo_serve", "bucket": 8, "models": rows}
    emit(out)
    return out


# -- phase 12: the rest of the one-card zoo ------------------------------------

# Ten representatives of the families that reach no kernel of the port (as
# in tpudist: efficientnet's, mnasnet's, shufflenet's and maxvit's
# BatchNorms are followed by SiLU, a ReLU outside the norm or GELU; alexnet
# and squeezenet have none; convnext and swin LayerNorm; swin's and
# maxvit's attention carries a relative-position bias), with torchvision's
# recipe optimizers: (arch, optimizer, lr).
REST_MODELS = [("alexnet", "sgd", 0.01), ("squeezenet1_1", "sgd", 0.01),
               ("mnasnet1_0", "sgd", 0.1), ("shufflenet_v2_x1_0", "sgd", 0.1),
               ("efficientnet_b0", "sgd", 0.1),
               ("efficientnet_v2_s", "sgd", 0.1),
               ("convnext_tiny", "adamw", 1e-3), ("swin_t", "adamw", 1e-3),
               ("swin_v2_t", "adamw", 1e-3), ("maxvit_t", "adamw", 1e-3)]
REST_B = 128                    # torchvision's per-card recipe batch
REST_STEPS = 3
REST_TIMED = 3
REST_CMP_B = 2                  # the card against the CPU, f32
# The card's f32 gradients against the CPU's, ‖card − cpu‖₂ / ‖cpu‖₂ of
# the worst leaf, per model: about 3x the first reading on the card (an
# NVIDIA H100 80GB HBM3 at 700 W, PERF.md §6), at most 1e-2 where the
# reading allows. A leaf under REST_GRAD_FLOOR of the largest leaf's norm
# (a BatchNorm bias whose output the next BatchNorm normalises away: 1e-8
# to 6e-8 of the largest) is 0 but for rounding and is held by
# REST_CMP_TOL · (1 + max|cpu|) alone; convnext's blocks, behind a layer
# scale of 1e-6, sit at 4e-7 and are held relatively. The first readings:
# alexnet 1.6e-6, squeezenet1_1 9.0e-7, efficientnet_b0 1.9e-5,
# efficientnet_v2_s 6.5e-5, convnext_tiny 1.6e-6, swin_t 1.5e-6,
# swin_v2_t 9.3e-6, maxvit_t 7.5e-6 (after the padded average pool was
# worked around: 0.98 before, layers.avg_pool_padded). mnasnet1_0 and
# shufflenet_v2_x1_0 read 1.13e-2 and 8.65e-3: a ReLU after a BatchNorm
# over 2 images at init flips where the two devices' f32 accumulation
# orders put a pre-activation on either side of 0, and the BatchNorm
# backward spreads each flip over its channel (chip_numerics.py: the CPU
# with 1 thread against 4 reads 3.3e-3 for mnasnet1_0; efficientnet's
# SiLU is smooth and reads 1.9e-5); their bound is 5e-2, above 1e-2, and
# a zeroed or wrong gradient still reads ≈ 1 (the average pool's 0.98).
REST_CMP_TOL = 1e-4
REST_GRAD_FLOOR = 1e-7
REST_GRAD_TOL = {"alexnet": 5e-6, "squeezenet1_1": 3e-6,
                 "mnasnet1_0": 5e-2, "shufflenet_v2_x1_0": 5e-2,
                 "efficientnet_b0": 6e-5, "efficientnet_v2_s": 2e-4,
                 "convnext_tiny": 5e-6, "swin_t": 5e-6, "swin_v2_t": 3e-5,
                 "maxvit_t": 2.5e-5}


def _rest_cfg(arch: str, optimizer: str, lr: float):
    return config_lib.Config(
        arch=arch, batch_size=REST_B, image_size=TRAIN_PX,
        optimizer=optimizer, lr=lr,
        weight_decay=0.05 if optimizer == "adamw" else 1e-4, seed=0)


def _rest_weights(arch: str) -> dict:
    """``arch``'s seed-0 f32 weights, drawn once on the host."""
    model = create_model(arch, dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return {k: v.clone() for k, v in model.state_dict().items()}


def phase_rest_train(weights: dict) -> dict:
    """The ten at full width, 224 px, batch REST_B, bf16: ``REST_STEPS``
    steps of the train step (dropout and stochastic depth live, drawn on
    the card from the step's seed) on device batches, every loss finite,
    every leaf (parameters and BatchNorm statistics) moved, and B1–B7
    launched 0 times; then ``REST_TIMED`` synchronised steps (median wall,
    images/s) and ``max_memory_allocated``. A model that does not fit at
    REST_B fails the phase."""
    rows, bad = {}, []
    for arch, optimizer, lr in REST_MODELS:
        torch.cuda.reset_peak_memory_stats()
        model = create_model(arch, dtype=torch.bfloat16)
        model.load_state_dict(weights[arch])
        model.cuda()
        cfg = _rest_cfg(arch, optimizer, lr)
        step = train_lib.make_train_step(
            model, train_lib.make_optimizer(model, cfg), cfg)
        init = _leaves(model)
        batches = _cmp_batches(REST_B, TRAIN_PX, REST_STEPS)
        fn.reset_counts()
        fa.reset_counts()
        t0 = time.perf_counter()
        losses = [float(step(x, y, lr)["loss"]) for x, y in batches]
        first_steps_s = time.perf_counter() - t0
        launches = {**fn.LAUNCHES, **fa.LAUNCHES}
        last = _leaves(model)
        unmoved = [k for k, v in last.items() if torch.equal(v, init[k])]
        walls = []
        for _ in range(REST_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(*batches[-1], lr)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(walls)
        rows[arch] = {"optimizer": optimizer, "lr": lr, "losses": losses,
                      "leaves": len(last), "unmoved": unmoved,
                      "launches": launches, "step_ms_p50": wall,
                      "first_steps_s": first_steps_s,
                      "step_ms": walls, "images_per_s": REST_B / wall * 1e3,
                      "max_memory_allocated_gb":
                      torch.cuda.max_memory_allocated() / 1e9}
        if not all(np.isfinite(losses)) or unmoved \
                or any(launches.values()):
            bad.append(f"{arch}: losses {losses}, unmoved {unmoved[:4]}, "
                       f"launches {launches}")
        del model, step, init, last, batches
        gc.collect()
        torch.cuda.empty_cache()
    out = {"phase": "rest_train", "batch": REST_B, "image_size": TRAIN_PX,
           "dtype": "bfloat16", "steps": REST_STEPS, "timed": REST_TIMED,
           "models": rows}
    emit(out)
    if bad:
        raise RuntimeError("rest_train: " + "; ".join(bad))
    return out


def _train_pass(model, images, labels, masks: list, replay: bool,
                aux_weight: float = 0.0):
    """One train-mode forward and backward of ``model`` (the loss, logits,
    gradients and BatchNorm statistics on the host), aux heads' losses at
    ``aux_weight``. The dropout and stochastic-depth masks are recorded
    into ``masks`` (drawn on the host from a fixed seed) or, with
    ``replay``, taken from it in order."""
    real = model_layers._keep_mask
    queue = iter(masks)

    def keep(shape, keep_prob, device):
        if replay:
            want_p, mask = next(queue)
            if want_p != keep_prob or tuple(mask.shape) != tuple(shape):
                raise RuntimeError(f"mask ({keep_prob}, {shape}) asked "
                                   f"where ({want_p}, {mask.shape}) drew")
            return mask.to(device)
        mask = real(shape, keep_prob, device)
        masks.append((keep_prob, mask.cpu()))
        return mask

    model_layers._keep_mask = keep
    try:
        with model_layers.dropout_seed(11):
            loss, logits = train_lib.forward_loss(model.train(), images,
                                                  labels, None, None, 0.0,
                                                  aux_weight=aux_weight)
        loss.backward()
    finally:
        model_layers._keep_mask = real
    if replay and next(queue, None) is not None:
        raise RuntimeError("the card drew fewer masks than the CPU")
    return (float(loss.detach()), logits.detach().cpu(),
            {k: p.grad.detach().cpu() for k, p in model.named_parameters()},
            {k: b.detach().cpu() for k, b in model.named_buffers()
             if b.is_floating_point()})


def _card_vs_cpu_row(arch: str, cpu_model, card, images, labels,
                     grad_tol: float, aux_weight: float = 0.0,
                     floor: float = REST_GRAD_FLOOR,
                     median_tol: float = math.inf) -> dict:
    """One f32 train-mode forward and backward of the same weights on the
    CPU and on the card (the CPU's dropout masks replayed there): the loss,
    logits and BatchNorm statistics against REST_CMP_TOL × (1 +
    max|cpu|), each gradient's ‖card − cpu‖₂ / ‖cpu‖₂ against ``grad_tol``
    and their median against ``median_tol`` (a leaf under ``floor`` of
    the largest is held by REST_CMP_TOL alone); ``ok`` says whether all
    hold."""
    masks: list = []
    t0 = time.perf_counter()
    loss_c, logits_c, grads_c, stats_c = _train_pass(
        cpu_model, images, labels, masks, replay=False,
        aux_weight=aux_weight)
    cpu_s = time.perf_counter() - t0
    loss_g, logits_g, grads_g, stats_g = _train_pass(
        card, images.cuda(), labels.cuda(), masks, replay=True,
        aux_weight=aux_weight)
    top = max(float(g.norm()) for g in grads_c.values())
    rel, floor_abs, share = {}, {}, {}
    for k, want in grads_c.items():
        diff = grads_g[k] - want
        share[k] = float(want.norm()) / top
        if share[k] >= floor:
            rel[k] = float(diff.norm() / want.norm())
        else:
            floor_abs[k] = float(diff.abs().max()) / (
                1 + float(want.abs().max()))
    worst = max(rel, key=rel.get)
    logit_err = float((logits_g - logits_c).abs().max()) / (
        1 + float(logits_c.abs().max()))
    stat_err = max([float((stats_g[k] - v).abs().max())
                    / (1 + float(v.abs().max()))
                    for k, v in stats_c.items()] or [0.0])
    row = {"loss_cpu": loss_c, "loss_card": loss_g,
           "loss_err": abs(loss_g - loss_c) / (1 + abs(loss_c)),
           "logits_err": logit_err, "stats_err": stat_err,
           "masks": len(masks), "grad_l2_rel_max": rel[worst],
           "grad_l2_rel_worst_leaf": worst,
           "grad_l2_rel_median": statistics.median(rel.values()),
           "grad_worst_leaves": [(k, rel[k], share[k]) for k in sorted(
               rel, key=rel.get, reverse=True)[:4]],
           "floor_leaves": len(floor_abs),
           "floor_abs_max": max(floor_abs.values(), default=0.0),
           "grad_tol": grad_tol, "cpu_s": cpu_s}
    row["ok"] = (row["loss_err"] <= REST_CMP_TOL
                 and logit_err <= REST_CMP_TOL and stat_err <= REST_CMP_TOL
                 and rel[worst] <= grad_tol
                 and row["grad_l2_rel_median"] <= median_tol
                 and row["floor_abs_max"] <= REST_CMP_TOL)
    if median_tol < math.inf:
        row["grad_median_tol"] = median_tol
    return row


def phase_rest_vs_cpu(weights: dict) -> dict:
    """The card computes what the CPU-tested path computes: each of the
    ten, f32 with TF32 off, the same seed-0 weights, batch REST_CMP_B at
    224 px, the same dropout and stochastic-depth masks (drawn once on the
    host in the CPU run and handed to the card's), one train-mode forward
    and backward on the CPU and on the card: the loss and logits within
    REST_CMP_TOL × (1 + max|cpu|), the BatchNorm statistics too, and each
    gradient's ‖card − cpu‖₂ / ‖cpu‖₂ within REST_GRAD_TOL (no kernel of
    the port on the card: B1–B7 launch 0 times)."""
    rng = np.random.default_rng(21)
    images = torch.from_numpy(rng.standard_normal(
        (REST_CMP_B, TRAIN_PX, TRAIN_PX, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 1000, REST_CMP_B))
    rows, bad = {}, []
    fn.reset_counts()
    fa.reset_counts()
    for arch, _, _ in REST_MODELS:
        cpu_model = create_model(arch, dtype=torch.float32)
        cpu_model.load_state_dict(weights[arch])
        card = create_model(arch, dtype=torch.float32)
        card.load_state_dict(weights[arch])
        card.cuda()
        row = _card_vs_cpu_row(arch, cpu_model, card, images, labels,
                               REST_GRAD_TOL[arch])
        rows[arch] = row
        if not row["ok"]:
            bad.append(f"{arch}: {row}")
        del cpu_model, card
        gc.collect()
        torch.cuda.empty_cache()
    launches = {**fn.LAUNCHES, **fa.LAUNCHES}
    out = {"phase": "rest_vs_cpu", "batch": REST_CMP_B, "dtype": "float32",
           "tf32": False, "masks": "drawn on the host in the CPU run, "
           "replayed on the card", "launches": launches, "models": rows}
    emit(out)
    if bad or any(launches.values()):
        raise RuntimeError(f"rest_vs_cpu: launches {launches}; "
                           + "; ".join(bad))
    return out


REST_CLI = ["--synthetic", "-a", "swin_v2_t", "--image-size", "224",
            "--num-classes", "1000", "-b", str(REST_B), "--use_amp",
            "--optimizer", "adamw", "--lr", "1e-3", "--weight-decay", "0.05",
            "--synthetic-size", str(3 * REST_B), "--epochs", "1", "-p", "1",
            "--keep-checkpoints", "0", "--telemetry", "--seed", "0"]
NO_BN_LINE = ("=> fused-norm dispatch: plain epilogue (mode auto, "
              "ineligible; swin_v2_t has no BatchNorm)")


def _no_decay_by_tpudists_rule(model) -> set:
    """The parameters tpudist's ``no_decay_mask`` keeps out of weight
    decay, by name: fewer than two dims, ``relative_position_bias_table``,
    ``logit_scale``, and everything under a ``cpb_mlp`` module."""
    out = set()
    for name, p in model.named_parameters():
        *mods, leaf = name.split(".")
        if p.ndim < 2 or leaf in ("relative_position_bias_table",
                                  "logit_scale") \
                or any("cpb_mlp" in m for m in mods):
            out.add(name)
    return out


def phase_rest_cli() -> dict:
    """``python -m tpudist_torch -a swin_v2_t --optimizer adamw`` in this
    process, one epoch of 3 steps at 224 px, batch REST_B, bf16, with
    tpudist's defaults ``--fused-bn auto --flash auto``: the optimizer's
    no-decay group holds exactly the parameters tpudist's
    ``no_decay_mask`` excludes (by name), the fused-norm dispatch logs
    the plain epilogue for a model without BatchNorm and records no
    workload, no attention dispatch and no probe run, no kernel launches,
    and the epoch's train and validation losses are finite."""
    from tpudist_torch import trainer as trainer_mod
    made = []
    real = trainer_mod.make_optimizer

    def recording(model, cfg):
        opt = real(model, cfg)
        made.append((model, opt))
        return opt

    root = tempfile.mkdtemp(prefix="tpudist_torch_rest_cli_")
    trainer_mod.make_optimizer = recording
    try:
        t0 = time.perf_counter()
        text, events, launches = _run_cli(
            REST_CLI + ["--outpath", os.path.join(root, "run")],
            "swin_v2_t --optimizer adamw")
        wall_s = time.perf_counter() - t0
    finally:
        trainer_mod.make_optimizer = real
        shutil.rmtree(root, ignore_errors=True)
    model, opt = made[-1]
    params = dict(model.named_parameters())
    names = {id(p): n for n, p in params.items()}
    groups = [{names[id(p)] for p in g["params"]} for g in opt.param_groups]
    decay = [g["weight_decay"] for g in opt.param_groups]
    want = _no_decay_by_tpudists_rule(model)
    steps = [e for e in events if e["type"] == "step"]
    disp = [e for e in events if e["type"] == "fused_norm_dispatch"]
    attn = [e for e in events if e["type"] == "attention_dispatch"]
    losses = _epoch_losses(text, "Train") + _epoch_losses(text, "Val")
    out = {"phase": "rest_cli", "arch": "swin_v2_t", "batch": REST_B,
           "steps": len(steps), "losses": losses, "wall_s": wall_s,
           "weight_decay": decay, "decay_params": len(groups[0]),
           "no_decay_params": len(groups[1]),
           "no_decay_by_tpudists_rule": len(want),
           "no_decay_ndim_ge_2": sorted(n for n in groups[1]
                                        if params[n].ndim >= 2)[:6],
           "fused_norm_dispatch": disp[-1] if disp else None,
           "attention_dispatch_events": len(attn), "launches": launches}
    emit(out)
    if decay != [0.05, 0.0] or groups[1] != want \
            or groups[0] != set(names.values()) - want \
            or len(steps) != 3 or len(losses) != 2 \
            or not all(np.isfinite(losses)) \
            or NO_BN_LINE not in text.splitlines() \
            or not disp or disp[-1].get("n_sites") != 0 or attn \
            or PROBE_LINE_RE.search(text) is not None \
            or any(launches.values()):
        raise RuntimeError(f"rest_cli: {out}")
    return out


def phase_rest_serve(weights: dict) -> dict:
    """The ten served at bucket 8 in bf16 (the seed-0 weights): the served
    logits against the model's own eval forward of the same images
    (within ``LOGITS_TOL`` × max(1, max|logit|)), and no kernel
    launches."""
    rows = {}
    fn.reset_counts()
    fa.reset_counts()
    images = np.random.default_rng(6).standard_normal(
        (8, TRAIN_PX, TRAIN_PX, 3)).astype(np.float32)
    for arch, _, _ in REST_MODELS:
        model = load_serve_state(arch, num_classes=1000, image_size=TRAIN_PX,
                                 max_batch=8, dtype=torch.bfloat16, seed=0)
        model.load_state_dict(weights[arch])
        engine = ServeEngine(model, image_size=TRAIN_PX, buckets=(8,))
        engine.infer(images)                              # warm
        t0 = time.perf_counter()
        got = engine.infer(images)
        served_ms = (time.perf_counter() - t0) * 1e3
        with torch.inference_mode():
            want = model(torch.from_numpy(images).cuda()).float().cpu() \
                .numpy()
        err = float(np.abs(got.astype(np.float32) - want).max())
        bound = LOGITS_TOL * max(1.0, float(np.abs(want).max()))
        rows[arch] = {"logits_max_abs_diff": err, "bound": bound,
                      "served_ms": served_ms,
                      "finite": bool(np.isfinite(got).all())}
        if not err <= bound or not rows[arch]["finite"] \
                or got.shape != (8, 1000):
            raise RuntimeError(f"rest_serve {arch}: {rows[arch]}")
        del engine, model
    launches = {**fn.LAUNCHES, **fa.LAUNCHES}
    if any(launches.values()):
        raise RuntimeError(f"rest_serve: eval launched {launches}")
    gc.collect()
    torch.cuda.empty_cache()
    out = {"phase": "rest_serve", "bucket": 8, "image_size": TRAIN_PX,
           "launches": launches, "models": rows}
    emit(out)
    return out


def _launches_by_path(ck: dict, name: str, dtype: str) -> dict:
    """A kernel's launches on each path of one storage dtype (counted from
    0 in each run's process, or set to 0 before each run in this one):
    ``"float16"`` the float16 paths, ``"bfloat16"`` the bf16 and f32 ones
    beyond ``train``, ``train_vit`` and ``serve``."""
    out = {}
    if dtype == "float16":
        r18 = ck["checkpoint_resume"]["fused_norm_launches"]
        if name in r18["a"]:
            out.update({"train_ddp (checkpoint_resume_a)": r18["a"][name],
                        "checkpoint_resume_b_attempt0": r18["b0"][name],
                        "checkpoint_resume_b_attempt1": r18["b1"][name]})
            for phase in ("preempt_resume", "faults_on_card"):
                for run, got in ck[phase]["fused_norm_launches"].items():
                    out[f"{phase}_{run}"] = got[name]
        vit_ddp = ck["train_vit_ddp"]["launches"]
        if name in fa.KERNELS:
            out["train_vit_ddp"] = vit_ddp[name]
        for arch in ("resnet18", "vit_b_16"):
            row = ck["fp16_train"][arch]
            land = row["landing"]
            if name in land["launches_per_step"]:
                out[f"fp16_train_{arch}_from_65536"] = int(
                    land["launches_per_step"][name]
                    * (land["skipped_from_65536"] + 1))
                out[f"fp16_train_{arch}_on"] = row["row"]["launches_on"][
                    name]
        for tag, row in ck["fp16_cli"].items():
            if isinstance(row, dict) and name in row.get("launches", {}):
                probe = row["probe_launches"].get(name, 0)
                out[f"fp16_cli_{tag}"] = row["launches"][name] - probe
                if probe:
                    out[f"fp16_cli_{tag}_probe"] = probe
        return out
    for run, row in ck["checkpoint_vit"]["runs"].items():
        if name in row["flash_launches"]:
            out[f"checkpoint_vit_{run}"] = row["flash_launches"][name]
    served = ck["serve_checkpoint"]["vit_b_16"]["launches"]
    if name == "flash_fwd":
        out["serve_checkpoint"] = served[name]
    images = ck["train_imagefolder"]
    for run, key in (("resnet18", "train_imagefolder (decode_fail)"),
                     ("vit_b_16", "train_imagefolder_vit")):
        if name in images[run]["launches"]:
            out[key] = images[run]["launches"][name]
    vit = ck["torch_checkpoint"]["vit_b_16"]
    if name in vit["train_launches"]:
        out["torch_checkpoint_vit_pretrained_steps"] = \
            vit["train_launches"][name]
    if name == "flash_fwd":
        out["torch_checkpoint_vit_logits"] = vit["logits_launches"][name]
    # The dispatch's probes compare each kernel with its plain side; their
    # launches are kept apart.
    disp = ck["dispatch_auto"]
    for arch in ("resnet18", "vit_b_16"):
        for run in ("measure", "cached"):
            row = disp[arch][run]
            if name in row["launches"]:
                probe = row["probe_launches"].get(name, 0)
                out[f"dispatch_auto_{arch}_{run}"] = \
                    row["launches"][name] - probe
                if probe:
                    out[f"dispatch_auto_{arch}_{run}_probe"] = probe
        for row in ck["accum_mixup"][arch]["rows"]:
            if name in row["launches_per_step"]:
                out[f"accum_mixup_{arch}_{row['dtype']}"] = \
                    row["launches_per_step"][name] * TRAIN_CMP_STEPS
    if name == "flash_fwd":
        probe = disp["serve"]["probe_launches"]
        out["dispatch_auto_serve"] = disp["serve"]["launches"][name] - probe
        out["dispatch_auto_serve_probe"] = probe
    doc = ck["doctor"]
    for run in ("nanbomb", "lossbomb"):
        if name in doc[run]["fused_norm_launches"]:
            out[f"doctor_{run}"] = doc[run]["fused_norm_launches"][name]
    if name in fn.KERNELS:
        out["doctor_nanbomb_skipped_step"] = doc["nanbomb"][
            "skipped_step"]["launches"][name]
    if name in doc["vit_b_16"]["launches"]:
        out["doctor_vit_b_16_skipped_step"] = doc["vit_b_16"]["launches"][
            name]
    if name in fn.KERNELS:
        for arch, row in ck["zoo_train"]["models"].items():
            out[f"zoo_train_{arch}"] = row["launches_on"].get(name, 0)
            out[f"zoo_train_{arch}_float32"] = row["float32"][
                "launches_on"].get(name, 0)
        for mode in ("on", "auto"):
            row = ck["zoo_cli"][mode]
            probe = row["probe_launches"].get(name, 0)
            out[f"zoo_cli_densenet121_{mode}"] = row["launches"][name] - probe
            if probe:
                out[f"zoo_cli_densenet121_{mode}_probe"] = probe
        out["zoo_breakdown_densenet121"] = \
            ck["zoo_breakdown"]["fused_norm_launches"][name]
        for arch, row in ck["zoo_vs_cpu"]["models"].items():
            out[f"zoo_vs_cpu_{arch}_float32"] = row["launches"][name]
    # The rest of the zoo reaches no kernel, as in tpudist.
    for arch, row in ck["rest_train"]["models"].items():
        out[f"rest_train_{arch}"] = row["launches"].get(name, 0)
    for phase in ("rest_vs_cpu", "rest_cli", "rest_serve"):
        out[phase] = ck[phase]["launches"].get(name, 0)
    return out


def _entry_name(name: str, dtype: str) -> str:
    """A kernels-line entry's name: the kernel's, and for its float16
    instantiation the kernel's with `` (float16)``."""
    return name if dtype != "float16" else f"{name} (float16)"


def _mma_ptxas(card: dict, library: str, element: str) -> dict:
    """Registers and spills of a library's tensor-core kernels of one
    element type (``bf16`` or ``f16``), from this run's build (none if the
    library was built before it)."""
    return {k: r for k, r in card["ptxas"].get(library, {}).items()
            if f"_mma<{element}," in k}


def _fwd_kernel_entries(kern: dict, serve: dict, vit: dict, ck: dict,
                        card: dict) -> list:
    """The flash forward's entries of the kernels line, bf16 then float16:
    the main row is ViT-B/16's training shape (batch 128); ``launches``
    the bf16 serving and training runs, and the float16 CLI run."""
    out = []
    for dtype, prefix in (("bfloat16", ""), ("float16", "f16_")):
        rows = [r for r in kern["cases"] if r["dtype"] == dtype
                and r["case"].startswith((prefix + "serve_",
                                          prefix + "train_"))]
        main = rows[-1]
        if dtype == "float16":
            cli = ck["fp16_cli"]["vit_b_16_flash_on"]["launches"]
            launches = cli["flash_fwd"]
            paths = {}
        else:
            launches = (serve["flash_launches"]
                        + vit["flash_launches"]["flash_fwd"])
            paths = {"serve": serve["flash_launches"],
                     "train_vit": vit["flash_launches"]["flash_fwd"]}
        cases = [r for r in kern["cases"] if (r["dtype"] == "float16")
                 == (dtype == "float16")]
        out.append({
            "name": _entry_name("flash_fwd", dtype), "route": "cuda",
            "source": "tpudist_torch/ops/csrc/flash_fwd.cu",
            "replaces": "tpudist/ops/pallas/flash_attention.py:95 "
                        "(_flash_kernel, via _flash_forward)",
            "launches": launches,
            "launches_by_path": {
                **paths, **_launches_by_path(ck, "flash_fwd", dtype)},
            "max_abs_err": max(r["o_max_abs_err"] for r in cases),
            "ms": main["kernel_ms"], "kernel_ms": main["kernel_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": main["shape"], "dtype": main["dtype"],
            "by_batch": [{k: r[k] for k in ("shape", "kernel_ms", "plain_ms",
                                             "library_ms", "bound_ms")}
                         for r in rows],
            "o_not_bit_equal_share": {r["case"]: r["o_not_bit_equal_share"]
                                      for r in cases},
            "nonfinite": kern["nonfinite"] if dtype == "float16" else None,
            "ptxas": _mma_ptxas(card, "flash_fwd",
                                "f16" if dtype == "float16" else "bf16"),
            "card": card["nvidia_smi"]})
    return out


def _bwd_kernel_entries(bwd: dict, vit: dict, ck: dict, card: dict) -> list:
    """The dQ and dKV entries of the kernels line, bf16 then float16: the
    main row is ViT-B/16's training shape; ``step_ms`` is the kernel's time
    over one train step's 12 launches."""
    replaces = {
        "flash_bwd_dq": "tpudist/ops/pallas/flash_attention.py:373 "
                        "(_bwd_dq_kernel, via _flash_backward)",
        "flash_bwd_dkv": "tpudist/ops/pallas/flash_attention.py:425 "
                         "(_bwd_dkv_kernel, via _flash_backward)"}
    out = []
    for dtype in ("bfloat16", "float16"):
        cases = [c for c in bwd["cases"] if (c["dtype"] == "float16")
                 == (dtype == "float16")]
        main = cases[0]
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            r = main[name]
            if dtype == "float16":
                launches = ck["fp16_cli"]["vit_b_16_flash_on"]["launches"][
                    name]
                paths = {}
            else:
                launches = vit["flash_launches"][name]
                paths = {"train_vit": launches}
            element = "f16" if dtype == "float16" else "bf16"
            out.append({
                "name": _entry_name(name, dtype), "route": "cuda",
                "source": "tpudist_torch/ops/csrc/flash_bwd.cu",
                "replaces": replaces[name], "launches": launches,
                "launches_by_path": {
                    **paths, **_launches_by_path(ck, name, dtype)},
                "max_abs_err": max(c[name]["max_abs_err"] for c in cases),
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
                             for c in cases],
                "nonfinite": ({k: bwd["nonfinite"][k] for k in (
                    ("dq",) if name == "flash_bwd_dq" else ("dk", "dv"))}
                    if dtype == "float16" else None),
                "ptxas": {k: v for k, v in _mma_ptxas(
                    card, "flash_bwd", element).items()
                          if k.startswith(name + "_mma")},
                "card": card["nvidia_smi"]})
    return out


def _norm_kernel_entries(norm: dict, train: dict, ck: dict,
                         card: dict) -> list:
    """The four fused-norm entries of the kernels line, bf16 then float16:
    the main row is the largest main-path shape of each kernel (the stem
    for the plain epilogue, stage 1 for the residual one); ``step_ms`` sums
    the kernel's measured time over one step's launches at their shapes.
    The bf16 entries' ``by_shape`` also holds the f32 odd shapes."""
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
    for dtype in ("bfloat16", "float16"):
        for name in fn.KERNELS:
            rows = [r for r in norm["cases"] if r["kernel"] == name
                    and (r["dtype"] == "float16") == (dtype == "float16")]
            res = name.endswith("_res")
            main = [r for r in rows if r["dtype"] == dtype and r["case"]
                    == ("layer1" if res else "stem")][0]
            step_rows = [(r, per_step[r["case"]]) for r in rows
                         if r["dtype"] == dtype and r["case"] in per_step
                         and not (res and r["case"] == "stem")]
            if dtype == "float16":
                launches = ck["checkpoint_resume"]["fused_norm_launches"][
                    "a"][name]
                paths = {}
            else:
                launches = train["fused_norm_launches"][name]
                paths = {"train": launches,
                         "train_syncbn_ddp": ck["train_syncbn_ddp"][
                             "launches"][name]}
            out.append({
                "name": _entry_name(name, dtype), "route": "cuda",
                "source": "tpudist_torch/ops/csrc/fused_norm.cu",
                "replaces": replaces[name], "launches": launches,
                "launches_by_path": {
                    **paths, **_launches_by_path(ck, name, dtype)},
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": main["kernel_ms"], "kernel_ms": main["kernel_ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": None,
                "shape": main["shape"], "dtype": main["dtype"],
                "step_ms": sum(r["kernel_ms"] * k for r, k in step_rows),
                "step_bound_ms": sum(r["bound_ms"] * k for r, k in step_rows),
                "by_shape": [{k: r[k] for k in ("case", "shape", "dtype",
                                                "variant", "kernel_ms",
                                                "plain_ms", "bound_ms",
                                                "bound_share")}
                             for r in rows],
                "nonfinite": norm["nonfinite"] if dtype == "float16"
                else None,
                "card": card["nvidia_smi"]})
    return out


PHASE_S: dict = {}


def _timed(name: str, fn, *args):
    """``fn(*args)``, its seconds kept in ``PHASE_S[name]``; if it raises,
    the seconds of every phase so far are printed first."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    except BaseException:
        PHASE_S[name] = round(time.perf_counter() - t0, 3)
        emit({"phase_seconds": PHASE_S, "failed_in": name})
        raise
    finally:
        PHASE_S[name] = round(time.perf_counter() - t0, 3)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    if argv not in ([], ["--mutations"]):
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _timed("card_and_build", phase_card_and_build)
    if argv == ["--mutations"]:
        return run_mutations()
    _timed("startup", phase_startup)
    _, peaks = peaks_for(card["device_name"])
    kern = _timed("kernel_vs_plain", phase_kernel_vs_plain, peaks)
    bwd = _timed("flash_bwd_vs_plain", phase_flash_bwd_vs_plain, peaks)
    norm = _timed("fused_norm_vs_plain", phase_fused_norm_vs_plain, peaks)
    serve, model = _timed("serve", phase_serve)
    _timed("forward_breakdown", phase_forward_breakdown, model)
    del model
    _timed("serve_resnet", phase_serve_resnet)
    train = _timed("train", phase_train)
    _timed("fused_vs_plain_train", phase_fused_vs_plain)
    step = _timed("train_step_breakdown", phase_train_breakdown)
    vit = _timed("train_vit", phase_train_vit)
    _timed("flash_vs_plain_train", phase_flash_vs_plain_train)
    _timed("vit_train_step_breakdown", phase_vit_train_step_breakdown)
    disp = _timed("dispatch_auto", phase_dispatch_auto, card, kern, bwd,
                  norm)
    accum = _timed("accum_mixup", phase_accum_mixup)
    root = tempfile.mkdtemp(prefix="tpudist_torch_doctor_")
    try:
        doctor = _timed("doctor", phase_doctor, root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    fp16 = _timed("fp16_train", phase_fp16_train)
    fp16_cli = _timed("fp16_cli", phase_fp16_cli)
    zoo = {"zoo_train": _timed("zoo_train", phase_zoo_train),
           "zoo_cli": _timed("zoo_cli", phase_zoo_cli),
           "zoo_breakdown": _timed("zoo_breakdown", phase_zoo_breakdown)}
    _timed("zoo_serve", phase_zoo_serve)
    zoo["zoo_vs_cpu"] = _timed("zoo_vs_cpu", phase_zoo_vs_cpu)
    _WEIGHTS.clear()
    weights = _timed("rest_weights", lambda: {
        a: _rest_weights(a) for a, _, _ in REST_MODELS})
    zoo["rest_train"] = _timed("rest_train", phase_rest_train, weights)
    zoo["rest_vs_cpu"] = _timed("rest_vs_cpu", phase_rest_vs_cpu, weights)
    zoo["rest_cli"] = _timed("rest_cli", phase_rest_cli)
    zoo["rest_serve"] = _timed("rest_serve", phase_rest_serve, weights)
    del weights
    root = tempfile.mkdtemp(prefix="tpudist_torch_ckpt_")
    try:
        ddp = {"train_ddp": _timed("train_ddp", phase_train_ddp, root),
               "train_syncbn_ddp": _timed("train_syncbn_ddp",
                                          phase_train_syncbn_ddp, root),
               "train_vit_ddp": _timed("train_vit_ddp",
                                       phase_train_vit_ddp, root)}
        _timed("ddp_vs_plain", phase_ddp_vs_plain)
        ck = {"checkpoint_resume": _timed(
                  "checkpoint_resume", phase_checkpoint_resume, root, card,
                  ddp["train_ddp"]),
              "checkpoint_vit": _timed("checkpoint_vit",
                                       phase_checkpoint_vit, root, card)}
        ck["serve_checkpoint"] = _timed(
            "serve_checkpoint", phase_serve_checkpoint,
            ck["checkpoint_vit"]["run_dir"],
            ck["checkpoint_resume"]["run_dir"], card)
        ck["preempt_resume"] = _timed(
            "preempt_resume", phase_preempt_resume, root, card,
            ck["checkpoint_resume"]["run_dir"])
        ck["faults_on_card"] = _timed("faults_on_card",
                                      phase_faults_on_card, root, card)
        ck["torch_checkpoint"] = _timed(
            "torch_checkpoint", phase_torch_checkpoint, root, card,
            ck["faults_on_card"]["run_dir"], ck["checkpoint_vit"]["run_dir"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    root = tempfile.mkdtemp(prefix="tpudist_torch_images_")
    try:
        _timed("image_decode", phase_image_decode)
        tree = os.path.join(root, "imagefolder")
        _timed("imagefolder_corpus", phase_imagefolder_corpus, tree)
        _timed("native_vs_plain_host", phase_native_vs_plain_host, tree)
        rates = _timed("loader_rates", phase_loader_rates, tree, step)
        images = _timed("train_imagefolder", phase_train_imagefolder, tree)
        ck["decode_fail"] = _timed("decode_fail", phase_decode_fail, rates,
                                   images, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ck["train_imagefolder"] = images
    ck["dispatch_auto"] = disp
    ck["accum_mixup"] = accum
    ck["doctor"] = doctor
    emit({"phase_seconds": PHASE_S,
          "total_s": round(time.perf_counter() - t_start, 3)})

    ck.update(train_syncbn_ddp=ddp["train_syncbn_ddp"],
              train_vit_ddp=ddp["train_vit_ddp"], fp16_train=fp16,
              fp16_cli=fp16_cli, **zoo)
    emit({"kernels": _fwd_kernel_entries(kern, serve, vit, ck, card)
          + _bwd_kernel_entries(bwd, vit, ck, card)
          + _norm_kernel_entries(norm, train, ck, card)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
