"""Numerics of the port on the card against the CPU, beside chip_smoke.py.

Run on a machine with a CUDA card (``python3 chip_numerics.py``); each
result is one JSON line, the card's name and power limit first.

- ``pool``: the input gradient of each pooling variant the port runs
  (average 3x3/s2/p1, 3x3/s1/p1, 5x5/s3, 2x2/s2; max 3x3/s2/p1, 3x3/s2,
  2x2/s2, 3x3/s2 ceil mode; adaptive average to 6x6), on the card over an
  NCHW-contiguous and a channels_last input, against the CPU's, as the
  largest absolute difference over the largest entry; and the same for
  ``layers.avg_pool_padded`` (the port's padded average pool).
- ``vs_cpu``: for each arch given (default: mnasnet1_0,
  shufflenet_v2_x1_0, inception_v3, maxvit_t), one f32 train-mode step
  (TF32 off, batch 2, seed-0 weights, the masks drawn on the host and
  replayed, as ``chip_smoke.phase_rest_vs_cpu``) on the CPU with 4
  threads, on the CPU with 1 thread and on the card: each leaf's
  ‖a − b‖₂ / ‖b‖₂ of card against CPU and of 1 thread against 4, over
  the leaves whose norm is at least 1e-4 of the largest's (the worst
  and the median).
- ``vs_cpu`` of the BatchNorm+ReLU conv families (``python3
  chip_numerics.py vgg16_bn densenet121 googlenet inception_v3
  mobilenet_v3_large regnet_y_400mf``, as ``chip_smoke.phase_zoo_vs_cpu``:
  seed-0 weights, inception_v3 at 299 px with its aux loss): the same three
  runs with
  every BN+ReLU site on the fused ``Function`` (its plain body on the CPU,
  B1 and B3 on the card), plus the card with the plain epilogue and the
  CPU in float64 (plain epilogue): each against the f32 CPU run, and the
  card's and the f32 CPU's distance to float64, so that a reading above
  1e-2 can be told from the run-to-run spread of f32 itself.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke as cs
from tpudist_torch.models.layers import avg_pool_padded

ARCHS = ("mnasnet1_0", "shufflenet_v2_x1_0", "inception_v3", "maxvit_t")
POOLS = {
    "avg_3x3_s2_p1": lambda t: F.avg_pool2d(t, 3, 2, 1),
    "avg_3x3_s1_p1": lambda t: F.avg_pool2d(t, 3, 1, 1),
    "avg_5x5_s3": lambda t: F.avg_pool2d(t, 5, 3),
    "avg_2x2_s2": lambda t: F.avg_pool2d(t, 2, 2),
    "max_3x3_s2_p1": lambda t: F.max_pool2d(t, 3, 2, 1),
    "max_3x3_s2": lambda t: F.max_pool2d(t, 3, 2),
    "max_2x2_s2": lambda t: F.max_pool2d(t, 2, 2),
    "max_3x3_s2_ceil": lambda t: F.max_pool2d(t, 3, 2, ceil_mode=True),
    "adaptive_avg_6x6": lambda t: F.adaptive_avg_pool2d(t, (6, 6)),
    "avg_pool_padded_3x3_s2_p1": lambda t: avg_pool_padded(t, 3, 2, 1),
    "avg_pool_padded_3x3_s1_p1": lambda t: avg_pool_padded(t, 3, 1, 1),
}


def _input_grad(fn, x: torch.Tensor) -> torch.Tensor:
    x = x.detach().requires_grad_(True)
    y = fn(x)
    g = torch.linspace(-1, 1, y.numel(), device=x.device).view(y.shape)
    (y * g).sum().backward()
    return x.grad.detach().cpu()


def pool() -> dict:
    x = torch.randn(2, 64, 35, 35, generator=torch.Generator().manual_seed(0))
    out = {}
    for name, fn in POOLS.items():
        want = _input_grad(fn, x)
        top = float(want.abs().max())
        out[name] = {
            layout: float((_input_grad(fn, x.cuda().contiguous(
                memory_format=fmt)) - want).abs().max()) / top
            for layout, fmt in (("nchw", torch.contiguous_format),
                                ("channels_last", torch.channels_last))}
    return out


def _rel(got: dict, want: dict) -> dict:
    top = max(float(g.norm()) for g in want.values())
    rel = {k: float((got[k] - w).norm() / w.norm()) for k, w in want.items()
           if float(w.norm()) >= 1e-4 * top}
    worst = max(rel, key=rel.get)
    return {"worst": rel[worst], "worst_leaf": worst,
            "median": statistics.median(rel.values())}


ZOO = {arch: px for arch, px, _ in cs.ZOO_MODELS}


def vs_cpu(arch: str) -> dict:
    zoo = arch in ZOO
    px = ZOO.get(arch, 299 if arch == "inception_v3" else cs.TRAIN_PX)
    rng = np.random.default_rng(21)
    images = torch.from_numpy(rng.standard_normal(
        (cs.REST_CMP_B, px, px, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 1000, cs.REST_CMP_B))
    if zoo:
        model = cs.create_model(arch, dtype=torch.float32)
        model.reset_parameters(torch.Generator().manual_seed(0))
        weights = model.state_dict()
        aux = cs.ZOO_AUX_WEIGHT if arch == "inception_v3" else 0.0
    else:
        weights, aux = cs._rest_weights(arch), 0.0
    grads, masks = {}, []
    # (name, CPU threads or None for the card, fused sites, dtype): the
    # rest of the zoo has no fused site, so the plain epilogue everywhere.
    runs = [("cpu4", 4, zoo, torch.float32), ("cpu1", 1, zoo, torch.float32),
            ("card", None, zoo, torch.float32)]
    if zoo:
        runs += [("card_plain", None, False, torch.float32),
                 ("cpu4_f64", 4, False, torch.float64)]
    for where, threads, fused, dtype in runs:
        model = cs.create_model(arch, dtype=dtype, fused_bn=fused)
        model.load_state_dict(weights)
        x, y = images, labels
        if dtype == torch.float64:      # the weights and every op in f64
            model.double()
            x = x.double()
        if threads is None:
            model.cuda()
            x, y = x.cuda(), y.cuda()
        else:
            torch.set_num_threads(threads)
        grads[where] = cs._train_pass(model, x, y, masks, replay=bool(masks),
                                      aux_weight=aux)[2]
    torch.set_num_threads(4)
    out = {"card_vs_cpu": _rel(grads["card"], grads["cpu4"]),
           "cpu1_vs_cpu4": _rel(grads["cpu1"], grads["cpu4"])}
    if zoo:
        f64 = {k: v.float() for k, v in grads["cpu4_f64"].items()}
        out.update(card_plain_vs_cpu=_rel(grads["card_plain"],
                                          grads["cpu4"]),
                   card_vs_f64=_rel(grads["card"], f64),
                   cpu4_vs_f64=_rel(grads["cpu4"], f64))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_numerics: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if any(arch in ZOO for arch in argv):
        cs._build.build_all(["fused_norm"])     # B1 and B3 on the card
    else:
        print(json.dumps({"pool": pool()}), flush=True)
    for arch in argv or ARCHS:
        print(json.dumps({"vs_cpu": arch, **vs_cpu(arch)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
