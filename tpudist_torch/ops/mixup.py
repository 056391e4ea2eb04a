"""Mixup and CutMix inside the train step, and their loss.

Counterpart of ``tpudist/ops/mixup.py`` (``mix_batch``, ``mixed_ce``).
tpudist draws and mixes inside its compiled step from a key folded from
the seed, the optimizer step and the shard. The port splits that in two:

- ``draw_mix``, on the host: the permutation, mixup's ``lam``, cutmix's
  box (clipped, from its ``lam`` and a uniform centre) and, when both
  alphas are set, the choice between the two (uniform). It reads a
  ``torch.Generator`` seeded from (seed, optimizer step, rank)
  (``step_generator``), so a resumed or relaunched run draws what a
  straight run draws, and the card is never waited for;
- ``apply_mix``, on the device, on one rank's batch, once an optimizer
  step (before the batch is split into microbatches): mixup blends the
  batch with its permutation, cutmix pastes the permuted batch's box and
  ``lam`` becomes the share of the image left outside the clipped box.

The loss is ``mixed_ce``: ``lam·CE(out, y1) + (1 − lam)·CE(out, y2)``;
accuracy reads against ``y1``, the batch's own labels.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from tpudist_torch.ops.loss import cross_entropy_loss


def mixed_ce(logits: torch.Tensor, labels: torch.Tensor, labels2, lam,
             smoothing: float = 0.0) -> torch.Tensor:
    """Plain (smoothed) CE when there are no pair labels, else
    ``lam·CE(out, y1) + (1 − lam)·CE(out, y2)``."""
    loss = cross_entropy_loss(logits, labels, label_smoothing=smoothing)
    if labels2 is not None:
        loss = lam * loss + (1.0 - lam) * cross_entropy_loss(
            logits, labels2, label_smoothing=smoothing)
    return loss


@dataclass
class MixDraw:
    """One optimizer step's draw for a batch of ``len(perm)`` images:
    ``mixup`` picks the blend (with weight ``lam``, an f32 value) or the
    box ``(y0, y1, x0, x1)``, rows and columns ``[y0, y1) × [x0, x1)``."""
    perm: torch.Tensor
    mixup: bool
    lam: float
    box: tuple[int, int, int, int]


def step_generator(seed: int, step: int, rank: int) -> torch.Generator:
    """The host generator of one optimizer step on one rank."""
    state = np.random.SeedSequence([seed, step, rank]).generate_state(
        2, np.uint32)
    return torch.Generator().manual_seed(
        (int(state[0]) << 31) ^ int(state[1]))


def _uniform(g: torch.Generator) -> float:
    return float(torch.rand((), generator=g, dtype=torch.float64))


def _gamma(g: torch.Generator, a: float) -> float:
    """Gamma(a, 1) by Marsaglia and Tsang's method (with the U^(1/a) boost
    below a = 1)."""
    boost = 1.0
    if a < 1.0:
        boost = _uniform(g) ** (1.0 / a)
        a += 1.0
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        x = float(torch.randn((), generator=g, dtype=torch.float64))
        v = (1.0 + c * x) ** 3
        if v <= 0.0:
            continue
        u = _uniform(g)
        if math.log(max(u, 1e-300)) < 0.5 * x * x + d - d * v \
                + d * math.log(v):
            return d * v * boost


def _beta(g: torch.Generator, a: float) -> float:
    """Beta(a, a), as an f32 value."""
    x, y = _gamma(g, a), _gamma(g, a)
    return float(np.float32(x / (x + y)))


def cutmix_box(lam0: float, cy: int, cx: int, h: int,
               w: int) -> tuple[int, int, int, int]:
    """The box of area fraction ``1 − lam0`` centred at ``(cy, cx)``,
    clipped to the image, in tpudist's f32 arithmetic."""
    ratio = np.sqrt(np.float32(1.0) - np.float32(lam0))
    bh, bw = int(ratio * np.float32(h)), int(ratio * np.float32(w))
    return (min(max(cy - bh // 2, 0), h), min(max(cy + bh // 2, 0), h),
            min(max(cx - bw // 2, 0), w), min(max(cx + bw // 2, 0), w))


def draw_mix(g: torch.Generator, n: int, h: int, w: int,
             mixup_alpha: float, cutmix_alpha: float) -> MixDraw:
    """One step's draw from ``g`` for ``n`` images of ``h × w``: the
    permutation, mixup's lam, cutmix's box, and which of the two (one
    uniformly when both alphas are set)."""
    if not (mixup_alpha > 0.0 or cutmix_alpha > 0.0):
        raise ValueError("draw_mix needs --mixup-alpha or --cutmix-alpha")
    perm = torch.randperm(n, generator=g)
    lam = _beta(g, mixup_alpha or 1.0)
    lam0 = _beta(g, cutmix_alpha or 1.0)
    cy = int(torch.randint(0, h, (), generator=g))
    cx = int(torch.randint(0, w, (), generator=g))
    if mixup_alpha > 0.0 and cutmix_alpha > 0.0:
        use_mixup = _uniform(g) < 0.5
    else:
        use_mixup = mixup_alpha > 0.0
    return MixDraw(perm, use_mixup, lam, cutmix_box(lam0, cy, cx, h, w))


def apply_mix(images: torch.Tensor, labels: torch.Tensor, draw: MixDraw):
    """``(mixed_images, y1, y2, lam)`` for one rank's NHWC batch on its
    device: ``y1`` the batch's labels, ``y2`` its partners', ``lam`` the
    weight of ``y1`` (a host float)."""
    perm = draw.perm
    if images.is_cuda:
        # Pinned, so the copy is queued behind the step without a wait.
        perm = perm.pin_memory().to(images.device, non_blocking=True)
    shuffled = images[perm]
    y2 = labels[perm]
    if draw.mixup:
        # lam·x + (1 − lam)·x[perm] rounded once after the sum, as a fused
        # multiply-add (XLA's) rounds it: the f32 second term plus the
        # exact product in f64, then f32. Rounded twice, one ulp tips a
        # ReLU kink within a few accumulated steps.
        lam = np.float32(draw.lam)
        rest = torch.empty(images.shape, dtype=torch.float64,
                           device=images.device)
        torch.mul(shuffled, float(np.float32(1.0) - lam), out=rest)
        mixed = rest.add_(images, alpha=float(lam)).to(images.dtype)
        return mixed, labels, y2, float(lam)
    y0, y1, x0, x1 = draw.box
    h, w = images.shape[1], images.shape[2]
    mixed = images.clone()
    mixed[:, y0:y1, x0:x1, :] = shuffled[:, y0:y1, x0:x1, :]
    lam = np.float32(1.0) - np.float32((y1 - y0) * (x1 - x0)) \
        / np.float32(h * w)
    return mixed, labels, y2, float(lam)
