"""The mixup/cutmix loss: counterpart of ``tpudist/ops/mixup.py::mixed_ce``.

``mix_batch`` (the in-step mixing itself) is not in the port yet; the
trainer refuses ``--mixup-alpha``/``--cutmix-alpha``.
"""

from __future__ import annotations

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
