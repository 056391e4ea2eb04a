"""Classification metrics: counterpart of ``tpudist/ops/metrics.py``."""

from __future__ import annotations

import torch


def accuracy(scores: torch.Tensor, targets: torch.Tensor,
             topk: int = 1) -> torch.Tensor:
    """Percent of rows whose true label is within the top-k scores, as a
    0-D f32 tensor (it stays on the device until the metric drain)."""
    targets = targets.long()
    if topk == 1:
        correct = (scores.argmax(dim=-1) == targets).sum()
    else:
        pred = scores.topk(topk, dim=-1).indices                 # [B, k]
        correct = (pred == targets[:, None]).any(dim=-1).sum()
    return correct.float() * (100.0 / scores.shape[0])
