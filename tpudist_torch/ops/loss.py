"""Losses: counterpart of ``tpudist/ops/loss.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels (``nn.CrossEntropyLoss``
    semantics), computed in f32 whatever the compute dtype."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    n_classes = logits.shape[-1]
    targets = targets.long()
    if label_smoothing > 0.0:
        onehot = F.one_hot(targets, n_classes).float()
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / n_classes
        nll = -(onehot * log_probs).sum(dim=-1)
    else:
        nll = -log_probs.gather(-1, targets[:, None])[:, 0]
    return nll.mean()
