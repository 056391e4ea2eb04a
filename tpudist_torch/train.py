"""One-card train and eval steps.

Counterpart of ``tpudist/train.py`` (``sgd_torch``, ``lr_for_epoch``,
``compute_dtype``, ``create_train_state``, ``_loss_fn``,
``make_train_step``, ``make_eval_step``) without the mesh: PyTorch runs
the step eagerly on one card.

- SGD is ``torch.optim.SGD(momentum, weight_decay, nesterov=False)`` over
  every parameter, BN scale and bias included: weight decay folded into
  the gradient before momentum, the first step's buffer is the gradient.
  That is optax's ``add_decayed_weights → trace → scale_by_learning_rate``
  exactly. The lr is set per epoch in ``param_groups``.
- AdamW is ``torch.optim.AdamW(betas=(0.9, 0.999), eps=1e-8)``:
  ``p ← p(1 − lr·wd) − lr·m̂/(√v̂ + eps)``, tpudist's ``adamw_torch``, with
  two parameter groups as its ``no_decay_mask`` draws them: decay on
  tensors of two or more dims (matrices, convs, the ViT's class token and
  position embedding), none on biases and norm scales.
- Mixed precision is the model's compute dtype: parameters stay f32 (the
  master weights), activations run in bf16 under ``--use_amp``, the loss
  is f32. No ``torch.autocast`` (it would move the rounding points) and no
  loss scaling (bf16 has f32's exponent range).

Accumulation, EMA, fp16 loss scaling, the doctor guard and gradient
compression are not in the port yet.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from tpudist_torch.ops.loss import cross_entropy_loss
from tpudist_torch.ops.metrics import accuracy
from tpudist_torch.ops.mixup import mixed_ce


def lr_for_epoch(cfg, epoch: int) -> float:
    """MultiStepLR with the step at epoch start, lr(e) = lr0 ·
    gamma^(#milestones <= e), or cosine; a linear warmup multiplies it."""
    warm = getattr(cfg, "warmup_epochs", 0)
    ramp = (epoch + 1) / warm if (warm and epoch < warm) else 1.0
    if cfg.lr_scheduler == "steplr":
        factor = cfg.gamma ** sum(1 for m in cfg.step if epoch >= m)
        return cfg.lr * factor * ramp
    if cfg.lr_scheduler == "cosine":
        t = max(epoch - warm, 0) / max(cfg.epochs - warm, 1)
        return 0.5 * cfg.lr * (1 + math.cos(math.pi * t)) * ramp
    raise AssertionError(f"unsupported lr scheduler: {cfg.lr_scheduler}")


def compute_dtype(cfg) -> torch.dtype:
    if not cfg.use_amp:
        return torch.float32
    if cfg.amp_dtype != "bfloat16":
        raise NotImplementedError(
            f"--amp-dtype {cfg.amp_dtype}: float16 loss scaling is not in "
            f"the port yet")
    return torch.bfloat16


def make_optimizer(model: torch.nn.Module, cfg) -> torch.optim.Optimizer:
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(model.parameters(), lr=cfg.lr,
                               momentum=cfg.momentum,
                               weight_decay=cfg.weight_decay, nesterov=False)
    if cfg.optimizer == "adamw":
        params = list(model.parameters())
        groups = [{"params": [p for p in params if p.ndim >= 2],
                   "weight_decay": cfg.weight_decay},
                  {"params": [p for p in params if p.ndim < 2],
                   "weight_decay": 0.0}]
        return torch.optim.AdamW(groups, lr=cfg.lr, betas=(0.9, 0.999),
                                 eps=1e-8)
    raise ValueError(f"unsupported optimizer '{cfg.optimizer}' (sgd|adamw)")


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    cfg) -> Callable:
    """``step(images, labels, lr) → {"loss", "acc1"}``: forward in train
    mode (BN statistics update the running buffers), f32 CE loss,
    backward, SGD update. The metrics stay 0-D device tensors."""
    smoothing = float(getattr(cfg, "label_smoothing", 0.0))

    def step(images: torch.Tensor, labels: torch.Tensor, lr: float) -> dict:
        for group in optimizer.param_groups:
            group["lr"] = lr
        model.train()
        logits = model(images)
        loss = mixed_ce(logits, labels, None, None, smoothing)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            acc1 = accuracy(logits, labels, topk=1)
        return {"loss": loss.detach(), "acc1": acc1}

    return step


def make_eval_step(model: torch.nn.Module, cfg) -> Callable:
    """``step(images, labels) → {"loss", "acc1"}`` with the running BN
    statistics and no gradient."""

    def step(images: torch.Tensor, labels: torch.Tensor) -> dict:
        model.eval()
        with torch.no_grad():
            logits = model(images)
            return {"loss": cross_entropy_loss(logits, labels),
                    "acc1": accuracy(logits, labels, topk=1)}

    return step
