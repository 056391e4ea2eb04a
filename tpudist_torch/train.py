"""Train and eval steps, on one card or data-parallel.

Counterpart of ``tpudist/train.py`` (``sgd_torch``, ``lr_for_epoch``,
``compute_dtype``, ``create_train_state``, ``_loss_fn``,
``make_train_step``, ``make_eval_step``): PyTorch runs the step eagerly,
one card a rank.

- Data-parallel (``data_parallel``) is tpudist's shard_map step:
  ``DistributedDataParallel`` averages the gradients (``pmean``) in its
  bucketed all-reduce during the backward; after the optimizer step the
  BatchNorm running statistics are averaged across ranks (tpudist's
  ``pmean`` of ``batch_stats``; DDP's ``broadcast_buffers`` would instead
  copy rank 0's at every forward, so it is off); the loss and accuracy
  are averaged across ranks, in train and in eval. Every all-reduce is
  queued on the device stream: the host never waits for one.

- SGD is ``torch.optim.SGD(momentum, weight_decay, nesterov=False)`` over
  every parameter, BN scale and bias included: weight decay folded into
  the gradient before momentum, the first step's buffer is the gradient.
  That is optax's ``add_decayed_weights → trace → scale_by_learning_rate``
  exactly. The lr is set per epoch in ``param_groups``.
- AdamW is ``torch.optim.AdamW(betas=(0.9, 0.999), eps=1e-8)``:
  ``p ← p(1 − lr·wd) − lr·m̂/(√v̂ + eps)``, tpudist's ``adamw_torch``, with
  two parameter groups as its ``no_decay_mask`` draws them
  (``decays``): decay on tensors of two or more dims (matrices, convs,
  the ViT's class token and position embedding), none on biases, norm
  scales and convnext's layer scale, nor on swin's and maxvit's
  relative-position bias tables, swin v2's logit scales and everything
  under its ``cpb_mlp`` (the published recipes' groups).
- Mixed precision is the model's compute dtype: parameters stay f32 (the
  master weights), activations run in bf16 (``--use_amp``) or float16
  (``--use_amp --amp-dtype float16``), the loss is f32. No
  ``torch.autocast`` (it would move the rounding points). bf16 has f32's
  exponent range and needs no loss scaling; float16 takes tpudist's
  dynamic loss scaling (``dynamic_scale.DynamicScale``, flax's rule), the
  counterpart of the reference's ``GradScaler`` (recipe 3).
- A float16 step (``scaler`` given) keeps tpudist's order: each
  microbatch's loss is multiplied by the step's scale before its backward
  (the scale is fixed for the whole step, under ``--accum-steps`` too);
  the accumulated, reduced f32 gradients are divided by the scale (and by
  the number of microbatches); the finite flag is taken over every
  gradient after that, read on the host once a step (as ``GradScaler.step``
  reads it); on a non-finite step the optimizer does not step, so the
  parameters and the optimizer state (SGD momentum, AdamW moments and
  step) keep their values bit for bit; the scale updates once; the loss
  returned is the unscaled one. As in tpudist without the doctor, a
  skipped step still moves the BatchNorm running statistics (its forward
  ran), averages them across ranks, and updates the EMA toward the
  unchanged parameters. Under DDP the bucketed all-reduce averages the
  scaled gradients and the step unscales after it, where tpudist unscales
  before its ``pmean``: the scale is a power of two, so dividing by it
  commutes with the sum and the mean bit for bit (for a power-of-two
  world, short of f32 overflow).

- The parameter EMA (``--model-ema-decay d``, ``update_ema``) lives in a
  second module of the same arch, in eval mode without gradients: after
  each optimizer step (and the data-parallel buffer average, so every
  rank holds the same EMA) ``e = d·e + (1−d)·x`` over the parameters and
  the float BN buffers, tpudist's ``update_ema``.

- Gradient accumulation (``--accum-steps k``) is torch's: the rank's
  batch is split into k microbatches, each microbatch's loss is divided
  by k and its backward adds into the gradients, the BatchNorm statistics
  update microbatch after microbatch, the loss and accuracy are averaged,
  and one optimizer step and one EMA update follow (tpudist's
  ``accum_scan``). Under DDP every microbatch but the last runs under
  ``no_sync()``, so a step makes one gradient all-reduce; SyncBN reduces
  its statistics in every microbatch.
- Mixup/CutMix (``--mixup-alpha``, ``--cutmix-alpha``) mix the rank's
  batch once an optimizer step, before it is split: ``ops/mixup``'s
  ``draw_mix`` on the host from a generator seeded by (seed, optimizer
  step, rank), ``apply_mix`` on the device. The pair labels go with their
  microbatch.
- Dropout (vgg, googlenet, inception_v3, mobilenet) draws its masks on
  the device from a generator seeded by (seed, optimizer step, rank,
  microbatch) (``layers.dropout_seed``), where tpudist folds the step and
  the shard into its dropout key and splits it per microbatch: a resumed
  or preempted run draws what a straight run drew, the ranks draw apart,
  and each microbatch draws its own masks.
- The aux heads (googlenet with ``aux_logits``, inception_v3): a
  train-mode forward returns ``layers.AuxOutputs``, and the loss adds
  ``aux_loss_weight`` × each aux head's loss with the same mix labels,
  ``lam`` and smoothing (tpudist's ``_loss_fn``), per microbatch under
  accumulation; accuracy reads the main logits.

- The doctor's guard (``--doctor``, ``guard=True``): tpudist's
  sentinels, ``ok = isfinite(mean loss) & isfinite(gnorm)``, with
  ``gnorm`` the global L2 norm of the gradients after DDP's reduction
  (and, in float16, after the unscale), so every rank decides alike. On
  ``not ok`` the whole update is undone on the card: the parameters, the
  optimizer's state, the BN running buffers (torch moves them in the
  forward, so they are copied before it) and the EMA keep their pre-step
  values bit for bit, by ``torch.where(ok, new, old)`` per tensor (NaN
  safe, as ``jnp.where``), AdamW's ``step`` count included (on the card
  it is capturable, so it lives beside its moments). The host reads
  nothing: the metrics gain ``notfinite`` and ``gnorm`` (device scalars,
  drained one step late). In float16 an overflow is the scaler's (``ok |= ~finite``, reported as
  ``scaler_skip``), as in tpudist.

Gradient compression is not in the port yet.
"""

from __future__ import annotations

import contextlib
import inspect
import math
from typing import Callable

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from tpudist_torch import dist as dist_lib
from tpudist_torch.dynamic_scale import DynamicScale, unscale_and_check
from tpudist_torch.models.layers import dropout_seed, split_aux
from tpudist_torch.ops.loss import cross_entropy_loss
from tpudist_torch.ops.metrics import accuracy
from tpudist_torch.ops import mixup
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
    return torch.bfloat16 if cfg.amp_dtype == "bfloat16" else torch.float16


def make_scaler(cfg) -> DynamicScale | None:
    """tpudist's ``create_train_state``: a ``DynamicScale`` with flax's
    defaults when float16 is the compute dtype, else None."""
    if cfg.use_amp and cfg.amp_dtype == "float16":
        return DynamicScale()
    return None


def decays(name: str, p: torch.Tensor) -> bool:
    """tpudist's ``no_decay_mask`` for the parameter ``name``: a tensor of
    two or more dims, but no ``relative_position_bias_table``,
    ``logit_scale`` or anything under a ``cpb_mlp`` module."""
    *mods, leaf = name.split(".")
    return (p.ndim >= 2
            and leaf not in ("relative_position_bias_table", "logit_scale")
            and not any("cpb_mlp" in m for m in mods))


def make_optimizer(model: torch.nn.Module, cfg) -> torch.optim.Optimizer:
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(model.parameters(), lr=cfg.lr,
                               momentum=cfg.momentum,
                               weight_decay=cfg.weight_decay, nesterov=False)
    if cfg.optimizer == "adamw":
        named = list(model.named_parameters())
        groups = [{"params": [p for n, p in named if decays(n, p)],
                   "weight_decay": cfg.weight_decay},
                  {"params": [p for n, p in named if not decays(n, p)],
                   "weight_decay": 0.0}]
        # On the card the step count lives there too (capturable), so the
        # doctor's guard selects it as it does every other tensor.
        return torch.optim.AdamW(groups, lr=cfg.lr, betas=(0.9, 0.999),
                                 eps=1e-8,
                                 capturable=next(model.parameters()).is_cuda)
    raise ValueError(f"unsupported optimizer '{cfg.optimizer}' (sgd|adamw)")


def data_parallel(model: torch.nn.Module,
                  device: torch.device) -> DistributedDataParallel:
    """Wrap ``model`` (already on ``device``) for the process group's
    data-parallel step: the default averaging all-reduce, every parameter
    used (``find_unused_parameters=False``), no buffer broadcast (the
    step averages them after the update), and gradients that live in
    DDP's buckets (no copy back after the all-reduce)."""
    # torch 2.13 renamed broadcast_buffers to forward_sync_buffers (the
    # card's torch 2.11 has only the old name). The old name also leaves
    # the buffers out of DDP's sync at construction; that changes nothing
    # here, as every rank builds its BN buffers the same (zeros and ones).
    no_buffer_sync = ({"forward_sync_buffers": False} if "forward_sync_buffers"
                      in inspect.signature(DistributedDataParallel).parameters
                      else {"broadcast_buffers": False})
    return DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        find_unused_parameters=False, gradient_as_bucket_view=True,
        **no_buffer_sync)


def _mean_over_ranks(metrics: dict) -> dict:
    """One all-reduce for all of a step's 0-D metrics."""
    keys = list(metrics)
    vals = dist_lib.reduce_mean(torch.stack([metrics[k].float()
                                             for k in keys]))
    return dict(zip(keys, vals.unbind(0)))


def average_buffers(model: torch.nn.Module) -> None:
    """Average the floating-point buffers (the BN running statistics)
    across ranks in place, in one all-reduce."""
    bufs = [b for b in model.buffers() if b.is_floating_point()]
    if not bufs:
        return
    flat = dist_lib.reduce_mean(torch.cat([b.reshape(-1) for b in bufs]))
    torch._foreach_copy_(bufs, [v.view_as(b) for v, b in zip(
        flat.split([b.numel() for b in bufs]), bufs)])


def make_ema(model: torch.nn.Module, build: Callable[[], torch.nn.Module]
             ) -> torch.nn.Module:
    """The EMA module: ``build()`` (the same arch, and for a ViT the same
    ``flash``) on ``model``'s device, holding ``model``'s weights, in eval
    mode and without gradients."""
    ema = build().to(next(model.parameters()).device)
    ema.load_state_dict(model.state_dict())
    return ema.requires_grad_(False).eval()


@torch.no_grad()
def update_ema(ema: torch.nn.Module, model: torch.nn.Module,
               decay: float) -> None:
    """``e = d·e + (1−d)·x`` over the parameters and float buffers, in
    tpudist's association (two products, then their sum; ``lerp`` rounds
    differently)."""
    ema_t, src = ([*m.parameters(), *(b for b in m.buffers()
                                      if b.is_floating_point())]
                  for m in (ema, model))
    torch._foreach_mul_(ema_t, decay)
    torch._foreach_add_(ema_t, torch._foreach_mul(src, 1.0 - decay))


def forward_loss(model: torch.nn.Module, images: torch.Tensor,
                 labels: torch.Tensor, labels2, lam, smoothing: float,
                 aux_weight: float = 0.0):
    """tpudist's ``_loss_fn``: a train-mode forward, the (mixed, smoothed)
    f32 CE of the main logits, plus ``aux_weight`` × each aux head's with
    the same labels, in tpudist's order. Returns ``(loss, logits)``."""
    logits, aux = split_aux(model(images))
    loss = mixed_ce(logits, labels, labels2, lam, smoothing)
    for aux_logits in aux:
        loss = loss + aux_weight * mixed_ce(aux_logits, labels, labels2,
                                            lam, smoothing)
    return loss, logits


def dropout_step_seed(seed: int, step: int, rank: int,
                      microbatch: int) -> int:
    """The dropout seed of one microbatch of one optimizer step on one
    rank (a stream apart from the mixing draw's)."""
    state = np.random.SeedSequence([seed, step, rank, microbatch, 1]
                                   ).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def global_grad_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """The global L2 norm of ``grads`` (f32, on their device): tpudist's
    ``global_grad_norm``, the doctor's second sentinel."""
    if not grads:
        return torch.zeros(())
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


class _Guard:
    """The doctor's skip-step: copies of the state a step moves, and the
    select that puts them back when the step's flag is false."""

    def __init__(self, net: torch.nn.Module, optimizer, ema):
        self.optimizer = optimizer
        self.params = list(net.parameters())
        self.buffers = list(net.buffers())
        self.ema = ([] if ema is None
                    else [*ema.parameters(), *ema.buffers()])
        self._copies: dict[str, list] = {}

    def copy(self, key: str, tensors: list) -> list:
        """Copies of ``tensors`` into buffers kept across steps."""
        got = self._copies.get(key)
        if got is None or [t.shape for t in got] != [t.shape for t in
                                                      tensors]:
            got = self._copies[key] = [torch.empty_like(t) for t in tensors]
        if tensors:
            torch._foreach_copy_(got, tensors)
        return got

    @staticmethod
    def select(ok: torch.Tensor, tensors: list, olds: list) -> None:
        """``tensors`` ← ``where(ok, tensors, olds)``, NaN-safe, one
        launch a tensor."""
        with torch.no_grad():
            for t, o in zip(tensors, olds):
                torch.where(ok, t, o, out=t)

    def _state(self) -> list:
        """``(state dict, key)`` of every tensor of the optimizer state."""
        return [(st, k) for p in self.params
                for st in (self.optimizer.state.get(p),) if st
                for k, v in st.items() if torch.is_tensor(v)]

    def before_update(self):
        """Before ``optimizer.step``: the state it is about to move."""
        state = self._state()
        return (self.copy("params", self.params), state,
                self.copy("opt", [st[k] for st, k in state]))

    def after_update(self, ok: torch.Tensor, saved) -> None:
        params_old, state, opt_old = saved
        self.select(ok, self.params, params_old)
        self.select(ok, [st[k] for st, k in state], opt_old)
        now = self._state()
        if len(now) != len(state):
            # State the step created (the first step's momentum, moments
            # and count): its old value is the zero optax starts from.
            known = {(id(st), k) for st, k in state}
            fresh = [st[k] for st, k in now if (id(st), k) not in known]
            self.select(ok, fresh, [t.new_zeros(()) for t in fresh])


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    cfg, ema: torch.nn.Module | None = None,
                    draw_fn: Callable | None = None,
                    first_step: int = 0,
                    scaler: DynamicScale | None = None,
                    guard: bool = False) -> Callable:
    """``step(images, labels, lr) → {"loss", "acc1"}``:
    forward in train mode (BN statistics update the running buffers), f32
    CE loss, backward, the optimizer update, and with ``ema`` the EMA
    update; under ``--accum-steps`` over microbatches, under
    ``--mixup-alpha``/``--cutmix-alpha`` on the mixed batch. The metrics
    stay 0-D device tensors. A ``DistributedDataParallel`` model
    (``data_parallel``) takes the data-parallel step: its buffers and
    metrics are averaged across ranks.

    The mixing draw of a call is seeded by its optimizer step: the
    ``first_step``-th for the first call (a resumed run's step count), one
    more for each call after it. ``draw_fn(step, n, h, w)`` replaces the
    seeded draw (``mixup.MixDraw``).

    With ``scaler`` (float16) the step scales each microbatch's loss by
    ``scaler.scale``, unscales and checks the gradients, steps the
    optimizer only if every one is finite, and updates ``scaler`` in
    place; its metrics add ``finite`` (a host bool).

    With ``guard`` (``--doctor``) the metrics add ``notfinite`` and
    ``gnorm`` (and ``scaler_skip`` in float16), and a step whose
    sentinel trips leaves the state as it found it."""
    smoothing = float(getattr(cfg, "label_smoothing", 0.0))
    ddp = isinstance(model, DistributedDataParallel)
    net = model.module if ddp else model
    aux_weight = float(getattr(net, "aux_loss_weight", 0.0))
    decay = float(getattr(cfg, "model_ema_decay", 0.0))
    accum = max(1, int(getattr(cfg, "accum_steps", 1) or 1))
    alphas = (float(getattr(cfg, "mixup_alpha", 0.0)),
              float(getattr(cfg, "cutmix_alpha", 0.0)))
    mixing = alphas[0] > 0.0 or alphas[1] > 0.0
    seed = cfg.seed if cfg.seed is not None else 0
    rank = dist_lib.data_rank_world()[0]
    if mixing and draw_fn is None:
        def draw_fn(step_index, n, h, w):
            return mixup.draw_mix(mixup.step_generator(seed, step_index, rank),
                                  n, h, w, *alphas)
    calls = [int(first_step)]
    g = _Guard(net, optimizer, ema) if guard else None

    def step(images: torch.Tensor, labels: torch.Tensor, lr: float) -> dict:
        index = calls[0]
        calls[0] += 1
        for group in optimizer.param_groups:
            group["lr"] = lr
        labels2, lam = None, None
        if mixing:
            images, labels, labels2, lam = mixup.apply_mix(
                images, labels, draw_fn(index, *images.shape[:3]))
        model.train()
        optimizer.zero_grad(set_to_none=True)
        scale = None if scaler is None else scaler.scale
        if g is not None:
            # torch moves the running statistics in the forward.
            buffers_old = g.copy("buffers", g.buffers)
        if accum == 1:
            with dropout_seed(dropout_step_seed(seed, index, rank, 0)):
                loss, logits = forward_loss(model, images, labels, labels2,
                                            lam, smoothing, aux_weight)
            (loss if scale is None else loss * scale).backward()
            with torch.no_grad():
                acc1 = accuracy(logits, labels, topk=1)
            loss = loss.detach()
        else:
            n = images.shape[0]
            mb = n // accum
            if mb * accum != n:
                raise ValueError(f"batch {n} (as seen by this step: per "
                                 f"rank) is not divisible by "
                                 f"accum_steps={accum}")
            loss = acc1 = 0.0
            for i in range(accum):
                sl = slice(i * mb, (i + 1) * mb)
                # One gradient all-reduce a step: in the last backward.
                sync = (model.no_sync() if ddp and i < accum - 1
                        else contextlib.nullcontext())
                with sync:
                    with dropout_seed(dropout_step_seed(seed, index, rank,
                                                        i)):
                        loss_i, logits = forward_loss(
                            model, images[sl], labels[sl],
                            None if labels2 is None else labels2[sl], lam,
                            smoothing, aux_weight)
                    # float16: the step's scale on every microbatch; the
                    # sum is divided by accum with the unscale.
                    (loss_i / accum if scale is None
                     else loss_i * scale).backward()
                with torch.no_grad():
                    loss = loss + loss_i.detach()
                    acc1 = acc1 + accuracy(logits, labels[sl], topk=1)
            loss, acc1 = loss / accum, acc1 / accum
        finite = True
        if scaler is not None:
            with torch.no_grad():
                finite = unscale_and_check(
                    [p.grad for p in net.parameters() if p.grad is not None],
                    scale, accum)
            scaler.update(finite)
        if g is not None:
            with torch.no_grad():
                gnorm = global_grad_norm([p.grad for p in net.parameters()
                                          if p.grad is not None])
            saved = g.before_update() if finite else None
        if finite:
            optimizer.step()
        with torch.no_grad():
            metrics = {"loss": loss, "acc1": acc1}
            if ddp:
                average_buffers(net)
                metrics = _mean_over_ranks(metrics)
            if g is not None and finite:
                # The reduced loss and gradients: every rank decides alike.
                ok = torch.isfinite(metrics["loss"]) & torch.isfinite(gnorm)
                g.after_update(ok, saved)
                g.select(ok, g.buffers, buffers_old)
                ema_old = (g.copy("ema", g.ema) if ema is not None
                           else None)
            if ema is not None:
                update_ema(ema, net, decay)
            if g is not None:
                if finite:
                    if ema is not None:
                        g.select(ok, g.ema, ema_old)
                    metrics["notfinite"] = (~ok).float()
                else:
                    # A float16 overflow is the scaler's skip, not the
                    # doctor's (tpudist: ok |= ~finite).
                    metrics["notfinite"] = torch.zeros((), device=loss.device)
                metrics["gnorm"] = gnorm
                if scaler is not None:
                    metrics["scaler_skip"] = 0.0 if finite else 1.0
        if scaler is not None:
            metrics["finite"] = finite
        return metrics

    return step


def make_eval_step(model: torch.nn.Module, cfg,
                   over_ranks: bool | None = None) -> Callable:
    """``step(images, labels) → {"loss", "acc1"}`` with the running BN
    statistics and no gradient; under DDP (or ``over_ranks``, for the EMA
    module beside a DDP model) the metrics are averaged across ranks."""
    ddp = isinstance(model, DistributedDataParallel)
    net = model.module if ddp else model
    ddp = ddp if over_ranks is None else over_ranks

    def step(images: torch.Tensor, labels: torch.Tensor) -> dict:
        net.eval()
        with torch.no_grad():
            logits = net(images)
            metrics = {"loss": cross_entropy_loss(logits, labels),
                       "acc1": accuracy(logits, labels, topk=1)}
            return _mean_over_ranks(metrics) if ddp else metrics

    return step
