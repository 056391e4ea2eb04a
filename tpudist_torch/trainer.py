"""The experiment runner and epoch loops on one card.

Counterpart of ``tpudist/trainer.py`` (``Trainer``: ``train_epoch``,
``validate``, ``fit``; ``run``) for one CUDA card, or the CPU when asked.
It keeps tpudist's observable surface: ``experiment.log`` and stdout
lines (``Epoch[e]:\\t[i/N]``, ``||==> Train``/``Val``, ``best_acc1=``),
``settings.log``, and with ``--telemetry`` the ``run_start``/``step``/
``eval``/``epoch``/``run_end`` events ``python -m tpudist.summarize`` reads.

The hot loop keeps tpudist's two overlaps:
- ``--async_drain``: each step's loss and accuracy are copied to pinned
  host memory behind the step and read one step late, so reading them
  never waits for the step just launched;
- ``--device_prefetch``: the next batch's pinned, ``non_blocking``
  host-to-device copy is staged while the current step runs.

It logs which attention a ViT takes and which epilogue the BN workloads
take, as ``_resolve_attention_dispatch`` and
``_resolve_fused_norm_dispatch`` do, and on the card the kernel launches
its first train step made. Checkpoints, the data-parallel
plane, the doctor, fault injection and the profiler window come later;
``fit`` says once that it writes no checkpoint.
"""

from __future__ import annotations

import time

import torch

from tpudist_torch import telemetry as telemetry_lib
from tpudist_torch._device import resolve_device
from tpudist_torch.config import (VIT_ARCHS, Config, refuse_unsupported,
                                  write_settings)
from tpudist_torch.data import DevicePrefetcher, build_train_val_loaders
from tpudist_torch.data.loader import to_device
from tpudist_torch.models import create_model
from tpudist_torch.ops import flash_attention, fused_norm
from tpudist_torch.train import (compute_dtype, lr_for_epoch, make_eval_step,
                                 make_optimizer, make_train_step)
from tpudist_torch.utils import (AverageMeter, ProgressMeter, get_logger,
                                 output_process)


class _MetricDrain:
    """Defers the device→host metric read: meters update in bulk when
    displayed, averages stay exact. With ``lag`` > 0 each push copies the
    step's metrics into pinned host memory behind the step (an event marks
    the copy), and ``drain_ready`` reads only entries at least ``lag``
    steps old, whose copies have landed."""

    def __init__(self, meters: dict[str, AverageMeter], lag: int = 0):
        self.meters = meters
        self.lag = max(0, int(lag))
        self.pending: list = []

    def push(self, metrics: dict, n: int) -> None:
        vals = torch.stack([metrics[k].float() for k in self.meters])
        event = None
        if self.lag and vals.is_cuda:
            host = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
            host.copy_(vals, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            vals = host
        self.pending.append((vals, event, n))

    def _apply(self, entries) -> None:
        for vals, event, n in entries:
            if event is not None:
                event.synchronize()
            for meter, v in zip(self.meters.values(), vals.tolist()):
                meter.update(v, n)

    def drain_ready(self) -> None:
        keep = len(self.pending) - self.lag
        if keep > 0:
            self._apply(self.pending[:keep])
            del self.pending[:keep]

    def drain(self) -> None:
        self._apply(self.pending)
        self.pending.clear()


class Trainer:
    """Build everything, then ``fit``."""

    def __init__(self, cfg: Config):
        refuse_unsupported(cfg)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        cfg.finalize(1)
        output_process(cfg.outpath, cfg.overwrite)
        self.logger = get_logger(cfg.outpath)
        write_settings(cfg, cfg.outpath)
        on_gpu = self.device.type == "cuda"
        self.telemetry = None
        if cfg.telemetry:
            self.telemetry = telemetry_lib.Telemetry(cfg.outpath, rank=0)
            self.telemetry.emit(
                "run_start", platform="gpu" if on_gpu else "cpu",
                n_devices=1, device_kind=(torch.cuda.get_device_name(
                    self.device) if on_gpu else "cpu"),
                arch=cfg.arch, global_batch=cfg.batch_size, init_s=0.0)
            self.log("=> telemetry: per-step MFU is not reported by the "
                     "port yet")
        dtype = compute_dtype(cfg)
        if on_gpu and dtype == torch.float32:
            # f32 means f32: no TF32 convolutions or matmuls.
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        seed = cfg.seed if cfg.seed is not None else 0
        self.is_vit = cfg.arch in VIT_ARCHS
        kw = dict(num_classes=cfg.num_classes, dtype=dtype)
        if self.is_vit:
            kw.update(image_size=cfg.image_size, flash=cfg.flash == "on")
        else:
            kw["fused_bn"] = cfg.fused_bn == "on"
        self.model = create_model(cfg.arch, **kw)
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        self.log(f"=> creating model '{cfg.arch}'")
        if on_gpu:
            self._build_kernels()
        self.attention_decision = (self._resolve_attention_dispatch()
                                   if self.is_vit else None)
        self.fused_norm_decision = self._resolve_fused_norm_dispatch()
        self.optimizer = make_optimizer(self.model, cfg)
        self.train_step = make_train_step(self.model, self.optimizer, cfg)
        self.eval_step = make_eval_step(self.model, cfg)
        self.best_acc1 = 0.0
        self.start_epoch = cfg.start_epoch
        self.global_step = 0
        self._train_dispatched = False

    def _build_kernels(self) -> None:
        """Compile the kernel sources this run launches (one ``nvcc`` each,
        in parallel) before the first step; the time is a
        ``kernel_build`` compile event."""
        cfg = self.cfg
        names = []
        if self.is_vit and cfg.flash == "on":
            names += ["flash_fwd"] + ([] if cfg.evaluate else ["flash_bwd"])
        if not self.is_vit and cfg.fused_bn == "on" and not cfg.evaluate:
            names.append("fused_norm")
        if not names:
            return
        from tpudist_torch.ops import _build
        t0 = time.time()
        _build.build_all(names)
        for name in names:
            _build.load(name)
        if self.telemetry is not None:
            self.telemetry.note_compile(time.time() - t0,
                                        phase="kernel_build")

    def _resolve_attention_dispatch(self) -> dict:
        """Which attention a ViT's blocks take: the flash ``Function``
        under ``--flash on`` (the CUDA kernels on the card, their plain
        versions on the CPU), plain attention under ``off``. Logged in
        tpudist's format and emitted as an ``attention_dispatch`` event."""
        cfg = self.cfg
        dec = {"kernel": "flash" if cfg.flash == "on" else "plain",
               "mode": cfg.flash, "source": "forced"}
        if cfg.flash == "on" and self.device.type != "cuda":
            dec["reason"] = "the CPU runs each kernel's plain body"
        msg = (f"=> attention dispatch: {dec['kernel']} attention (mode "
               f"{dec['mode']}, {dec['source']}")
        if dec.get("reason"):
            msg += f": {dec['reason']}"
        self.log(msg + ")")
        if self.telemetry is not None:
            self.telemetry.emit("attention_dispatch", **dec)
        return dec

    def _resolve_fused_norm_dispatch(self) -> dict:
        """Which epilogue the train-mode BN+ReLU sites take: the fused
        ``Function``s under ``--fused-bn on`` (the CUDA kernels on the
        card, their plain bodies on the CPU), the plain epilogue under
        ``off`` and in eval mode. Logged as one line and emitted as a
        ``fused_norm_dispatch`` event; ``_log_first_step_launches`` then
        reports what the card ran."""
        cfg = self.cfg
        agg = {"kernel": "plain", "mode": cfg.fused_bn, "source": "forced"}
        if self.is_vit:
            agg.update(source="ineligible",
                       reason=f"{cfg.arch} has no BatchNorm")
        elif cfg.evaluate:
            agg.update(source="ineligible",
                       reason="eval mode runs the plain epilogue")
        elif cfg.fused_bn == "on":
            if self.device.type == "cuda":
                agg["kernel"] = "cuda"
            else:
                agg["reason"] = "the CPU runs each kernel's plain body"
        msg = (f"=> fused-norm dispatch: {agg['kernel']} epilogue (mode "
               f"{agg['mode']}, {agg['source']}")
        if agg.get("reason"):
            msg += f"; {agg['reason']}"
        self.log(msg + ")")
        if self.telemetry is not None:
            self.telemetry.emit("fused_norm_dispatch", **agg)
        return agg

    def _first_step_kernels(self):
        """``(label, ops module)`` of the kernels a train step launches on
        the card, or None where it launches none."""
        if self.device.type != "cuda":
            return None
        if self.is_vit:
            return (("flash", flash_attention)
                    if self.attention_decision["kernel"] == "flash" else None)
        return (("fused-norm", fused_norm)
                if self.fused_norm_decision["kernel"] == "cuda" else None)

    def _log_first_step_launches(self, label: str, ops,
                                 before: dict) -> None:
        launched = {k: ops.LAUNCHES[k] - before[k] for k in ops.KERNELS}
        self.log(f"=> {label} kernels launched by the first train step: "
                 f"{sum(launched.values())} ("
                 + ", ".join(f"{k} {v}" for k, v in launched.items()) + ")")

    def log(self, msg: str) -> None:
        self.logger.info(msg)

    def train_epoch(self, loader, epoch: int, lr: float):
        cfg = self.cfg
        batch_time = AverageMeter("Time", ":6.3f")
        data_time = AverageMeter("Data", ":6.3f")
        losses = AverageMeter("Loss", ":.4e")
        top1 = AverageMeter("Acc@1", ":6.2f")
        progress = ProgressMeter(len(loader),
                                 [batch_time, data_time, losses, top1],
                                 prefix=f"Epoch[{epoch}]:\t")
        async_drain = bool(cfg.async_drain)
        drain = _MetricDrain({"loss": losses, "acc1": top1},
                             lag=1 if async_drain else 0)
        pf = DevicePrefetcher(loader, self.device) if cfg.device_prefetch \
            else None
        tel = self.telemetry
        end = t_prev = time.time()
        for i, (images, labels) in enumerate(pf if pf is not None
                                             else loader):
            now = time.time()
            data_time.update(now - end)
            data_s = now - t_prev
            t_h = time.time()
            if pf is None:
                images, labels = to_device(images, labels, self.device)
            first_dispatch = not self._train_dispatched
            self._train_dispatched = True
            counted = self._first_step_kernels() if first_dispatch else None
            launches = dict(counted[1].LAUNCHES) if counted else None
            t_c = time.time()
            metrics = self.train_step(images, labels, lr)
            t_done = time.time()
            h2d_s, compute_s = t_c - t_h, t_done - t_c
            if counted:
                self._log_first_step_launches(*counted, launches)
            prefetch_s = pf.poke() if pf is not None else None
            drain.push(metrics, n=int(images.shape[0]))
            drain_ovl_s = None
            if async_drain:
                t_do = time.time()
                drain.drain_ready()
                drain_ovl_s = time.time() - t_do
            step_num = self.global_step
            self.global_step += 1
            batch_time.update(time.time() - end)
            end = time.time()
            drain_s = 0.0
            if i % cfg.print_freq == 0:
                t_d = time.time()
                drain.drain_ready() if async_drain else drain.drain()
                drain_s = time.time() - t_d
                self.log(progress.display(i))
            if tel is not None:
                tel.step(step=step_num, epoch=epoch, data_s=data_s,
                         h2d_s=h2d_s, compute_s=compute_s, drain_s=drain_s,
                         step_s=time.time() - t_prev,
                         compile_s=compute_s if first_dispatch else 0.0,
                         prefetch_s=prefetch_s, drain_ovl_s=drain_ovl_s)
            t_prev = time.time()
        drain.drain()
        self.log(f"||==> Train: Epoch[{epoch}]\tLoss {losses.avg:.4e}\t"
                 f"Acc@1 {top1.avg:6.2f}")
        return losses.avg, top1.avg

    def validate(self, loader, epoch: int) -> float:
        batch_time = AverageMeter("Time", ":6.3f")
        losses = AverageMeter("Loss", ":.4e")
        top1 = AverageMeter("Acc@1", ":6.2f")
        progress = ProgressMeter(len(loader), [batch_time, losses, top1],
                                 prefix="Val:\t")
        drain = _MetricDrain({"loss": losses, "acc1": top1})
        end = time.time()
        for i, (images, labels) in enumerate(loader):
            images, labels = to_device(images, labels, self.device)
            drain.push(self.eval_step(images, labels), n=int(images.shape[0]))
            batch_time.update(time.time() - end)
            end = time.time()
            if i % self.cfg.print_freq == 0:
                drain.drain()
                self.log(progress.display(i))
        drain.drain()
        self.log(f"||==> Val: Epoch[{epoch}]\tLoss {losses.avg:.4e}\t"
                 f"Acc@1 {top1.avg:6.2f}")
        return top1.avg

    def _peak_memory_gb(self) -> float | None:
        if self.device.type != "cuda":
            return None
        return torch.cuda.max_memory_allocated(self.device) / 1e9

    def fit(self, train_loader=None, val_loader=None) -> float:
        cfg = self.cfg
        if train_loader is None or val_loader is None:
            train_loader, val_loader = build_train_val_loaders(cfg)
        try:
            if cfg.evaluate:
                return self.validate(val_loader, epoch=-1)
            self.log("=> no checkpoint is written: the port has no "
                     "checkpoint format yet (checkpoint.py is queued)")
            total_time = 0.0
            for epoch in range(self.start_epoch, cfg.epochs):
                t0 = time.time()
                train_loader.set_epoch(epoch)
                lr = lr_for_epoch(cfg, epoch)
                self.log(f"self.optimizer={{'lr': {lr}}}")
                self.train_epoch(train_loader, epoch, lr)
                t_v = time.time()
                acc1 = self.validate(val_loader, epoch)
                if self.telemetry is not None:
                    self.telemetry.note_eval(time.time() - t_v, epoch=epoch,
                                             acc1=float(acc1))
                if acc1 > self.best_acc1:
                    self.best_acc1 = float(acc1)
                    self.log(f"best_acc1={self.best_acc1:.3f}, "
                             f"epoch={epoch}")
                epoch_time = time.time() - t0
                total_time += epoch_time
                peak = self._peak_memory_gb()
                self.log(f"||==> Epoch[{epoch}] time cost {epoch_time:.2f}s, "
                         f"total {total_time:.2f}s"
                         + (f", peak_hbm {peak:.3f}GB" if peak else ""))
                if self.telemetry is not None:
                    self.telemetry.emit(
                        "epoch", epoch=epoch, seconds=round(epoch_time, 3),
                        **({"peak_hbm_gb": peak} if peak else {}))
            return self.best_acc1
        finally:
            if self.telemetry is not None:
                self.telemetry.close(best_acc1=float(self.best_acc1))


def run(cfg: Config) -> float:
    return Trainer(cfg).fit()
