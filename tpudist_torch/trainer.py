"""The experiment runner and epoch loops, on one card or data-parallel.

Counterpart of ``tpudist/trainer.py`` (``Trainer``: ``train_epoch``,
``validate``, ``fit``; ``run``) on CUDA cards, or the CPU when asked.
It keeps tpudist's observable surface: ``experiment.log`` and stdout
lines (``Epoch[e]:\\t[i/N]``, ``||==> Train``/``Val``, ``best_acc1=``),
``settings.log``, and with ``--telemetry`` the ``run_start``/``step``/
``eval``/``epoch``/``run_end`` events ``python -m tpudist.summarize`` reads.

Under ``--distributed`` (``run`` joins the process group first) each rank
trains its shard of every global batch under DDP (``train.data_parallel``):
the primary rank alone sets up the run directory and writes the logs and
``settings.log``, the others wait for it at a barrier; every rank writes
its own ``events.<rank>.jsonl``.

The hot loop keeps tpudist's two overlaps:
- ``--async_drain``: each step's loss and accuracy are copied to pinned
  host memory behind the step and read one step late, so reading them
  never waits for the step just launched;
- ``--device_prefetch``: the next batch's pinned, ``non_blocking``
  host-to-device copy is staged while the current step runs.

Before the first step it resolves ``--flash`` and ``--fused-bn`` as
tpudist's ``_resolve_flash_dispatch`` and ``_resolve_fused_norm_dispatch``
do, through the measurement dispatch (``ops/attention_dispatch``,
``ops/norm_dispatch``): the attention workload and every BN epilogue
workload (recorded by one forward at the rows a step runs, the
microbatch under ``--accum-steps``) are decided once, and the verdicts
are set on the modules, so a forward looks nothing up. Under
``--distributed`` rank 0 decides and the others adopt its verdicts. A
probe that fails to build or launch a kernel fails the run, naming the
workload. The trainer logs tpudist's dispatch lines, each workload's
timings, and on the card the kernel launches its first train step made.

Checkpoints are tpudist's (``checkpoint.py``): after each epoch's
validation the primary rank writes ``checkpoint.msgpack`` (with the
history copies and ``model_best.msgpack``), a ``checkpoint_save`` event
on every rank. ``--resume PATH`` (a file or a run dir) loads on every
rank before the first step: an explicit file is verified and never
substituted; the run's own outpath, and ``--resume auto``, walk
``load_checkpoint_with_fallback``. So ``python -m tpudist_torch.launch
--max-restarts K`` with ``--resume auto --overwrite keep`` continues from
the last completed epoch. With ``--model-ema-decay`` the EMA module is
what validation (and so ``best``) measures.

With ``--data DIR`` it logs the path each split's images take
(``=> data path: ...``) and, after an epoch in which the loader skipped
or retried a sample, tpudist's ``||==> Data:`` line; the ``epoch`` event
then carries ``samples_skipped`` and ``samples_retried``.

Preemption, as tpudist drains it: ``fit`` turns SIGTERM/SIGINT into a
flag (``_PreemptionGuard``; a second signal kills as usual) that is read
at each step boundary and each validation batch; under
``--distributed`` the ranks agree on it there (``dist.any_rank``), so
every rank stops after the same step. The primary rank then writes an
emergency checkpoint (``save_emergency``: the live file only, stamped
``epoch - 1``, with the epoch's global sample cursor), a ``preempt``
event and a ``checkpoint_save`` event of kind ``emergency`` are emitted,
and the process exits 75 (``faults.PREEMPTED_EXIT_CODE``), which the
launcher calls resumable. A resume from that file re-enters the epoch at
its cursor: the loader skips the consumed positions of the epoch's
global order, so the rest of the epoch sees tpudist's batches.

``--inject`` (or ``TPUDIST_INJECT``) arms ``faults``: ``rank_exit``,
``slow_peer`` and ``straggle`` at the step boundary, ``decode_fail`` in
the loader, ``checkpoint_corrupt`` after a save; each firing is a
``fault`` event.

Observability, as tpudist's: ``--telemetry-max-mb`` caps each event file
(``events.<rank>.1.jsonl`` holds the rollover); ``--metrics-port`` (with
``--telemetry``) serves the rank's Prometheus endpoint (``obs/server.py``,
a telemetry sink registered before ``run_start``; a lost bind falls back
to an ephemeral port; the bound port is in ``metrics.<rank>.port``);
``--profile start:end`` captures the global step window with
``torch.profiler`` (``utils/profiling.py``), each step a ``train`` range
beside ``tpudist.data_wait``, ``tpudist.h2d`` and
``tpudist.metric_drain``.
``--resume x.pth.tar`` imports the reference's file (its weights, epoch
and best_acc1), ``--pretrained`` starts from torchvision's weights on
disk, and ``--torch_checkpoints`` also writes ``checkpoint.pth.tar`` and
``model_best.pth.tar`` (``compat/``).

The fault planes, as tpudist's trainer wires them:
- ``--doctor`` (``doctor/``): the guarded step (``train.make_train_step(
  guard=True)``); its flags reach ``Doctor.on_metrics`` through the
  metric drain one step late (a skipped step stays out of the meters and
  of the optimizer count). At each step boundary the doctor may raise
  ``RollbackRequested`` (``fit`` restores the newest probe-verified-good
  checkpoint, or the seeded initial state, and replays the epoch minus
  the poisoned window; ``global_step`` keeps counting dispatches while
  the checkpoint's step rolls back) and, every ``--doctor-probe-freq``
  steps, probes the replicated state (a rank minority-divergent too
  often exits 76). The fault points ``nanbomb``, ``lossbomb`` and
  ``bitflip`` fire at the boundary.
- ``--stall-timeout`` (``utils/watchdog.py``): kicked before each
  dispatch, after it, at the probe, at each validation batch and around
  the replica check and the save; started by ``fit``, after the kernels
  were built and the dispatch probed, so a cold build never counts.
- ``--replica-check-freq N``: every N epochs every rank's parameters and
  BN buffers are held against rank 0's (``utils/debug.py``).
- ``--blackbox`` (``blackbox.py``): the flight recorder as a telemetry
  sink, SIGUSR2 and ``POST /capture`` on the metrics endpoint; its deep
  capture is polled at each step boundary.
"""

from __future__ import annotations

import os
import shutil
import signal
import time
from typing import Any, Optional

import torch
from torch.profiler import record_function

from tpudist_torch import checkpoint as ckpt_lib
from tpudist_torch import dist as dist_lib
from tpudist_torch import faults
from tpudist_torch import telemetry as telemetry_lib
from tpudist_torch._device import resolve_device
from tpudist_torch.compat import pretrained as pretrained_lib
from tpudist_torch.compat import torch_checkpoint as torch_ckpt
from tpudist_torch.config import (VIT_ARCHS, Config, refuse_unsupported,
                                  write_settings)
from tpudist_torch.data import DevicePrefetcher, build_train_val_loaders
from tpudist_torch.data.loader import to_device
from tpudist_torch.doctor import Doctor, RollbackRequested, probes
from tpudist_torch.models import create_model
from tpudist_torch.models.layers import BatchNorm
from tpudist_torch.ops import (attention_dispatch, dispatch, flash_attention,
                               fused_norm, norm_dispatch)
from tpudist_torch.train import (compute_dtype, data_parallel, lr_for_epoch,
                                 make_ema, make_eval_step, make_optimizer,
                                 make_scaler, make_train_step)
from tpudist_torch.utils import (AverageMeter, ProgressMeter, get_logger,
                                 output_process)
from tpudist_torch.utils.debug import (assert_replicas_consistent,
                                       replica_leaves)
from tpudist_torch.utils.profiling import StepProfiler
from tpudist_torch.utils.watchdog import Watchdog


class _MetricDrain:
    """Defers the device→host metric read: meters update in bulk when
    displayed, averages stay exact. With ``lag`` > 0 each push copies the
    step's metrics into pinned host memory behind the step (an event marks
    the copy), and ``drain_ready`` reads only entries at least ``lag``
    steps old, whose copies have landed.

    ``observer(step, values)`` (the doctor's feed) sees every drained
    entry as host floats, the guard's flags among them; an entry flagged
    ``notfinite`` stays out of the meters (its update was undone)."""

    def __init__(self, meters: dict[str, AverageMeter], lag: int = 0,
                 observer=None):
        self.meters = meters
        self.lag = max(0, int(lag))
        self.observer = observer
        self.pending: list = []

    def push(self, metrics: dict, n: int, step: Optional[int] = None
             ) -> None:
        keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
        host_vals = {k: float(v) for k, v in metrics.items()
                     if not torch.is_tensor(v)}
        vals = torch.stack([metrics[k].float() for k in keys])
        event = None
        if self.lag and vals.is_cuda:
            host = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
            host.copy_(vals, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            vals = host
        self.pending.append((keys, vals, host_vals, event, n, step))

    def _apply(self, entries) -> None:
        for keys, vals, host_vals, event, n, step in entries:
            if event is not None:
                event.synchronize()
            got = dict(zip(keys, vals.tolist()), **host_vals)
            if got.get("notfinite", 0.0) < 0.5:
                for k, meter in self.meters.items():
                    meter.update(got[k], n)
            if self.observer is not None:
                self.observer(step, got)

    def drain_ready(self) -> None:
        keep = len(self.pending) - self.lag
        if keep > 0:
            self._apply(self.pending[:keep])
            del self.pending[:keep]

    def drain(self) -> None:
        self._apply(self.pending)
        self.pending.clear()


class PreemptionRequested(Exception):
    """Raised at the step boundary after SIGTERM/SIGINT: ``fit`` writes
    the emergency checkpoint and exits ``faults.PREEMPTED_EXIT_CODE``."""


class _PreemptionGuard:
    """SIGTERM/SIGINT → a flag the loops read at their boundaries,
    instead of dying mid-step. A second signal restores the previous
    handling and re-raises it, so a trainer wedged in its drain can still
    be killed."""

    def __init__(self):
        self.requested: Optional[int] = None
        self._prev: dict[int, Any] = {}

    def _handler(self, signum, frame):
        if self.requested is not None:
            self.uninstall()
            signal.raise_signal(signum)
            return
        self.requested = signum

    def install(self) -> "_PreemptionGuard":
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:
                pass                # not the main thread: nothing to catch
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev.clear()

    def check(self) -> None:
        if self.requested is not None:
            raise PreemptionRequested(signal.Signals(self.requested).name)


class Trainer:
    """Build everything, then ``fit``."""

    def __init__(self, cfg: Config, init_s: float = 0.0):
        """``init_s``: the seconds ``dist.initialize_runtime`` took (the
        telemetry's init phase)."""
        self.cfg = cfg
        # Armed before anything can fail: --inject, else TPUDIST_INJECT.
        faults.configure(cfg.inject or None)
        self.device = resolve_device(cfg.device)
        self.rank, self.world = dist_lib.data_rank_world()
        self.primary = self.rank == 0
        self.distributed = dist_lib.is_initialized()
        cfg.finalize(self.world)
        self.logger = None
        if self.primary:
            output_process(cfg.outpath, cfg.overwrite)
            self.logger = get_logger(cfg.outpath)
            write_settings(cfg, cfg.outpath)
        # The others open their event files only once rank 0's
        # --overwrite handling is done with the directory.
        dist_lib.barrier("outpath")
        on_gpu = self.device.type == "cuda"
        self.telemetry = None
        self.metrics_server = None
        self.blackbox = None
        # Made by fit() when --stall-timeout > 0.
        self.watchdog: Optional[Watchdog] = None
        if cfg.telemetry:
            self.telemetry = telemetry_lib.Telemetry(
                cfg.outpath, rank=self.rank, init_s=init_s,
                max_mb=cfg.telemetry_max_mb)
            telemetry_lib.set_current(self.telemetry)
            faults.set_observer(self._on_fault)
            if cfg.metrics_port >= 0:
                self._start_metrics_server()
            if cfg.blackbox:
                self._arm_blackbox(on_gpu)
            self.telemetry.emit(
                "run_start", platform="gpu" if on_gpu else "cpu",
                n_devices=self.world, device_kind=(torch.cuda.get_device_name(
                    self.device) if on_gpu else "cpu"),
                arch=cfg.arch, global_batch=cfg.batch_size,
                init_s=round(init_s, 3),
                **({"backend": dist_lib.backend()} if self.distributed
                   else {}))
            self.log("=> telemetry: per-step MFU is not reported by the "
                     "port yet")
        dtype = compute_dtype(cfg)
        if on_gpu and dtype == torch.float32:
            # f32 means f32: no TF32 convolutions or matmuls.
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        seed = cfg.seed if cfg.seed is not None else 0
        # As tpudist's trainer: the class count and dtype; a ViT its image
        # size (flax infers it) and --flash, a conv net --sync_batchnorm;
        # aux_logits stays each model's default (googlenet off,
        # inception_v3 on).
        kw = dict(num_classes=cfg.num_classes, dtype=dtype)
        if cfg.arch in VIT_ARCHS:
            kw.update(image_size=cfg.image_size, flash=cfg.flash == "on")
        else:
            kw.update(sync_batchnorm=cfg.sync_batchnorm)
        self.model = create_model(cfg.arch, **kw)
        # What the model has decides the dispatch: attention (the flash
        # kernels) or BatchNorm sites (the fused-norm kernels).
        self.has_attention = hasattr(self.model, "set_flash")
        self.has_bn = any(isinstance(m, BatchNorm)
                          for m in self.model.modules())
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        if cfg.pretrained:
            path = pretrained_lib.resolve_pretrained_path(
                cfg.arch, cfg.pretrained_path)
            pretrained_lib.load_pretrained(self.model, cfg.arch, path)
            self.log(f"=> using pre-trained model '{cfg.arch}' (from "
                     f"{path})")
        else:
            self.log(f"=> creating model '{cfg.arch}'")
        self.ema = (make_ema(self.model, lambda: create_model(cfg.arch, **kw))
                    if cfg.model_ema_decay > 0 else None)
        if on_gpu:
            self._build_kernels()
        before = {**fused_norm.LAUNCHES, **flash_attention.LAUNCHES}
        self.attention_decision = (self._resolve_attention_dispatch()
                                   if self.has_attention else None)
        self.fused_norm_decision = self._resolve_fused_norm_dispatch()
        probed = {k: v - before[k] for k, v in {
            **fused_norm.LAUNCHES, **flash_attention.LAUNCHES}.items()
            if v != before[k]}
        if probed:
            self.log(f"=> dispatch probes launched "
                     f"{sum(probed.values())} kernels ("
                     + ", ".join(f"{k} {v}" for k, v in probed.items())
                     + ")")
        self._model_kw = kw
        self.optimizer = make_optimizer(self.model, cfg)
        # --amp-dtype float16: tpudist's DynamicScale, in the state a
        # checkpoint carries; None otherwise.
        self.scaler = make_scaler(cfg)
        # Optimizer updates that landed (a float16 run skips overflows,
        # the doctor its non-finite steps).
        self.opt_steps = 0
        self.best_acc1 = 0.0
        self.start_epoch = cfg.start_epoch
        # Dispatches of this process's run (monotonic across a doctor
        # rollback: profiler windows, probes and fault gates key on it)
        # and the train state's step (the checkpoint's; it rolls back with
        # the weights and seeds the step's mixing and dropout draws).
        self.global_step = 0
        self.state_step = 0
        self.doctor: Optional[Doctor] = None
        # epoch → the poisoned [start, end) windows its replay excises.
        self._poison_windows: dict[int, list[tuple[int, int]]] = {}
        if cfg.doctor:
            self._arm_doctor()
        self._train_dispatched = False
        self.preemption: Optional[_PreemptionGuard] = None
        # The epoch's consumed positions of its global order, counted as
        # steps are dispatched; an emergency checkpoint's cursor starts
        # the resumed epoch there.
        self._epoch_consumed = 0
        self._epoch_cursor0 = 0
        self._pending_cursor: Optional[dict] = None
        self._epoch_skipped = 0
        self.profiler = StepProfiler(cfg.profile, cfg.outpath,
                                     enabled=self.primary,
                                     device=self.device)
        resume = cfg.resume
        if resume == "auto":
            resume = ckpt_lib.find_resumable(cfg.outpath)
            if not resume:
                self.log("=> --resume auto: no checkpoint in outpath, "
                         "starting fresh")
        if resume:
            self.load(resume)
        self.step_model = self.model
        if self.distributed:
            self.step_model = data_parallel(self.model, self.device)
            self.log(f"=> data-parallel: world {self.world}, backend "
                     f"{dist_lib.backend()}, DDP (buffers averaged after "
                     f"the step)" + (", SyncBN" if cfg.sync_batchnorm
                                     and self.has_bn else ""))
        self.train_step = self._make_train_step()
        step_model = self.step_model
        # --model-ema-decay: validation (and so 'best') measures the EMA.
        self.eval_step = (make_eval_step(step_model, cfg) if self.ema is None
                          else make_eval_step(self.ema, cfg,
                                              over_ranks=self.distributed))

    def _make_train_step(self):
        """The train step; its mixing and dropout draws are seeded by the
        state's step, which a resume or a rollback sets."""
        return make_train_step(self.step_model, self.optimizer, self.cfg,
                               ema=self.ema, first_step=self.state_step,
                               scaler=self.scaler, guard=self.cfg.doctor)

    def _arm_blackbox(self, on_gpu: bool) -> None:
        """The flight recorder: a telemetry sink beside the metrics
        registry, SIGUSR2 and ``POST /capture`` for a manual capture."""
        from tpudist_torch import blackbox as blackbox_lib
        cfg = self.cfg
        self.blackbox = blackbox_lib.BlackboxRecorder(
            cfg.outpath, rank=self.rank, ring=cfg.blackbox_ring,
            capture_steps=cfg.blackbox_capture_steps,
            cooldown_s=cfg.blackbox_cooldown_s, telemetry=self.telemetry,
            cuda=on_gpu)
        self.telemetry.add_sink(self.blackbox.observe)
        blackbox_lib.install_sigusr2(self.blackbox)
        if self.metrics_server is not None:
            self.metrics_server.set_capture(
                lambda: self.blackbox.request_capture("http"))
        self.log(f"=> blackbox armed: ring {cfg.blackbox_ring}, capture "
                 f"{cfg.blackbox_capture_steps} steps, cooldown "
                 f"{cfg.blackbox_cooldown_s:g}s (SIGUSR2 or POST /capture "
                 f"for manual)")

    def _arm_doctor(self) -> None:
        """The doctor's policy engine; the guard is in the train step."""
        cfg = self.cfg
        self.doctor = Doctor(cfg, cfg.outpath, rank=self.rank,
                             world=self.world, telemetry=self.telemetry,
                             log=self.log_all, primary=self.primary)
        probe_msg = (f"SDC probes every {cfg.doctor_probe_freq} steps"
                     if cfg.doctor_probe_freq else "SDC probes off")
        self.log(f"=> doctor armed: in-step sentinels fused (skip-step on "
                 f"non-finite); EWMA spike detector "
                 f"(σ={cfg.doctor_spike_sigma:g}); {probe_msg}; rollback "
                 f"cap {cfg.doctor_max_rollbacks}")

    def _start_metrics_server(self) -> None:
        """The rank's live endpoint: a ``MetricsRegistry`` fed as a
        telemetry sink from the first event on. Ranks of one host given the
        same fixed port: the one that loses the bind falls back to an
        ephemeral port, found through its port file."""
        from tpudist_torch.obs.server import MetricsRegistry, MetricsServer
        cfg = self.cfg
        reg = MetricsRegistry(rank=self.rank)
        self.telemetry.add_sink(reg.observe)
        try:
            self.metrics_server = MetricsServer(
                reg, port=cfg.metrics_port).start()
        except OSError as e:
            self.log(f"=> metrics port {cfg.metrics_port} unavailable "
                     f"({e!r}) — falling back to an ephemeral port")
            self.metrics_server = MetricsServer(reg, port=0).start()
        self.metrics_server.write_portfile(cfg.outpath, self.rank)
        self.log(f"=> live metrics on :{self.metrics_server.port} "
                 f"(/metrics Prometheus text, /healthz)")

    def _build_kernels(self) -> None:
        """Compile the kernel sources this run may launch, its dispatch
        probes included (one ``nvcc`` each, in parallel), before the first
        step; the time is a ``kernel_build`` compile event."""
        cfg = self.cfg
        names = []
        if self.has_attention and cfg.flash != "off":
            names += ["flash_fwd"] + ([] if cfg.evaluate else ["flash_bwd"])
        if cfg.fused_bn != "off" and self.has_bn and not (
                cfg.evaluate or cfg.sync_batchnorm):
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

    def _microbatch(self) -> int:
        """The rows of one forward of a train step on this rank."""
        cfg = self.cfg
        return cfg.per_device_batch_size // max(1, cfg.accum_steps)

    def _resolve_attention_dispatch(self) -> dict:
        """Resolve ``--flash`` for the ViT's attention workload (the
        microbatch's batch, its tokens, heads and head dim, the compute
        dtype, train or eval) and set the verdict on the model and its EMA:
        the flash ``Function`` (the CUDA kernels on the card, their plain
        versions on the CPU) or plain attention. Logged in tpudist's format
        and emitted as an ``attention_dispatch`` event."""
        cfg = self.cfg
        m = self.model
        heads = m.num_heads
        dt = compute_dtype(cfg)
        train = not cfg.evaluate

        def decide():
            return attention_dispatch.decide(
                self._microbatch(), m.tokens, heads, m.hidden_dim // heads,
                dt, train=train, mode=cfg.flash,
                platform=self.device.type, device=self.device)

        dec = (dispatch.shared_decision(decide, what="attention dispatch")
               if cfg.flash == "auto" else decide())
        if cfg.flash == "on" and self.device.type != "cuda":
            dec["reason"] = "the CPU runs each kernel's plain body"
        for model in (self.model, self.ema):
            if model is not None:
                model.set_flash(dec["kernel"] == "flash")
        msg = (f"=> attention dispatch: {dec['kernel']} attention (mode "
               f"{dec['mode']}, {dec['source']}")
        if dec.get("reason"):
            msg += f": {dec['reason']}"
        if dec.get("flash_ms") is not None:
            msg += (f"; {dec['key']}: flash {dec['flash_ms']:.4f} ms vs "
                    f"plain {dec['plain_ms']:.4f} ms, margin "
                    f"{dec.get('margin', 0.0):.1%}")
        self.log(msg + ")")
        if self.telemetry is not None:
            self.telemetry.emit("attention_dispatch",
                                **attention_dispatch.event_fields(dec))
        return dec

    def _resolve_fused_norm_dispatch(self) -> dict:
        """Resolve ``--fused-bn`` for every train-mode BN+ReLU workload of
        the model and set each site's verdict (``BatchNorm.fused``). The
        structural cases come first, as in tpudist: ``off``, a model
        without BatchNorm (the ViTs, the plain vggs), eval-only runs and
        SyncBN take the plain epilogue; the
        CPU takes it under ``auto`` without measuring. Otherwise the
        workloads are recorded at the microbatch's rows and decided one by
        one: forced under ``on`` (the CUDA kernels on the card, their plain
        bodies on the CPU), measured or read from the cache under ``auto``
        (rank 0's verdicts for the whole gang). Logged as tpudist's line
        with each workload's timings, emitted as a ``fused_norm_dispatch``
        event."""
        cfg = self.cfg
        norm_dispatch.set_mode(cfg.fused_bn)
        agg = {"kernel": "plain", "mode": cfg.fused_bn, "source": "platform",
               "n_sites": 0, "n_fused": 0}
        if cfg.fused_bn == "off":
            agg.update(source="forced")
        elif not self.has_bn:
            agg.update(source="ineligible",
                       reason=f"{cfg.arch} has no BatchNorm")
        elif cfg.evaluate:
            agg.update(source="ineligible",
                       reason="eval mode runs the plain epilogue")
        elif cfg.sync_batchnorm:
            agg.update(source="ineligible",
                       reason="SyncBN's statistics all-reduce has no fused "
                              "kernel; plain epilogue")
        elif cfg.fused_bn == "on" or self.device.type == dispatch.ACCELERATOR:
            agg = self._decide_fused_norm(self._record_fused_norm_requests())
        sites = {}
        for m in self.model.modules():
            if isinstance(m, BatchNorm):
                d = agg.get("decisions", {}).get(m.dispatch_key)
                m.fused = bool(d) and d["kernel"] == "cuda"
                if d:
                    sites[m.dispatch_key] = sites.get(m.dispatch_key, 0) + 1
        msg = (f"=> fused-norm dispatch: {agg['kernel']} epilogue (mode "
               f"{agg['mode']}, {agg['source']}")
        if agg.get("reason"):
            msg += f"; {agg['reason']}"
        elif agg.get("n_sites"):
            msg += (f"; {agg['n_fused']}/{agg['n_sites']} BN workloads "
                    f"fused")
        self.log(msg + ")")
        for key, d in sorted(agg.get("decisions", {}).items()):
            timed = (f": cuda {d['cuda_ms']:.4f} ms vs plain "
                     f"{d['plain_ms']:.4f} ms, margin {d['margin']:.1%}"
                     if d.get("cuda_ms") is not None else "")
            n = sites.get(key, 0)
            self.log(f"=>   {key} ({n} site{'' if n == 1 else 's'}){timed}"
                     f" → {d['kernel']} ({d['source']})")
        if self.telemetry is not None:
            self.telemetry.emit("fused_norm_dispatch",
                                **norm_dispatch.event_fields(agg))
        return agg

    def _record_fused_norm_requests(self) -> set:
        """The (rows, channels, key, residual, dtype) workloads the model's
        BN sites ask about, from one no-grad train-mode forward of zeros at
        the microbatch's rows (no running statistic moves)."""
        cfg = self.cfg
        dummy = torch.zeros((self._microbatch(), cfg.image_size,
                             cfg.image_size, 3), device=self.device)
        was = self.model.training
        self.model.train()
        try:
            with torch.no_grad(), norm_dispatch.record_requests() as reqs:
                self.model(dummy)
        finally:
            self.model.train(was)
        return reqs

    def _decide_fused_norm(self, reqs: set) -> dict:
        cfg = self.cfg
        if not reqs:
            return {"kernel": "plain", "mode": cfg.fused_bn,
                    "source": "no_sites", "n_sites": 0, "n_fused": 0,
                    "reason": "no fused-eligible BN epilogue in this model"}

        def decide_all():
            decisions = {}
            for rows, channels, key, residual, dt in sorted(
                    reqs, key=lambda r: r[2]):
                decisions[key] = norm_dispatch.decide(
                    rows, channels, dt, residual=residual, mode=cfg.fused_bn,
                    platform=self.device.type, device=self.device)
            out = norm_dispatch.aggregate(decisions, cfg.fused_bn)
            out["key"] = norm_dispatch.combined_key(reqs)
            return out

        if cfg.fused_bn == "on":
            agg = dict(decide_all(), source="forced")
            if self.device.type != "cuda":
                agg.update(kernel="plain",
                           reason="the CPU runs each kernel's plain body")
            return agg
        agg = dispatch.shared_decision(decide_all, what="fused-norm dispatch")
        if agg.get("key") != norm_dispatch.combined_key(reqs):
            raise RuntimeError(
                f"rank 0's fused-norm verdicts are for other workloads "
                f"({agg.get('key')}) than this rank's "
                f"({norm_dispatch.combined_key(reqs)})")
        return agg

    def _first_step_kernels(self):
        """``(label, ops module)`` of the kernels a train step launches on
        the card, or None where it launches none."""
        if self.device.type != "cuda":
            return None
        if self.has_attention:
            return (("flash", flash_attention)
                    if self.attention_decision["kernel"] == "flash" else None)
        return (("fused-norm", fused_norm)
                if self.fused_norm_decision["n_fused"] else None)

    def _log_first_step_launches(self, label: str, ops,
                                 before: dict) -> None:
        launched = {k: ops.LAUNCHES[k] - before[k] for k in ops.KERNELS}
        self.log(f"=> {label} kernels launched by the first train step: "
                 f"{sum(launched.values())} ("
                 + ", ".join(f"{k} {v}" for k, v in launched.items()) + ")")

    def log(self, msg: str) -> None:
        """The primary rank's log; the other ranks log nothing."""
        if self.logger is not None:
            self.logger.info(msg)

    def log_all(self, msg: str) -> None:
        """Every rank's log (a rank that evicts itself must say so)."""
        if self.primary:
            self.log(msg)
        else:
            print(f"[rank {self.rank}] {msg}", flush=True)

    def _kick(self) -> None:
        if self.watchdog is not None:
            self.watchdog.kick()

    def _on_fault(self, point: str, step, info: dict) -> None:
        """``faults.set_observer``'s sink: each fired injection is a
        ``fault`` event (the loader's threads call it; emit is locked)."""
        fields = {k: v for k, v in info.items()
                  if isinstance(v, (int, float, str))}
        if step is not None:
            fields["step"] = step
        self.telemetry.emit("fault", point=point, **fields)

    def _check_preemption(self) -> None:
        """At a boundary: raise ``PreemptionRequested`` when this rank,
        or under --distributed any rank, caught a signal."""
        if self.preemption is None:
            return
        if not self.distributed:
            self.preemption.check()
            return
        if dist_lib.any_rank(self.preemption.requested is not None):
            self.preemption.check()
            raise PreemptionRequested("a peer's signal")

    # -- checkpointing ----------------------------------------------------

    def save(self, epoch: int, is_best: bool) -> None:
        """The primary rank writes the epoch's checkpoint; every rank
        emits ``checkpoint_save`` with the seconds it spent."""
        t0 = time.time()
        try:
            if self.primary:
                cfg = self.cfg
                state = ckpt_lib.state_to_dict(
                    self.model, self.optimizer, arch=cfg.arch, epoch=epoch,
                    best_acc1=self.best_acc1, step=self.state_step,
                    ema=self.ema, topology=ckpt_lib.topology_tag(
                        self.world, cfg.per_device_batch_size,
                        cfg.batch_size),
                    scaler=self.scaler, opt_steps=self.opt_steps,
                    doctor=self._doctor_payload())
                ckpt_lib.save_checkpoint(state, is_best, cfg.outpath,
                                         keep=cfg.keep_checkpoints)
                if cfg.torch_checkpoints:
                    self._save_torch(epoch, is_best)
        finally:
            if self.telemetry is not None:
                self.telemetry.note_checkpoint(time.time() - t0,
                                               kind="epoch", epoch=epoch)

    def _save_torch(self, epoch: int, is_best: bool) -> None:
        """The reference's files: ``checkpoint.pth.tar`` holds the live
        weights (what a resume continues), ``model_best.pth.tar`` the
        weights ``best_acc1`` was measured on (the EMA copy when there is
        one)."""
        cfg = self.cfg
        live = torch_ckpt.save_reference_checkpoint(
            os.path.join(cfg.outpath, "checkpoint.pth.tar"), self.model,
            cfg.arch, epoch, self.best_acc1)
        if not is_best:
            return
        best = os.path.join(cfg.outpath, "model_best.pth.tar")
        if self.ema is None:
            shutil.copyfile(live, best)
        else:
            torch_ckpt.save_reference_checkpoint(best, self.ema, cfg.arch,
                                                 epoch, self.best_acc1)

    def _data_cursor(self, epoch: int, train_loader) -> dict:
        """The interrupted epoch's cursor: its consumed positions and the
        loader's meters, which carry into the resumed epoch."""
        skipped, retried = _data_meters(train_loader)
        return {"epoch": epoch, "consumed": int(self._epoch_consumed),
                "samples_skipped": int(skipped),
                "samples_retried": int(retried)}

    def save_emergency(self, epoch: int, train_loader) -> None:
        """The preemption drain's checkpoint. The epoch is not complete,
        so it is stamped ``epoch - 1`` (a resume re-enters ``epoch``) with
        the cursor, never marks best, and writes the live file only
        (``keep=0``: a history copy would overwrite the clean snapshot of
        the same stored epoch). The card finishes every dispatched step
        before the weights are read."""
        self.log(f"=> preemption: writing emergency checkpoint (will "
                 f"resume at epoch {epoch}, global sample cursor "
                 f"{self._epoch_consumed})")
        t0 = time.time()
        try:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            if self.primary:
                cfg = self.cfg
                state = ckpt_lib.state_to_dict(
                    self.model, self.optimizer, arch=cfg.arch,
                    epoch=epoch - 1, best_acc1=self.best_acc1,
                    step=self.state_step, ema=self.ema,
                    topology=ckpt_lib.topology_tag(
                        self.world, cfg.per_device_batch_size,
                        cfg.batch_size),
                    data_cursor=self._data_cursor(epoch, train_loader),
                    scaler=self.scaler, opt_steps=self.opt_steps,
                    doctor=self._doctor_payload())
                ckpt_lib.save_checkpoint(state, False, cfg.outpath, keep=0)
        finally:
            if self.telemetry is not None:
                self.telemetry.note_checkpoint(time.time() - t0,
                                               kind="emergency", epoch=epoch)

    def _doctor_payload(self) -> Optional[dict]:
        """The doctor's replay state for a save: the poison windows (an
        emergency cursor counts positions of the excised order) and the
        rollback count (the budget survives a restart)."""
        if self.doctor is None \
                or not (self._poison_windows or self.doctor.rollbacks):
            return None
        return {"rollbacks": int(self.doctor.rollbacks),
                "poison_windows": {str(ep): [[int(a), int(b)] for a, b in ws]
                                   for ep, ws in self._poison_windows.items()
                                   if ws}}

    def _restore_doctor(self, doc) -> None:
        """Re-arm the windows and the rollback count a save carried
        (before the cursor applies: it counts the excised order)."""
        if not doc:
            return
        if self.doctor is None:
            if doc.get("poison_windows"):
                self.log(f"=> checkpoint carries the doctor's replay "
                         f"windows {dict(doc['poison_windows'])}; --doctor "
                         f"is off, so they are not applied")
            return
        try:
            self._poison_windows = {
                int(ep): [(int(a), int(b)) for a, b in ws]
                for ep, ws in dict(doc.get("poison_windows") or {}).items()}
            self.doctor.rollbacks = int(doc.get("rollbacks", 0))
        except (TypeError, ValueError):
            self.log("=> doctor: malformed replay state in checkpoint "
                     "— ignoring (windows lost, budget reset)")
            return
        if self._poison_windows:
            self.log(f"=> doctor: checkpoint carries poison windows "
                     f"{self._poison_windows} (rollbacks so far: "
                     f"{self.doctor.rollbacks}) — replay continues with "
                     f"them excised")

    def load(self, path: str) -> None:
        """Resume from ``path`` on this rank: the start epoch, best_acc1,
        step count, weights, optimizer state and EMA."""
        t0 = time.time()
        try:
            self._load(path)
        finally:
            if self.telemetry is not None:
                self.telemetry.note_restore(time.time() - t0, path=str(path),
                                            epoch=self.start_epoch)

    def _load(self, path: str) -> None:
        cfg = self.cfg
        if str(path).endswith((".pth", ".pth.tar", ".pt")):
            # The reference's file: its weights, epoch and best_acc1; the
            # optimizer starts fresh (the reference never saved it).
            self.start_epoch, self.best_acc1 = torch_ckpt.restore_from_torch(
                self.model, path, cfg.arch, ema=self.ema)
            self.log(f"=> imported torch checkpoint '{path}' (epoch "
                     f"{self.start_epoch}, best_acc1 {self.best_acc1:.3f})")
            return
        live = os.path.join(cfg.outpath, ckpt_lib.CKPT_NAME)
        if os.path.abspath(path) in (os.path.abspath(live),
                                     os.path.abspath(cfg.outpath)):
            # This run's own outpath (--resume auto, a launcher restart):
            # a torn or corrupt live file falls back to the history.
            ckpt, path = ckpt_lib.load_checkpoint_with_fallback(
                cfg.outpath, log=self.log, keep=cfg.keep_checkpoints)
        else:
            # An explicit file: the user named these bytes.
            ckpt = ckpt_lib.load_checkpoint(path)
        try:
            self.global_step = self.state_step = ckpt_lib.restore(
                ckpt, self.model, self.optimizer, self.ema, arch=cfg.arch,
                world=self.world, log=self.log, scaler=self.scaler,
                train=not cfg.evaluate)
        except (ValueError, RuntimeError) as e:
            raise ValueError(f"cannot resume from '{path}': {e}") from e
        self.opt_steps = ckpt_lib.optimizer_count(ckpt)
        self.best_acc1 = float(ckpt.get("best_acc1", 0.0))
        self.start_epoch = int(ckpt.get("epoch", 0))
        self.log(f"=> resumed from '{path}' (epoch {self.start_epoch}, "
                 f"best_acc1 {self.best_acc1:.3f})")
        if self.scaler is not None:
            self.log(f"=> dynamic loss scale restored: scale "
                     f"{self.scaler.scale:g}, fin_steps "
                     f"{self.scaler.fin_steps}")
        cur = ckpt.get("data_cursor")
        if cur and int(cur.get("consumed", 0)) > 0:
            # An emergency save: fit() applies it to its epoch.
            self._pending_cursor = dict(cur)
            self.log(f"=> checkpoint carries a mid-epoch sample cursor: "
                     f"epoch {cur.get('epoch')} continues at global sample "
                     f"{cur.get('consumed')} (no replay, no drop)")
        self._restore_doctor(ckpt.get("doctor"))

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
        doctor = self.doctor
        drain = _MetricDrain({"loss": losses, "acc1": top1},
                             lag=1 if async_drain else 0,
                             observer=(self._on_step_metrics
                                       if doctor is not None else None))
        pf = DevicePrefetcher(loader, self.device) if cfg.device_prefetch \
            else None
        tel = self.telemetry
        self._epoch_skipped = 0
        # Continue from the resumed cursor (fit() sets it), else 0.
        self._epoch_consumed, self._epoch_cursor0 = self._epoch_cursor0, 0
        end = t_prev = time.time()
        try:
            for i, (images, labels) in enumerate(
                    _waited(pf if pf is not None else loader)):
                now = time.time()
                data_time.update(now - end)
                data_s = now - t_prev
                self.profiler.step(self.global_step)
                if self.blackbox is not None:
                    self.blackbox.poll(self.global_step)
                self._kick()
                # The boundary: every earlier step is dispatched, this one
                # is not. A pending signal drains here.
                self._check_preemption()
                if doctor is not None:
                    # A pending rollback raises here; the probe digests
                    # the state every dispatched step has written.
                    doctor.check_response()
                    if doctor.should_probe(self.global_step):
                        self._kick()
                        self._probe(doctor)
                faults.maybe_rank_exit(self.global_step)
                faults.maybe_slow_peer(self.global_step)
                faults.maybe_straggle(self.global_step)
                if faults.armed("bitflip"):
                    faults.maybe_bitflip(self.global_step, self.model)
                if faults.armed("lossbomb"):
                    faults.maybe_lossbomb(self.global_step, self.model)
                first_dispatch = not self._train_dispatched
                self._train_dispatched = True
                counted = (self._first_step_kernels() if first_dispatch
                           else None)
                launches = dict(counted[1].LAUNCHES) if counted else None
                # One range a step: the profiler's trace groups the step's
                # launches and device work under it.
                with record_function("train"):
                    t_h = time.time()
                    if pf is None:
                        with record_function("tpudist.h2d"):
                            images, labels = to_device(images, labels,
                                                       self.device)
                    if faults.armed("nanbomb"):
                        images = faults.maybe_nanbomb(self.global_step,
                                                      images)
                    t_c = time.time()
                    metrics = self.train_step(images, labels, lr)
                    t_done = time.time()
                h2d_s, compute_s = t_c - t_h, t_done - t_c
                consumed = int(images.shape[0]) * self.world
                if doctor is not None:
                    # The global positions this step consumed: what a
                    # rollback excises.
                    doctor.note_step(self.global_step, epoch,
                                     self._epoch_consumed,
                                     self._epoch_consumed + consumed)
                self._epoch_consumed += consumed
                if metrics.pop("finite", True):
                    self.opt_steps += 1
                else:
                    self._epoch_skipped += 1
                if counted:
                    self._log_first_step_launches(*counted, launches)
                prefetch_s = None
                if pf is not None:
                    # The next batch's copy, staged behind this step.
                    with record_function("tpudist.h2d"):
                        prefetch_s = pf.poke()
                drain.push(metrics, n=int(images.shape[0]),
                           step=self.global_step)
                drain_ovl_s = None
                if async_drain:
                    t_do = time.time()
                    drain.drain_ready()
                    drain_ovl_s = time.time() - t_do
                step_num = self.global_step
                self.global_step += 1
                self.state_step += 1
                self._kick()
                batch_time.update(time.time() - end)
                end = time.time()
                drain_s = 0.0
                if i % cfg.print_freq == 0:
                    with record_function("tpudist.metric_drain"):
                        t_d = time.time()
                        drain.drain_ready() if async_drain else drain.drain()
                        drain_s = time.time() - t_d
                    self.log(progress.display(i))
                if tel is not None:
                    tel.step(step=step_num, epoch=epoch, data_s=data_s,
                             h2d_s=h2d_s, compute_s=compute_s,
                             drain_s=drain_s, step_s=time.time() - t_prev,
                             compile_s=compute_s if first_dispatch else 0.0,
                             prefetch_s=prefetch_s, drain_ovl_s=drain_ovl_s)
                t_prev = time.time()
        except PreemptionRequested:
            drain.drain()           # every dispatched step's metrics
            raise
        drain.drain()
        if doctor is not None:
            # A spike in the epoch's last steps acts before its validation
            # and its checkpoint.
            doctor.check_response()
        self.profiler.epoch_end()
        self.log(f"||==> Train: Epoch[{epoch}]\tLoss {losses.avg:.4e}\t"
                 f"Acc@1 {top1.avg:6.2f}")
        if self.scaler is not None:
            self.log(f"=> dynamic loss scale after epoch {epoch}: scale "
                     f"{self.scaler.scale:g}, fin_steps "
                     f"{self.scaler.fin_steps}; {self._epoch_skipped} of "
                     f"{len(loader)} steps skipped (non-finite gradients)")
        skipped, retried = _data_meters(loader)
        if skipped or retried:
            # Skips spent the corruption budget; retries healed a load.
            self.log(f"||==> Data: Epoch[{epoch}]\tsamples_skipped {skipped}"
                     f"\tsamples_retried {retried}")
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
            self._kick()    # validation batches are progress too
            self._check_preemption()
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

    def _on_step_metrics(self, step: int, vals: dict) -> None:
        """The drain's observer under ``--doctor``: a step the guard undid
        landed no optimizer update; the doctor reads the flags."""
        if vals.get("notfinite", 0.0) >= 0.5:
            self.opt_steps -= 1
        self.doctor.on_metrics(step, vals)

    def _probe(self, doctor: Doctor) -> None:
        """The SDC probe at a step boundary: this rank's digest against the
        others'; a rank minority-divergent in ``--doctor-sdc-windows``
        consecutive probes ends with ``faults.SDC_EXIT_CODE``."""
        leaves = probes.state_leaves(self.model, self.optimizer, self.ema)
        if doctor.probe(self.global_step, leaves) == "evict":
            self.log_all(
                f"=> doctor: this rank's replicated state is "
                f"minority-divergent in {doctor.sdc_windows} consecutive "
                f"probes — silent data corruption on this host; "
                f"self-quarantining (exit {faults.SDC_EXIT_CODE}, no "
                f"checkpoint written)")
            raise SystemExit(faults.SDC_EXIT_CODE)

    def _fresh_initial_state(self) -> None:
        """The run's seeded initial state, in place: the weights drawn as
        ``__init__`` drew them (and ``--pretrained``'s), a fresh optimizer
        state, the EMA at those weights, a fresh float16 loss scale."""
        cfg = self.cfg
        seed = cfg.seed if cfg.seed is not None else 0
        fresh = create_model(cfg.arch, **self._model_kw)
        fresh.reset_parameters(torch.Generator().manual_seed(seed))
        if cfg.pretrained:
            pretrained_lib.load_pretrained(
                fresh, cfg.arch, pretrained_lib.resolve_pretrained_path(
                    cfg.arch, cfg.pretrained_path))
        self.model.load_state_dict(fresh.state_dict())
        self.optimizer.state.clear()
        if self.ema is not None:
            self.ema.load_state_dict(self.model.state_dict())
        if self.scaler is not None:
            self.scaler.load_state_dict(make_scaler(cfg).state_dict())

    def _doctor_rollback(self, rb: RollbackRequested) -> int:
        """Answer a spike or a persistent non-finite verdict: restore the
        newest probe-verified-good checkpoint (the newest intact one when
        no verdict exists, the seeded initial state when no checkpoint
        does), record the poisoned windows for the replay, and return the
        epoch to re-enter. ``global_step`` keeps counting dispatches; the
        state's step rolls back with the weights."""
        cfg = self.cfg
        doctor = self.doctor
        if doctor.rollbacks >= cfg.doctor_max_rollbacks:
            raise RuntimeError(
                f"doctor: {rb.reason} at step {rb.step}, but the rollback "
                f"budget (--doctor-max-rollbacks {cfg.doctor_max_rollbacks}"
                f") is exhausted — the run is deterministically unhealthy "
                f"(diverging recipe, bad lr, or poisoned corpus); refusing "
                f"to replay it forever")
        windows = doctor.windows_for(rb)
        self.log_all(f"=> doctor: {rb.reason} at step {rb.step} — rolling "
                     f"back to the newest verified-good checkpoint")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.time()
        to_epoch = 0
        path = "<fresh init>"
        try:
            ckpt, path = ckpt_lib.load_checkpoint_with_fallback(
                cfg.outpath, log=self.log, keep=cfg.keep_checkpoints,
                require_verified=True)
        except FileNotFoundError:
            self.log_all("=> doctor: no checkpoint exists yet — rolling "
                         "back to the seeded initial state")
            self._fresh_initial_state()
            self.state_step = self.opt_steps = 0
        else:
            self.state_step = ckpt_lib.restore(
                ckpt, self.model, self.optimizer, self.ema, arch=cfg.arch,
                world=self.world, log=self.log, scaler=self.scaler)
            self.opt_steps = ckpt_lib.optimizer_count(ckpt)
            to_epoch = int(ckpt.get("epoch", 0))
            self.best_acc1 = float(ckpt.get("best_acc1", self.best_acc1))
        # The draws of the replayed steps are the first run's.
        self.train_step = self._make_train_step()
        if self.telemetry is not None:
            self.telemetry.note_restore(time.time() - t0, path=str(path),
                                        epoch=to_epoch, rollback=1)
        for wepoch, a, b in windows:
            self._poison_windows.setdefault(wepoch, []).append((a, b))
        doctor.on_rollback(rb, to_epoch, windows)
        self._pending_cursor = None
        self.log_all(
            f"=> doctor: rolled back to '{path}' (re-entering epoch "
            f"{to_epoch})"
            + ("; " + "; ".join(
                f"epoch {we} will replay minus global samples [{a}, {b})"
                for we, a, b in windows) if windows
               else "; no poisoned window recorded (step out of the "
                    "position ring)"))
        return to_epoch

    def _peak_memory_gb(self) -> float | None:
        if self.device.type != "cuda":
            return None
        return torch.cuda.max_memory_allocated(self.device) / 1e9

    def fit(self, train_loader=None, val_loader=None) -> float:
        cfg = self.cfg
        if train_loader is None or val_loader is None:
            train_loader, val_loader = build_train_val_loaders(
                cfg, self.rank, self.world)
            if cfg.data and not cfg.synthetic:
                self.log("=> data path: " + "; ".join(
                    f"{split} {path} ({why})" for split, (path, why) in (
                        ("train", train_loader.data_path),
                        ("val", val_loader.data_path))))
        epoch = self.start_epoch
        try:
            if cfg.evaluate:
                return self.validate(val_loader, epoch=-1)
            if cfg.stall_timeout > 0:
                # Started here, after __init__ built every kernel with nvcc
                # and ran the dispatch probes: a cold build never counts
                # against the budget. The timeout budgets one unit of
                # progress (a step, a validation batch, a replica check, a
                # save), and the first step gets all of it (kicked before
                # its dispatch, as tpudist kicks before its compile).
                self.watchdog = Watchdog(cfg.stall_timeout).start()
            self.preemption = _PreemptionGuard().install()
            total_time = 0.0
            epoch = self.start_epoch
            while epoch < cfg.epochs:
                t0 = time.time()
                train_loader.set_epoch(epoch)
                if self._poison_windows.get(epoch):
                    # A rollback's replay: the epoch's order minus the
                    # poisoned windows (after set_epoch, which clears them;
                    # before the cursor, which counts the excised order).
                    train_loader.set_skip_windows(self._poison_windows[epoch])
                    self.log(f"=> doctor: epoch {epoch} replays with "
                             f"poisoned window(s) "
                             f"{self._poison_windows[epoch]} excised "
                             f"({len(train_loader)} steps remain)")
                cur, self._pending_cursor = self._pending_cursor, None
                if cur is not None and int(cur.get("epoch", -1)) == epoch:
                    # After set_epoch, which clears the cursor: the rest of
                    # the interrupted epoch's global order, strided over
                    # this world, with the interrupted attempt's meters.
                    consumed = int(cur.get("consumed", 0))
                    train_loader.set_cursor(
                        consumed,
                        samples_skipped=int(cur.get("samples_skipped", 0)),
                        samples_retried=int(cur.get("samples_retried", 0)))
                    self._epoch_cursor0 = consumed
                    self.log(f"=> elastic continuation: epoch {epoch} "
                             f"resumes at global sample {consumed} "
                             f"({len(train_loader)} steps remain on world "
                             f"{self.world})")
                lr = lr_for_epoch(cfg, epoch)
                self.log(f"self.optimizer={{'lr': {lr}}}")
                try:
                    self.train_epoch(train_loader, epoch, lr)
                except RollbackRequested as rb:
                    epoch = self._doctor_rollback(rb)
                    continue
                t_v = time.time()
                acc1 = self.validate(val_loader, epoch)
                if self.telemetry is not None:
                    self.telemetry.note_eval(time.time() - t_v, epoch=epoch,
                                             acc1=float(acc1))
                if (cfg.replica_check_freq
                        and (epoch + 1) % cfg.replica_check_freq == 0):
                    self._kick()
                    n = assert_replicas_consistent(replica_leaves(self.model))
                    if n:
                        self.log(f"replica consistency check passed "
                                 f"({n} leaves, epoch {epoch})")
                    else:
                        self.log("replica consistency check skipped: no "
                                 "replicated leaves (single device or fully "
                                 "sharded state)")
                is_best = acc1 > self.best_acc1
                if is_best:
                    self.best_acc1 = float(acc1)
                    self.log(f"best_acc1={self.best_acc1:.3f}, "
                             f"epoch={epoch}")
                self._kick()
                self.save(epoch, is_best)
                self._kick()
                epoch_time = time.time() - t0
                total_time += epoch_time
                peak = self._peak_memory_gb()
                self.log(f"||==> Epoch[{epoch}] time cost {epoch_time:.2f}s, "
                         f"total {total_time:.2f}s"
                         + (f", peak_hbm {peak:.3f}GB" if peak else ""))
                if self.telemetry is not None:
                    extra = {"peak_hbm_gb": peak} if peak else {}
                    skipped, retried = _data_meters(train_loader)
                    if skipped or retried:
                        extra.update(samples_skipped=skipped,
                                     samples_retried=retried)
                    if self.scaler is not None:
                        extra.update(loss_scale=self.scaler.scale,
                                     fin_steps=self.scaler.fin_steps,
                                     scaler_skipped=self._epoch_skipped)
                    self.telemetry.emit(
                        "epoch", epoch=epoch, seconds=round(epoch_time, 3),
                        **extra)
                epoch += 1
            if self.doctor is not None:
                self.log(f"=> doctor summary: {self.doctor.summary()}")
            return self.best_acc1
        except PreemptionRequested as sig:
            # The dispatched steps are in the weights; the cursor counts
            # them. Save, and exit resumable.
            self.log(f"=> caught {sig} — draining for preemption")
            if self.telemetry is not None:
                self.telemetry.emit("preempt", signal=str(sig), epoch=epoch)
            self.save_emergency(epoch, train_loader)
            self.log(f"=> emergency checkpoint complete; exiting "
                     f"{faults.PREEMPTED_EXIT_CODE} (resumable)")
            raise SystemExit(faults.PREEMPTED_EXIT_CODE)
        finally:
            if self.preemption is not None:
                self.preemption.uninstall()
                self.preemption = None
            self.profiler.close()
            if self.blackbox is not None:
                # A still-open capture stops before the telemetry closes.
                self.blackbox.close()
            if self.watchdog is not None:
                self.watchdog.stop()
                self.watchdog = None
            if self.telemetry is not None:
                # What the card ran: the wrappers count only launches.
                self.telemetry.close(
                    best_acc1=float(self.best_acc1),
                    kernel_launches={**fused_norm.LAUNCHES,
                                     **flash_attention.LAUNCHES})
                telemetry_lib.set_current(None)
                faults.set_observer(None)
            if self.metrics_server is not None:
                # After run_end reached the registry (a last scrape sees the
                # closing goodput); then the port and its file go.
                self.metrics_server.close()
                self.metrics_server = None


def _waited(batches):
    """``batches``, each wait for the next one inside a
    ``tpudist.data_wait`` range."""
    it = iter(batches)
    while True:
        with record_function("tpudist.data_wait"):
            try:
                batch = next(it)
            except StopIteration:
                return
        yield batch


def _data_meters(loader) -> tuple[int, int]:
    """The epoch's ``samples_skipped`` and ``samples_retried`` of a loader
    (0 for one without the meters)."""
    return (getattr(loader, "samples_skipped", 0),
            getattr(loader, "samples_retried", 0))


def run(cfg: Config) -> float:
    """The reference's ``main()``: under ``--distributed`` join the process
    group first (NCCL on the card, gloo on the CPU) and leave it at the
    end, on every exit path."""
    refuse_unsupported(cfg)
    # Before the rendezvous, where init_hang fires.
    faults.configure(cfg.inject or None)
    init_s = 0.0
    if cfg.distributed:
        init_s = dist_lib.initialize_runtime(
            cfg.coordinator_address, cfg.num_processes, cfg.process_id,
            device=cfg.device)
    try:
        return Trainer(cfg, init_s).fit()
    finally:
        dist_lib.shutdown()
