"""Run configuration: tpudist's flag surface as a typed dataclass.

The port's copy of ``tpudist/config.py``: the same flag names and
defaults (``build_parser``), so one command line means the same thing to
both trainers, plus ``--device {cuda,cpu}`` (default cuda; nothing falls
back to the CPU). ``--flash`` and ``--fused-bn`` default to ``auto``, as
in tpudist: the measurement dispatch (``ops/attention_dispatch``,
``ops/norm_dispatch``) picks each kernel on the card.

Every flag the port does not support yet is refused at startup by
``refuse_unsupported``, with a message that names it, rather than ignored;
``--data DIR`` without ``DIR/train`` or ``DIR/val`` fails in ``finalize``,
before the run directory is made.
``write_settings`` keeps tpudist's ``settings.log`` format.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Sequence


@dataclass
class Config:
    """Everything needed to run one experiment; field names are
    tpudist's (and the reference's ``args`` attribute names)."""

    # data
    data: str = ""
    workers: int = 8
    data_retries: int = 2
    data_retry_backoff: float = 0.05
    data_skip_budget: int = 0
    image_size: int = 224
    val_resize: int = 256
    synthetic: bool = False
    synthetic_size: int = 0
    # model
    arch: str = "resnet18"
    pretrained: bool = False
    pretrained_path: str = ""
    num_classes: int = 1000
    # schedule
    epochs: int = 5
    step: Sequence[int] = field(default_factory=lambda: [3, 4])
    start_epoch: int = 0
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    gamma: float = 0.1
    lr_scheduler: str = "steplr"
    optimizer: str = "sgd"
    warmup_epochs: int = 0
    label_smoothing: float = 0.0
    model_ema_decay: float = 0.0
    mixup_alpha: float = 0.0
    cutmix_alpha: float = 0.0
    auto_augment: str = ""
    random_erase: float = 0.0
    # batch: -b is the GLOBAL batch
    batch_size: int = 1200
    accum_steps: int = 1
    microbatches: int = 0
    # precision / BN / kernels
    use_amp: bool = True
    sync_batchnorm: bool = False
    amp_dtype: str = "bfloat16"
    remat: bool = False
    flash: str = "auto"
    fused_bn: str = "auto"
    device_prefetch: bool = True
    async_drain: bool = True
    compile_cache: str = ""
    # misc
    print_freq: int = 10
    evaluate: bool = False
    seed: int | None = None
    outpath: str = "./output_ddp_test"
    resume: str = ""
    overwrite: str = "prompt"
    torch_checkpoints: bool = False
    checkpoint_backend: str = "msgpack"
    keep_checkpoints: int = 2
    inject: str = ""
    # aux subsystems
    telemetry: bool = False
    telemetry_mfu: bool = True
    metrics_port: int = -1
    telemetry_max_mb: float = 256.0
    profile: str = ""
    doctor: bool = False
    doctor_probe_freq: int = 0
    doctor_spike_sigma: float = 6.0
    doctor_spike_min_steps: int = 8
    doctor_max_skips: int = 5
    doctor_max_rollbacks: int = 2
    doctor_sdc_windows: int = 2
    blackbox: bool = False
    blackbox_ring: int = 256
    blackbox_capture_steps: int = 8
    blackbox_cooldown_s: float = 120.0
    replica_check_freq: int = 0
    stall_timeout: float = 0.0
    require_platform: str = "any"
    # mesh and multi-process
    mesh_shape: Sequence[int] | None = None
    mesh_axes: Sequence[str] = field(default_factory=lambda: ["data"])
    zero_opt: bool = False
    zero: str = "off"
    compress_grads: str = "off"
    distributed: bool = False
    coordinator_address: str | None = None
    num_processes: int | None = None
    process_id: int | None = None
    # the port's own
    device: str = "cuda"

    # filled at runtime
    nprocs: int = 1
    per_device_batch_size: int = 0

    def finalize(self, num_devices: int = 1) -> "Config":
        """Derive the per-device batch from the global batch (one card a
        rank: ``num_devices`` is the world size) and check the values
        tpudist checks."""
        self.nprocs = num_devices
        self.per_device_batch_size = max(1, self.batch_size // num_devices)
        self.batch_size = self.per_device_batch_size * num_devices
        if self.synthetic_size < 0:
            raise ValueError(f"--synthetic-size must be >= 0, "
                             f"got {self.synthetic_size}")
        if self.accum_steps < 1:
            raise ValueError(f"--accum-steps must be >= 1, got "
                             f"{self.accum_steps}")
        if self.per_device_batch_size % self.accum_steps:
            raise ValueError(
                f"--accum-steps: batch {self.per_device_batch_size} (as "
                f"seen by this step: per rank) is not divisible by "
                f"accum_steps={self.accum_steps}")
        if 0 < self.synthetic_size < self.batch_size:
            raise ValueError(
                f"--synthetic-size {self.synthetic_size} is smaller than the "
                f"global batch {self.batch_size}; the train loader would "
                f"produce zero batches per epoch")
        for name, allowed in (("flash", ("auto", "on", "off")),
                              ("fused_bn", ("auto", "on", "off")),
                              ("device", ("cuda", "cpu"))):
            if getattr(self, name) not in allowed:
                raise ValueError(
                    f"--{name.replace('_', '-')} must be one of "
                    f"{'|'.join(allowed)}, got '{getattr(self, name)}'")
        if self.telemetry_max_mb < 0:
            raise ValueError(
                f"--telemetry-max-mb must be >= 0 (0 = uncapped), got "
                f"{self.telemetry_max_mb}")
        if self.metrics_port >= 0 and not self.telemetry:
            # The endpoint is fed by the telemetry event stream.
            raise ValueError(
                f"--metrics-port {self.metrics_port} requires --telemetry "
                f"(the endpoint serves gauges derived from the telemetry "
                f"event stream)")
        self._check_fault_planes()
        if self.val_resize < self.image_size:
            raise ValueError(
                f"--val-resize {self.val_resize} must be >= --image-size "
                f"{self.image_size} (the val stack resizes the shorter edge, "
                f"then center-crops image_size)")
        if isinstance(self.step, str):
            self.step = parse_milestones(self.step)
        if self.data and not self.synthetic:
            for split in ("train", "val"):
                root = os.path.join(self.data, split)
                if not os.path.isdir(root):
                    raise FileNotFoundError(
                        f"--data {self.data}: no {split} directory at "
                        f"{root} (an ImageFolder root holds train/<class>/"
                        f"<image> and val/<class>/<image>)")
        return self

    def _check_fault_planes(self) -> None:
        """tpudist's checks of the doctor and flight-recorder flags, in
        its words (``tpudist/config.py``)."""
        if not self.doctor:
            armed = {f.name: getattr(self, f.name)
                     for f in dataclasses.fields(self)
                     if f.name.startswith("doctor_")
                     and getattr(self, f.name) != f.default}
            if armed:
                raise ValueError(
                    f"--doctor-* tuning requires --doctor (nothing reads "
                    f"these knobs while the doctor is off); got "
                    f"{armed} with --doctor off")
        if self.blackbox and not self.telemetry:
            raise ValueError(
                "--blackbox requires --telemetry (the flight recorder is "
                "a telemetry sink: without the event stream the ring "
                "stays empty and triggers never fire)")
        if not self.blackbox:
            armed = {f.name: getattr(self, f.name)
                     for f in dataclasses.fields(self)
                     if f.name.startswith("blackbox_")
                     and getattr(self, f.name) != f.default}
            if armed:
                raise ValueError(
                    f"--blackbox-* tuning requires --blackbox (nothing "
                    f"reads these knobs while the recorder is off); got "
                    f"{armed} with --blackbox off")
        else:
            if self.blackbox_ring < 8:
                raise ValueError(
                    f"--blackbox-ring must be >= 8 (a ring shorter than "
                    f"that cannot span a trigger), got {self.blackbox_ring}")
            if self.blackbox_capture_steps < 1:
                raise ValueError(
                    f"--blackbox-capture-steps must be >= 1, got "
                    f"{self.blackbox_capture_steps}")
            if self.blackbox_cooldown_s < 0:
                raise ValueError(
                    f"--blackbox-cooldown-s must be >= 0, got "
                    f"{self.blackbox_cooldown_s}")
        if self.doctor:
            if self.evaluate:
                raise ValueError(
                    "--doctor with --evaluate: an eval-only run takes no "
                    "optimizer steps — there is nothing to guard; drop "
                    "one of the flags")
            if self.checkpoint_backend == "orbax":
                raise ValueError(
                    "--doctor requires --checkpoint-backend msgpack: "
                    "rollback-to-verified-good and probe verdict stamping "
                    "operate on the msgpack checkpoint surface (sidecars "
                    "beside checkpoint.msgpack); the orbax backend has no "
                    "verdict plumbing yet")
            if self.doctor_probe_freq < 0:
                raise ValueError(
                    f"--doctor-probe-freq must be >= 0 (0 = probes off), "
                    f"got {self.doctor_probe_freq}")
            if self.doctor_spike_sigma <= 0:
                raise ValueError(
                    f"--doctor-spike-sigma must be > 0, got "
                    f"{self.doctor_spike_sigma}")
            if self.doctor_max_rollbacks < 0:
                raise ValueError(
                    f"--doctor-max-rollbacks must be >= 0, got "
                    f"{self.doctor_max_rollbacks}")

    def asdict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


# The ViTs: the archs whose attention can take the flash kernels, and the
# only ones ``--flash on`` applies to (tpudist's ``vit*`` rule).
VIT_ARCHS = ("vit_b_16", "vit_b_32", "vit_l_16", "vit_l_32", "vit_h_14")
# tpudist's archs that need the expert and pipe mesh axes, which the port
# does not have: refused by name (models/__init__.py registers every
# other arch of tpudist's).
MULTI_AXIS_ARCHS = ("vit_moe_b_16", "vit_moe_s_16", "vit_pipe_b_16",
                    "vit_pipe_s_16")

# Flags the port does not support yet: a value other than the default is
# refused at startup, naming the flag and what is missing.
_NOT_YET = {
    "microbatches": ("--microbatches", "pipeline parallelism"),
    "remat": ("--remat", "block checkpointing"),
    "compile_cache": ("--compile-cache", "a persistent compile cache"),
    "require_platform": ("--require-platform", "a jax platform check "
                         "(the port's is --device)"),
    "mesh_shape": ("--mesh-shape", "the parallelism plane"),
    "mesh_axes": ("--mesh-axes", "the parallelism plane"),
    "zero_opt": ("--zero_opt", "ZeRO weight-update sharding"),
    "zero": ("--zero", "ZeRO weight-update sharding"),
    "compress_grads": ("--compress-grads", "gradient compression"),
}


def refuse_unsupported(cfg: Config) -> None:
    """Raise ``ValueError`` naming every flag set to something the port
    cannot do yet."""
    default = Config()
    bad = [f"{flag} ({what} is not in the port yet)"
           for name, (flag, what) in _NOT_YET.items()
           if getattr(cfg, name) != getattr(default, name)]
    vit = cfg.arch in VIT_ARCHS
    from tpudist_torch.models import model_names
    if cfg.arch in MULTI_AXIS_ARCHS:
        bad.append(f"-a {cfg.arch} (it needs the expert or pipe mesh axis, "
                   f"which the port does not have yet)")
    elif cfg.arch not in model_names():
        bad.append(f"-a {cfg.arch} (unknown arch; available: "
                   f"{', '.join(model_names())})")
    if not vit and cfg.flash == "on":
        bad.append(f"--flash on (it applies to attention archs (vit*); got "
                   f"'{cfg.arch}')")
    if cfg.pretrained_path and not cfg.pretrained:
        bad.append(f"--pretrained-path {cfg.pretrained_path} without "
                   f"--pretrained (it names the file --pretrained loads)")
    if cfg.checkpoint_backend == "orbax":
        bad.append("--checkpoint-backend orbax (orbax is not on the card; "
                   "the port writes tpudist's msgpack checkpoints)")
    if not 0.0 <= cfg.model_ema_decay < 1.0:
        bad.append(f"--model-ema-decay {cfg.model_ema_decay} (a decay lies "
                   f"in [0, 1); 0 is off)")
    if cfg.use_amp and cfg.amp_dtype == "float16":
        # tpudist's own refusals (tpudist/config.py), beside the port's
        # refusal of the flags themselves.
        if cfg.compress_grads != "off":
            bad.append("--compress-grads does not compose with float16 "
                       "dynamic loss scaling (the GradScaler path reduces "
                       "inside flax's DynamicScale grad_fn — no choke point "
                       "to swap); use --amp-dtype bfloat16")
        if cfg.zero == "full":
            bad.append("--zero full does not support float16 dynamic loss "
                       "scaling (like the SP/EP/PP specialty paths); use "
                       "--amp-dtype bfloat16")
    if bad:
        raise ValueError("unsupported in tpudist_torch: " + "; ".join(bad))


def parse_milestones(value: Any) -> list[int]:
    """Accept '[3,4]', '3,4', or a list."""
    if isinstance(value, (list, tuple)):
        return [int(v) for v in value]
    s = str(value).strip().strip("[]()")
    return [int(tok) for tok in s.replace(",", " ").split()] if s else []


def _bool_flag(p: argparse.ArgumentParser, name: str, default: bool,
               help: str) -> None:
    p.add_argument(f"--{name}", dest=name.replace("-", "_"),
                   action=argparse.BooleanOptionalAction, default=default,
                   help=help)


def build_parser() -> argparse.ArgumentParser:
    """tpudist's CLI surface (``tpudist/config.py::build_parser``) plus
    ``--device``."""
    d = Config()
    p = argparse.ArgumentParser(
        prog="python -m tpudist_torch",
        description="ImageNet training on a CUDA card (tpudist_torch)")
    add = p.add_argument
    not_yet = "not in the port yet: refused unless left at its default"
    add("--data", metavar="DIR", default=d.data, help="path to dataset (ImageFolder root with train/ and val/); empty => synthetic data")
    add("-a", "--arch", metavar="ARCH", default=d.arch, help="model architecture (tpudist_torch.models registry)")
    add("-j", "--workers", default=d.workers, type=int, metavar="N", help="data-loading worker threads")
    add("--epochs", default=d.epochs, type=int, metavar="N", help="number of total epochs to run")
    add("--step", default=list(d.step), metavar="step decay", help="lr decay milestones, e.g. '3,4'")
    add("--start-epoch", default=d.start_epoch, type=int, metavar="N", dest="start_epoch", help="first epoch (offsets the schedule)")
    add("-b", "--batch-size", default=d.batch_size, type=int, metavar="N", dest="batch_size", help="GLOBAL batch size")
    add("--accum-steps", default=d.accum_steps, type=int, dest="accum_steps", help="gradient-accumulation microbatches per optimizer step (the per-rank batch must divide)")
    add("--microbatches", default=d.microbatches, type=int, help=not_yet)
    add("--lr", "--learning-rate", default=d.lr, type=float, metavar="LR", dest="lr", help="initial learning rate")
    add("--momentum", default=d.momentum, type=float, metavar="M", help="momentum")
    add("--wd", "--weight-decay", default=d.weight_decay, type=float, metavar="W", dest="weight_decay", help="weight decay")
    add("-p", "--print-freq", default=d.print_freq, type=int, metavar="N", dest="print_freq", help="print frequency")
    _bool_flag(p, "evaluate", d.evaluate, "evaluate the model on the validation set only")
    _bool_flag(p, "pretrained", d.pretrained, "start from torchvision's weights, read from disk (never downloaded): --pretrained-path, else $TPUDIST_PRETRAINED_DIR, else $TORCH_HOME/hub/checkpoints")
    add("--pretrained-path", default=d.pretrained_path, dest="pretrained_path", help="local torchvision checkpoint file/dir for --pretrained (default: the directories above)")
    _bool_flag(p, "use_amp", d.use_amp, "mixed-precision compute policy: --amp-dtype (bf16 by default) activations, f32 master weights")
    add("--amp-dtype", default=d.amp_dtype, dest="amp_dtype", choices=("bfloat16", "float16"), help="--use_amp compute dtype: bfloat16 (no scaler) or float16 (adds tpudist's dynamic loss scaling, flax's DynamicScale rule: the reference's GradScaler recipe; composes with --accum-steps and --distributed)")
    _bool_flag(p, "sync_batchnorm", d.sync_batchnorm, "SyncBN: BatchNorm statistics averaged across the data-parallel ranks (the plain epilogue, as tpudist)")
    _bool_flag(p, "remat", d.remat, not_yet)
    add("--flash", default=d.flash, choices=("auto", "on", "off"), help="attention kernel for vit archs: on = the hand-written CUDA flash-attention kernels (forward, dQ and dKV), off = plain attention, auto = measurement-honest dispatch (both timed on the card at the exact attention shape, the kernel only where it wins; cached per card under $TPUDIST_DISPATCH_CACHE or ~/.cache/tpudist; plain on the CPU) (no-op for the conv nets; on is refused for them)")
    add("--fused-bn", default=d.fused_bn, dest="fused_bn", choices=("auto", "on", "off"), help="BN+ReLU / BN+add+ReLU epilogues in train mode: on = the hand-written CUDA kernels, off = the plain epilogue, auto = measurement-honest dispatch per (rows, channels, dtype, variant) workload (the kernels only where they win on the card; cached as --flash auto; plain on the CPU)")
    _bool_flag(p, "device_prefetch", d.device_prefetch, "stage the next batch's pinned host-to-device copy while the current step runs")
    _bool_flag(p, "async_drain", d.async_drain, "read each step's metrics back one step late, behind the next step's launch")
    add("--compile-cache", default=d.compile_cache, dest="compile_cache", metavar="DIR", help=not_yet)
    _bool_flag(p, "synthetic", d.synthetic, "use synthetic data")
    add("--seed", default=d.seed, type=int, help="seed for initializing training")
    add("--outpath", metavar="DIR", default=d.outpath, help="path to output")
    add("--lr-scheduler", metavar="LR scheduler", default=d.lr_scheduler, dest="lr_scheduler", help="LR scheduler (steplr|cosine)")
    add("--optimizer", default=d.optimizer, choices=("sgd", "adamw"), help="optimizer: sgd, or adamw (decay on tensors of 2 or more dims only)")
    add("--warmup-epochs", default=d.warmup_epochs, type=int, dest="warmup_epochs", help="linear lr warmup epochs")
    add("--label-smoothing", default=d.label_smoothing, type=float, dest="label_smoothing", help="cross-entropy label smoothing (train only)")
    add("--model-ema-decay", default=d.model_ema_decay, type=float, dest="model_ema_decay", help="per-step EMA decay of the parameters and BN buffers; validation and best use the EMA copy, which the checkpoint carries (0 = off)")
    add("--mixup-alpha", default=d.mixup_alpha, type=float, dest="mixup_alpha", help="mixup Beta(alpha,alpha) mixing inside the train step (0 = off)")
    add("--cutmix-alpha", default=d.cutmix_alpha, type=float, dest="cutmix_alpha", help="cutmix Beta(alpha,alpha) box mixing inside the train step (0 = off; both set = choose per step)")
    add("--auto-augment", default=d.auto_augment, choices=("", "ra", "ta_wide"), dest="auto_augment", help="train-time auto-augment policy: RandAugment or TrivialAugmentWide (moves the train split onto the PIL stack)")
    add("--random-erase", default=d.random_erase, type=float, dest="random_erase", help="RandomErasing probability on the train stack (0 = off; moves the train split onto the PIL stack)")
    add("--synthetic-size", default=d.synthetic_size, type=int, dest="synthetic_size", help="synthetic train-set size (0 = auto; val set is half)")
    add("--val-resize", default=d.val_resize, type=int, dest="val_resize", help="val shorter-edge resize before the center crop")
    add("--gamma", default=d.gamma, type=float, metavar="gamma", help="lr decay factor")
    add("--resume", default=d.resume, help="resume from a checkpoint.msgpack (an emergency file continues its epoch mid-way), a reference .pth.tar (its weights, epoch and best_acc1), a run dir, or 'auto' (this outpath's checkpoint if there is one, else start fresh; with python -m tpudist_torch.launch --max-restarts and --overwrite keep a relaunch continues)")
    _bool_flag(p, "torch_checkpoints", d.torch_checkpoints, "also write the reference's checkpoint.pth.tar (the live weights) and model_best.pth.tar (the EMA copy under --model-ema-decay)")
    add("--checkpoint-backend", default=d.checkpoint_backend, choices=["msgpack", "orbax"], dest="checkpoint_backend", help="msgpack: tpudist's checkpoint.msgpack every epoch; orbax is not ported (there is no orbax on the card): refused")
    add("--keep-checkpoints", default=d.keep_checkpoints, type=int, dest="keep_checkpoints", help="keep the newest N per-epoch checkpoint-epXXXXX.msgpack copies (and N quarantined files) for the fallback walk; 0 = live file only")
    add("--inject", default=d.inject, help="fault-injection spec, e.g. 'rank_exit@step=7;decode_fail:p=0.01' (tpudist_torch/faults.py; env TPUDIST_INJECT); a point whose plane the port lacks is refused")
    add("--data-retries", default=d.data_retries, type=int, dest="data_retries", help="retries per failing sample read/decode before skip-and-count")
    add("--data-retry-backoff", default=d.data_retry_backoff, type=float, dest="data_retry_backoff", help="linear backoff between sample-load retries (seconds)")
    add("--data-skip-budget", default=d.data_skip_budget, type=int, dest="data_skip_budget", help="skipped samples tolerated per epoch before the loader fails loudly (0 = strict)")
    _bool_flag(p, "telemetry", d.telemetry, "write events.<rank>.jsonl + heartbeats (python -m tpudist.summarize <outpath> reads them)")
    _bool_flag(p, "telemetry_mfu", d.telemetry_mfu, "per-step MFU: the port reports none yet (no compiled cost analysis)")
    add("--metrics-port", default=d.metrics_port, type=int, dest="metrics_port", help="with --telemetry: serve live Prometheus metrics (step p50/p95, phase breakdown, goodput, fault counters, heartbeat age; tpudist's metric names) on this port; 0 = pick a free port (written to <outpath>/metrics.<rank>.port); -1 = off")
    add("--telemetry-max-mb", default=d.telemetry_max_mb, type=float, dest="telemetry_max_mb", help="roll events.<rank>.jsonl to events.<rank>.1.jsonl past this size (MB; bounds long-run telemetry at ~2x the cap; 0 = uncapped)")
    add("--profile", default=d.profile, help="torch.profiler trace of the global step window 'start:end' (or one step 'n'; '' = off): a Chrome trace under <outpath>/profile/attempt_<n>/, CPU and, on the card, CUDA activity")
    _bool_flag(p, "doctor", d.doctor, "guarded train step + detect-respond policies: finiteness sentinels on the card with a skip-step (the update undone by a select, no host read), EWMA loss-spike detection on the drained metrics, rollback-to-last-verified-good with data-order replay, SDC self-quarantine (exit 76)")
    add("--doctor-probe-freq", default=d.doctor_probe_freq, type=int, dest="doctor_probe_freq", help="with --doctor: digest the replicated state and compare across ranks every N steps (silent-data-corruption probe; stamps checkpoint verdicts good/suspect; 0 = off)")
    add("--doctor-spike-sigma", default=d.doctor_spike_sigma, type=float, dest="doctor_spike_sigma", help="EWMA loss-spike threshold in sigmas above the running mean")
    add("--doctor-spike-min-steps", default=d.doctor_spike_min_steps, type=int, dest="doctor_spike_min_steps", help="EWMA warmup steps before a spike can fire")
    add("--doctor-max-skips", default=d.doctor_max_skips, type=int, dest="doctor_max_skips", help="consecutive non-finite (skipped) steps before the doctor escalates to a rollback")
    add("--doctor-max-rollbacks", default=d.doctor_max_rollbacks, type=int, dest="doctor_max_rollbacks", help="rollbacks tolerated per run before failing loudly")
    add("--doctor-sdc-windows", default=d.doctor_sdc_windows, type=int, dest="doctor_sdc_windows", help="consecutive minority-divergent SDC probes before a rank self-quarantines (exit 76)")
    _bool_flag(p, "blackbox", d.blackbox, "flight recorder: ring-buffer the last N telemetry samples per rank and, on an anomaly trigger (doctor, SDC divergence, fault, preempt, SIGUSR2, POST /capture), dump the ring and arm a one-shot bounded torch.profiler trace; requires --telemetry")
    add("--blackbox-ring", default=d.blackbox_ring, type=int, dest="blackbox_ring", help="flight-recorder ring depth (events kept per rank)")
    add("--blackbox-capture-steps", default=d.blackbox_capture_steps, type=int, dest="blackbox_capture_steps", help="deep-capture profiler trace length, in steps")
    add("--blackbox-cooldown-s", default=d.blackbox_cooldown_s, type=float, dest="blackbox_cooldown_s", help="per-trigger-class cooldown: within it a repeat trigger emits an incident event but dumps/captures nothing (storm bound)")
    add("--replica-check-freq", default=d.replica_check_freq, type=int, dest="replica_check_freq", help="verify the replicated state is identical on every data-parallel rank every N epochs (0 = off)")
    add("--stall-timeout", default=d.stall_timeout, type=float, dest="stall_timeout", help="abort the process (exit 117) if no training step completes for N seconds (0 = off); the kernels are built before it starts")
    add("--require-platform", default=d.require_platform, dest="require_platform", choices=("any", "tpu", "cpu"), help=not_yet)
    add("--overwrite", default=d.overwrite, choices=["prompt", "delete", "quit", "keep"], help="what to do if outpath exists")
    add("--num-classes", default=d.num_classes, type=int, dest="num_classes")
    add("--image-size", default=d.image_size, type=int, dest="image_size")
    add("--mesh-shape", default=None, dest="mesh_shape", help=not_yet)
    add("--mesh-axes", default=",".join(d.mesh_axes), dest="mesh_axes", help=not_yet)
    _bool_flag(p, "zero_opt", d.zero_opt, not_yet)
    add("--zero", default=d.zero, choices=("off", "1", "full"), help=not_yet)
    add("--compress-grads", default=d.compress_grads, dest="compress_grads", choices=("off", "int8", "auto"), help=not_yet)
    _bool_flag(p, "distributed", d.distributed, "data-parallel training: join the process group (NCCL on the card, gloo on the CPU) and train under DDP; python -m tpudist_torch.launch starts the ranks")
    add("--coordinator-address", default=None, dest="coordinator_address", help="host:port of rank 0's rendezvous (default: env TPUDIST_COORDINATOR)")
    add("--num-processes", default=None, type=int, dest="num_processes", help="world size (default: env TPUDIST_NUM_PROCESSES)")
    add("--process-id", default=None, type=int, dest="process_id", help="this rank (default: env TPUDIST_PROCESS_ID)")
    add("--device", default=d.device, choices=("cuda", "cpu"), help="where the trainer runs (default cuda; there is no fallback to the CPU)")
    return p


def from_args(argv: Sequence[str] | None = None) -> Config:
    ns = build_parser().parse_args(argv)
    cfg = Config()
    for f in dataclasses.fields(Config):
        if hasattr(ns, f.name):
            setattr(cfg, f.name, getattr(ns, f.name))
    cfg.step = parse_milestones(cfg.step)
    if isinstance(cfg.mesh_shape, str):
        cfg.mesh_shape = [int(x) for x in cfg.mesh_shape.split(",")]
    if isinstance(cfg.mesh_axes, str):
        cfg.mesh_axes = [a for a in cfg.mesh_axes.split(",") if a]
    return cfg


def write_settings(cfg: Config, outpath: str) -> None:
    """Dump every config k/v to ``settings.log``."""
    with open(os.path.join(outpath, "settings.log"), "w") as f:
        for k, v in cfg.asdict().items():
            f.write(f"{k}: {v}\n")
