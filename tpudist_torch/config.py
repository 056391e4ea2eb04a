"""Run configuration: tpudist's flag surface as a typed dataclass.

The port's copy of ``tpudist/config.py``: the same flag names and
defaults (``build_parser``), so one command line means the same thing to
both trainers, plus ``--device {cuda,cpu}`` (default cuda; nothing falls
back to the CPU). Two defaults differ until the port has the pieces
behind them: ``--fused-bn`` is ``on`` (the dispatch layer behind ``auto``,
``ops/norm_dispatch``, is not ported) and checkpoints are not written.

Every flag the port does not support yet is refused at startup by
``refuse_unsupported``, with a message that names it, rather than ignored.
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
    fused_bn: str = "on"
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
        """Derive the per-device batch from the global batch and check the
        values tpudist checks."""
        self.nprocs = num_devices
        self.per_device_batch_size = max(1, self.batch_size // num_devices)
        self.batch_size = self.per_device_batch_size * num_devices
        if self.synthetic_size < 0:
            raise ValueError(f"--synthetic-size must be >= 0, "
                             f"got {self.synthetic_size}")
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
        if self.val_resize < self.image_size:
            raise ValueError(
                f"--val-resize {self.val_resize} must be >= --image-size "
                f"{self.image_size} (the val stack resizes the shorter edge, "
                f"then center-crops image_size)")
        if isinstance(self.step, str):
            self.step = parse_milestones(self.step)
        return self

    def asdict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


# The attention archs the trainer takes (models/__init__.py registers them).
VIT_ARCHS = ("vit_b_16", "vit_b_32", "vit_l_16", "vit_l_32", "vit_h_14")

# Flags the port does not support yet: a value other than the default is
# refused at startup, naming the flag and what is missing.
_NOT_YET = {
    "pretrained": ("--pretrained", "torchvision weights (compat/)"),
    "pretrained_path": ("--pretrained-path", "torchvision weights (compat/)"),
    "accum_steps": ("--accum-steps", "gradient accumulation"),
    "microbatches": ("--microbatches", "pipeline parallelism"),
    "model_ema_decay": ("--model-ema-decay", "the parameter EMA"),
    "mixup_alpha": ("--mixup-alpha", "ops/mixup.mix_batch"),
    "cutmix_alpha": ("--cutmix-alpha", "ops/mixup.mix_batch"),
    "auto_augment": ("--auto-augment", "the ImageFolder transforms"),
    "random_erase": ("--random-erase", "the ImageFolder transforms"),
    "amp_dtype": ("--amp-dtype", "float16 loss scaling (bfloat16 is ported)"),
    "sync_batchnorm": ("--sync_batchnorm", "SyncBN"),
    "remat": ("--remat", "block checkpointing"),
    "compile_cache": ("--compile-cache", "a persistent compile cache"),
    "resume": ("--resume", "checkpoint.py (the msgpack format)"),
    "torch_checkpoints": ("--torch_checkpoints", "checkpoint.py"),
    "checkpoint_backend": ("--checkpoint-backend", "checkpoint.py"),
    "keep_checkpoints": ("--keep-checkpoints", "checkpoint.py"),
    "inject": ("--inject", "fault injection (faults.py)"),
    "data_retries": ("--data-retries", "the loader's retry path"),
    "data_retry_backoff": ("--data-retry-backoff", "the loader's retry path"),
    "data_skip_budget": ("--data-skip-budget", "the loader's skip path"),
    "metrics_port": ("--metrics-port", "the metrics endpoint (obs/server.py)"),
    "telemetry_max_mb": ("--telemetry-max-mb", "event-file rotation"),
    "profile": ("--profile", "the trace window"),
    "doctor": ("--doctor", "the doctor plane"),
    "doctor_probe_freq": ("--doctor-probe-freq", "the doctor plane"),
    "doctor_spike_sigma": ("--doctor-spike-sigma", "the doctor plane"),
    "doctor_spike_min_steps": ("--doctor-spike-min-steps",
                               "the doctor plane"),
    "doctor_max_skips": ("--doctor-max-skips", "the doctor plane"),
    "doctor_max_rollbacks": ("--doctor-max-rollbacks", "the doctor plane"),
    "doctor_sdc_windows": ("--doctor-sdc-windows", "the doctor plane"),
    "blackbox": ("--blackbox", "the flight recorder"),
    "blackbox_ring": ("--blackbox-ring", "the flight recorder"),
    "blackbox_capture_steps": ("--blackbox-capture-steps",
                               "the flight recorder"),
    "blackbox_cooldown_s": ("--blackbox-cooldown-s", "the flight recorder"),
    "replica_check_freq": ("--replica-check-freq", "the data-parallel plane"),
    "stall_timeout": ("--stall-timeout", "the watchdog"),
    "require_platform": ("--require-platform", "a jax platform check "
                         "(the port's is --device)"),
    "mesh_shape": ("--mesh-shape", "the parallelism plane"),
    "mesh_axes": ("--mesh-axes", "the parallelism plane"),
    "zero_opt": ("--zero_opt", "ZeRO weight-update sharding"),
    "zero": ("--zero", "ZeRO weight-update sharding"),
    "compress_grads": ("--compress-grads", "gradient compression"),
    "distributed": ("--distributed", "dist.py (NCCL)"),
    "coordinator_address": ("--coordinator-address", "dist.py (NCCL)"),
    "num_processes": ("--num-processes", "dist.py (NCCL)"),
    "process_id": ("--process-id", "dist.py (NCCL)"),
}


def refuse_unsupported(cfg: Config) -> None:
    """Raise ``ValueError`` naming every flag set to something the port
    cannot do yet."""
    default = Config()
    bad = [f"{flag} ({what} is not in the port yet)"
           for name, (flag, what) in _NOT_YET.items()
           if getattr(cfg, name) != getattr(default, name)]
    vit = cfg.arch in VIT_ARCHS
    if not (vit or cfg.arch.startswith(("resnet", "resnext",
                                         "wide_resnet"))):
        bad.append(f"-a {cfg.arch} (the port trains the resnet and vit "
                   f"families so far)")
    if cfg.fused_bn == "auto":
        bad.append("--fused-bn auto (the measurement dispatch, "
                   "ops/norm_dispatch, is not in the port yet; pass on or "
                   "off)")
    if vit and cfg.flash == "auto":
        bad.append(f"--flash auto (the measurement dispatch, "
                   f"ops/attention_dispatch, is not in the port yet; pass "
                   f"--flash on|off for -a {cfg.arch})")
    if not vit and cfg.flash == "on":
        bad.append(f"--flash on (it applies to attention archs (vit*); got "
                   f"'{cfg.arch}')")
    if cfg.data and not cfg.synthetic:
        bad.append("--data (ImageFolder data is not in the port yet; pass "
                   "--synthetic)")
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
    add("--data", metavar="DIR", default=d.data, help="ImageFolder root; " + not_yet)
    add("-a", "--arch", metavar="ARCH", default=d.arch, help="model architecture (tpudist_torch.models registry)")
    add("-j", "--workers", default=d.workers, type=int, metavar="N", help="data-loading worker threads")
    add("--epochs", default=d.epochs, type=int, metavar="N", help="number of total epochs to run")
    add("--step", default=list(d.step), metavar="step decay", help="lr decay milestones, e.g. '3,4'")
    add("--start-epoch", default=d.start_epoch, type=int, metavar="N", dest="start_epoch", help="first epoch (offsets the schedule)")
    add("-b", "--batch-size", default=d.batch_size, type=int, metavar="N", dest="batch_size", help="GLOBAL batch size")
    add("--accum-steps", default=d.accum_steps, type=int, dest="accum_steps", help=not_yet)
    add("--microbatches", default=d.microbatches, type=int, help=not_yet)
    add("--lr", "--learning-rate", default=d.lr, type=float, metavar="LR", dest="lr", help="initial learning rate")
    add("--momentum", default=d.momentum, type=float, metavar="M", help="momentum")
    add("--wd", "--weight-decay", default=d.weight_decay, type=float, metavar="W", dest="weight_decay", help="weight decay")
    add("-p", "--print-freq", default=d.print_freq, type=int, metavar="N", dest="print_freq", help="print frequency")
    _bool_flag(p, "evaluate", d.evaluate, "evaluate the model on the validation set only")
    _bool_flag(p, "pretrained", d.pretrained, not_yet)
    add("--pretrained-path", default=d.pretrained_path, dest="pretrained_path", help=not_yet)
    _bool_flag(p, "use_amp", d.use_amp, "bf16 compute policy (f32 master weights)")
    add("--amp-dtype", default=d.amp_dtype, dest="amp_dtype", choices=("bfloat16", "float16"), help="--use_amp compute dtype; float16 is " + not_yet)
    _bool_flag(p, "sync_batchnorm", d.sync_batchnorm, not_yet)
    _bool_flag(p, "remat", d.remat, not_yet)
    add("--flash", default=d.flash, choices=("auto", "on", "off"), help="attention kernel for vit archs: on = the hand-written CUDA flash-attention kernels (forward, dQ and dKV), off = plain attention; auto is " + not_yet + " (no-op for the conv nets; on is refused for them)")
    add("--fused-bn", default=d.fused_bn, dest="fused_bn", choices=("auto", "on", "off"), help="on (the port's default) = the hand-written CUDA BN+ReLU / BN+add+ReLU epilogue kernels in train mode; off = the plain epilogue; auto is " + not_yet)
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
    add("--model-ema-decay", default=d.model_ema_decay, type=float, dest="model_ema_decay", help=not_yet)
    add("--mixup-alpha", default=d.mixup_alpha, type=float, dest="mixup_alpha", help=not_yet)
    add("--cutmix-alpha", default=d.cutmix_alpha, type=float, dest="cutmix_alpha", help=not_yet)
    add("--auto-augment", default=d.auto_augment, choices=("", "ra", "ta_wide"), dest="auto_augment", help=not_yet)
    add("--random-erase", default=d.random_erase, type=float, dest="random_erase", help=not_yet)
    add("--synthetic-size", default=d.synthetic_size, type=int, dest="synthetic_size", help="synthetic train-set size (0 = auto; val set is half)")
    add("--val-resize", default=d.val_resize, type=int, dest="val_resize", help="val shorter-edge resize before the center crop")
    add("--gamma", default=d.gamma, type=float, metavar="gamma", help="lr decay factor")
    add("--resume", default=d.resume, help=not_yet)
    _bool_flag(p, "torch_checkpoints", d.torch_checkpoints, not_yet)
    add("--checkpoint-backend", default=d.checkpoint_backend, choices=["msgpack", "orbax"], dest="checkpoint_backend", help="no checkpoint is written by the port yet; orbax is " + not_yet)
    add("--keep-checkpoints", default=d.keep_checkpoints, type=int, dest="keep_checkpoints", help=not_yet)
    add("--inject", default=d.inject, help=not_yet)
    add("--data-retries", default=d.data_retries, type=int, dest="data_retries", help=not_yet)
    add("--data-retry-backoff", default=d.data_retry_backoff, type=float, dest="data_retry_backoff", help=not_yet)
    add("--data-skip-budget", default=d.data_skip_budget, type=int, dest="data_skip_budget", help=not_yet)
    _bool_flag(p, "telemetry", d.telemetry, "write events.<rank>.jsonl + heartbeats (python -m tpudist.summarize <outpath> reads them)")
    _bool_flag(p, "telemetry_mfu", d.telemetry_mfu, "per-step MFU: the port reports none yet (no compiled cost analysis)")
    add("--metrics-port", default=d.metrics_port, type=int, dest="metrics_port", help=not_yet)
    add("--telemetry-max-mb", default=d.telemetry_max_mb, type=float, dest="telemetry_max_mb", help=not_yet)
    add("--profile", default=d.profile, help=not_yet)
    _bool_flag(p, "doctor", d.doctor, not_yet)
    add("--doctor-probe-freq", default=d.doctor_probe_freq, type=int, dest="doctor_probe_freq", help=not_yet)
    add("--doctor-spike-sigma", default=d.doctor_spike_sigma, type=float, dest="doctor_spike_sigma", help=not_yet)
    add("--doctor-spike-min-steps", default=d.doctor_spike_min_steps, type=int, dest="doctor_spike_min_steps", help=not_yet)
    add("--doctor-max-skips", default=d.doctor_max_skips, type=int, dest="doctor_max_skips", help=not_yet)
    add("--doctor-max-rollbacks", default=d.doctor_max_rollbacks, type=int, dest="doctor_max_rollbacks", help=not_yet)
    add("--doctor-sdc-windows", default=d.doctor_sdc_windows, type=int, dest="doctor_sdc_windows", help=not_yet)
    _bool_flag(p, "blackbox", d.blackbox, not_yet)
    add("--blackbox-ring", default=d.blackbox_ring, type=int, dest="blackbox_ring", help=not_yet)
    add("--blackbox-capture-steps", default=d.blackbox_capture_steps, type=int, dest="blackbox_capture_steps", help=not_yet)
    add("--blackbox-cooldown-s", default=d.blackbox_cooldown_s, type=float, dest="blackbox_cooldown_s", help=not_yet)
    add("--replica-check-freq", default=d.replica_check_freq, type=int, dest="replica_check_freq", help=not_yet)
    add("--stall-timeout", default=d.stall_timeout, type=float, dest="stall_timeout", help=not_yet)
    add("--require-platform", default=d.require_platform, dest="require_platform", choices=("any", "tpu", "cpu"), help=not_yet)
    add("--overwrite", default=d.overwrite, choices=["prompt", "delete", "quit", "keep"], help="what to do if outpath exists")
    add("--num-classes", default=d.num_classes, type=int, dest="num_classes")
    add("--image-size", default=d.image_size, type=int, dest="image_size")
    add("--mesh-shape", default=None, dest="mesh_shape", help=not_yet)
    add("--mesh-axes", default=",".join(d.mesh_axes), dest="mesh_axes", help=not_yet)
    _bool_flag(p, "zero_opt", d.zero_opt, not_yet)
    add("--zero", default=d.zero, choices=("off", "1", "full"), help=not_yet)
    add("--compress-grads", default=d.compress_grads, dest="compress_grads", choices=("off", "int8", "auto"), help=not_yet)
    _bool_flag(p, "distributed", d.distributed, not_yet)
    add("--coordinator-address", default=None, dest="coordinator_address", help=not_yet)
    add("--num-processes", default=None, type=int, dest="num_processes", help=not_yet)
    add("--process-id", default=None, type=int, dest="process_id", help=not_yet)
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
