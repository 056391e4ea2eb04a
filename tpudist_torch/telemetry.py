"""Structured run events, goodput accounting and heartbeats for the port.

The port's copy of the part of ``tpudist/telemetry.py`` that serving,
the trainer and the launcher use. Events are byte-compatible with the JAX
package's: the same envelope (``t``/``type``/``rank``/``attempt``), the
same required fields per type and the same ``events.<rank>.jsonl`` and
``heartbeats/rank<r>.json`` files, one of each per rank of a
data-parallel run (the launcher's stream is ``events.launcher.jsonl``),
so ``python -m tpudist.summarize <outpath>`` reads a port run.

- ``--telemetry-max-mb``: past the cap the live file rolls to
  ``events.<rank>.1.jsonl`` (replacing the previous rollover), tpudist's
  names, so a reader that globs ``events.*.jsonl`` reads both.
- ``add_sink``: an observer of every persisted event (the live metrics
  registry of ``obs/server.py``).
- ``read_heartbeats`` / ``find_stragglers``: the launcher's straggler
  detection over the ranks' heartbeat files (``host_p50``, the per-step
  host time outside the card's work, is the signal).
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import deque
from typing import Iterable, Optional

HEARTBEAT_DIRNAME = "heartbeats"
HEARTBEAT_INTERVAL_S = 0.5

# Required fields PER TYPE, beyond the common envelope (t/type/rank/attempt).
# Extra fields are always allowed; missing required fields raise at emit time.
SCHEMA: dict[str, tuple[str, ...]] = {
    "run_start": ("platform", "n_devices", "arch", "global_batch"),
    "step": ("step", "epoch", "data_s", "h2d_s", "compute_s", "drain_s",
             "step_s"),
    "compile": ("seconds", "phase"),
    "epoch": ("epoch", "seconds"),
    "eval": ("epoch", "seconds"),
    "checkpoint_save": ("seconds", "kind"),
    "checkpoint_restore": ("seconds", "path"),
    # One per injected fault that fired, and per quarantined checkpoint.
    "fault": ("point",),
    # One per preemption drain: the signal the trainer caught.
    "preempt": ("signal",),
    # The doctor (doctor/): one per intervention, ``action`` in
    # {skip_step, spike, sdc_divergence, rollback, evict}, with its
    # evidence; one ``sdc_probe`` per digest probe.
    "doctor": ("action",),
    "sdc_probe": ("step", "world", "divergent"),
    # The flight recorder (blackbox.py): one per trigger, on the rank and
    # from the launcher's bundler (which adds ``bundle``).
    "incident": ("trigger", "suspect_rank", "captured"),
    # Which attention backend --flash resolved to. One per ViT trainer.
    "attention_dispatch": ("kernel", "mode", "source"),
    # Which BN epilogue --fused-bn resolved to. One per trainer.
    "fused_norm_dispatch": ("kernel", "mode", "source"),
    # One per replica startup: the warm-up wall of the bucket set.
    "serve_start": ("n_buckets", "aot_s", "cache"),
    # One per completed request: submit → result latency.
    "request": ("latency_s",),
    # One per bucket call the batcher made.
    "serve_batch": ("bucket", "n_valid", "batch_s"),
    "run_end": ("wall_s", "productive_s", "goodput"),
    # The launcher's own stream (rank -1, events.launcher.jsonl).
    "launcher_start": ("nprocs",),
    "rank_exit": ("code", "classification"),
    "restart": (),
    "straggler": ("straggler_rank", "factor"),
}

# Fields that must be numeric when present (timings and accounting).
_NUMERIC = {"t", "rank", "attempt", "step", "epoch", "seconds", "code",
            "nprocs", "n_devices", "global_batch", "straggler_rank",
            "factor", "wall_s", "productive_s", "goodput", "n_sites",
            "n_fused", "n_buckets", "bucket", "n_valid", "queue_depth",
            "n_requests", "n_images", "image_size", "steps", "world",
            "windows", "suspect_rank", "gnorm", "loss", "mean", "std",
            "sigmas", "divergent", "tie", "divergent_rank", "to_epoch",
            "rollbacks", "window_epoch", "window_start", "window_end",
            "consecutive_skips", "captured", "ring_rows"}


def validate_event(ev: dict) -> None:
    """Raise ValueError unless ``ev`` is a schema-valid telemetry event."""
    for k in ("t", "type", "rank", "attempt"):
        if k not in ev:
            raise ValueError(f"telemetry event missing common field {k!r}: "
                             f"{ev!r}")
    etype = ev["type"]
    if etype not in SCHEMA:
        raise ValueError(f"unknown telemetry event type {etype!r}: {ev!r}")
    missing = [k for k in SCHEMA[etype] if k not in ev]
    if missing:
        raise ValueError(f"telemetry {etype!r} event missing {missing}: "
                         f"{ev!r}")
    for k, v in ev.items():
        if (k in _NUMERIC or k.endswith("_s")) and v is not None \
                and not isinstance(v, (int, float)):
            raise ValueError(f"telemetry field {k!r} must be numeric, got "
                             f"{type(v).__name__}: {ev!r}")
        if isinstance(v, float) and not math.isfinite(v):
            raise ValueError(f"telemetry field {k!r} is not finite: {ev!r}")


def events_path(outpath: str, rank) -> str:
    """``events.<rank>.jsonl`` under the run dir (``rank`` may be the
    string ``'launcher'`` for the launcher's stream)."""
    return os.path.join(outpath, f"events.{rank}.jsonl")


def percentile(xs: Iterable[float], q: float) -> float:
    """Linear-interpolated percentile (q in [0, 100]) of a non-empty
    iterable."""
    s = sorted(xs)
    if not s:
        raise ValueError("percentile of empty sequence")
    if len(s) == 1:
        return s[0]
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


_current: Optional["Telemetry"] = None


def set_current(tel: Optional["Telemetry"]) -> None:
    """The process's live stream (the trainer's), for emitters that hold
    no handle: the checkpoint quarantine's ``fault`` event. None clears
    it."""
    global _current
    _current = tel


def current() -> Optional["Telemetry"]:
    return _current


def env_attempt() -> int:
    """The launcher's restart counter (``TPUDIST_RESTART_COUNT``), 0 when
    unset or malformed."""
    try:
        return int(os.environ.get("TPUDIST_RESTART_COUNT", 0))
    except ValueError:
        return 0


class Telemetry:
    """Per-rank structured event stream + goodput accounting + heartbeat.

    Thread-safe emit (the batcher's loop thread and the loader's threads
    emit); every line is flushed on write."""

    def __init__(self, outpath: str, rank: int = 0, init_s: float = 0.0,
                 attempt: Optional[int] = None, name=None,
                 heartbeat: bool = True,
                 heartbeat_interval_s: float = HEARTBEAT_INTERVAL_S,
                 max_mb: float = 256.0):
        """``init_s``: seconds spent before this object existed
        (``dist.initialize_runtime``); ``wall_s`` and ``run_end`` count
        them, as tpudist's pending ``init`` phase. ``name`` replaces the
        rank in the file name (the launcher's ``'launcher'``);
        ``max_mb`` <= 0 leaves the file uncapped."""
        self.outpath = outpath
        self.rank = rank
        self.attempt = env_attempt() if attempt is None else attempt
        self.init_s = float(init_s)
        os.makedirs(outpath, exist_ok=True)
        self.path = events_path(outpath, name if name is not None else rank)
        self._f = open(self.path, "a", buffering=1)
        self._lock = threading.Lock()
        self._t0 = time.time()
        # Rotation: the byte count is kept from the lines written (no stat
        # an emit); past the cap the live file rolls to the rotated name.
        self._max_bytes = max(1, int(max_mb * 2**20)) \
            if max_mb and max_mb > 0 else 0
        try:
            self._bytes = os.path.getsize(self.path)
        except OSError:
            self._bytes = 0
        # Observers of every persisted event; a failing sink never costs
        # an event.
        self._sinks: list = []
        # goodput buckets (seconds)
        self.compile_s = 0.0
        self.checkpoint_s = 0.0
        self.eval_s = 0.0
        self.productive_s = 0.0
        self.data_s = 0.0
        self.h2d_s = 0.0
        self.drain_s = 0.0
        self.prefetch_s = 0.0
        self.drain_ovl_s = 0.0
        self.steps = 0
        self._recent: deque[tuple[float, float]] = deque(maxlen=64)
        self._hb_path = None
        self._hb_interval = heartbeat_interval_s
        self._hb_last_write = 0.0
        self._last_step: Optional[int] = None
        if heartbeat and isinstance(rank, int) and rank >= 0:
            hb_dir = os.path.join(outpath, HEARTBEAT_DIRNAME)
            os.makedirs(hb_dir, exist_ok=True)
            self._hb_path = os.path.join(hb_dir, f"rank{rank}.json")

    def add_sink(self, fn) -> None:
        """Register ``fn(event)``, called after each line is persisted;
        its exceptions are swallowed."""
        self._sinks.append(fn)

    def rotated_path(self) -> str:
        base, ext = self.path.rsplit(".jsonl", 1)
        return f"{base}.1.jsonl{ext}"

    def _maybe_rotate_locked(self) -> None:
        if not self._max_bytes or self._bytes < self._max_bytes:
            return
        try:
            self._f.close()
            os.replace(self.path, self.rotated_path())
            self._f = open(self.path, "a", buffering=1)
            self._bytes = 0
        except OSError:
            # Best-effort: keep appending rather than lose events.
            if self._f.closed:
                self._f = open(self.path, "a", buffering=1)

    def emit(self, etype: str, **fields) -> dict:
        ev = {"t": time.time(), "type": etype, "rank": self.rank,
              "attempt": self.attempt}
        ev.update(fields)
        validate_event(ev)
        line = json.dumps(ev)
        with self._lock:
            if not self._f.closed:
                self._f.write(line + "\n")
                self._f.flush()
                self._bytes += len(line) + 1
                self._maybe_rotate_locked()
        for sink in self._sinks:
            try:
                sink(ev)
            except Exception:
                pass
        return ev

    def note_compile(self, seconds: float, phase: str, **extra) -> None:
        self.compile_s += seconds
        self.emit("compile", seconds=round(seconds, 6), phase=phase, **extra)

    def note_checkpoint(self, seconds: float, kind: str, **extra) -> None:
        self.checkpoint_s += seconds
        self.emit("checkpoint_save", seconds=round(seconds, 6), kind=kind,
                  **extra)

    def note_restore(self, seconds: float, path: str, **extra) -> None:
        self.checkpoint_s += seconds
        self.emit("checkpoint_restore", seconds=round(seconds, 6), path=path,
                  **extra)

    def note_eval(self, seconds: float, epoch: int, **extra) -> None:
        self.eval_s += seconds
        self.emit("eval", seconds=round(seconds, 6), epoch=epoch, **extra)

    def step(self, *, step: int, epoch: int, data_s: float, h2d_s: float,
             compute_s: float, drain_s: float, step_s: float,
             compile_s: float = 0.0, prefetch_s: Optional[float] = None,
             drain_ovl_s: Optional[float] = None) -> dict:
        """One training step, tpudist's accounting: ``compile_s`` > 0 (the
        first step: kernel loading and library warm-up) moves out of the
        productive total into the compile bucket, with a ``compile`` event
        beside the step event; ``prefetch_s``/``drain_ovl_s`` are host
        work overlapped with the card's compute and never count as host
        overhead."""
        if compile_s > 0.0:
            self.compile_s += compile_s
            self.emit("compile", seconds=round(compile_s, 6),
                      phase="train_step", step=step)
        self.productive_s += max(0.0, step_s - compile_s)
        self.data_s += data_s
        self.h2d_s += h2d_s
        self.drain_s += drain_s
        self.prefetch_s += prefetch_s or 0.0
        self.drain_ovl_s += drain_ovl_s or 0.0
        self.steps += 1
        if compile_s <= 0.0:
            host_s = max(0.0, step_s - compute_s - (prefetch_s or 0.0)
                         - (drain_ovl_s or 0.0))
            self._recent.append((step_s, host_s))
        fields = dict(step=step, epoch=epoch, data_s=round(data_s, 6),
                      h2d_s=round(h2d_s, 6), compute_s=round(compute_s, 6),
                      drain_s=round(drain_s, 6), step_s=round(step_s, 6))
        if prefetch_s is not None:
            fields["prefetch_s"] = round(prefetch_s, 6)
        if drain_ovl_s is not None:
            fields["drain_ovl_s"] = round(drain_ovl_s, 6)
        ev = self.emit("step", **fields)
        self._last_step = step
        self._write_heartbeat(step)
        return ev

    def beat(self, step: int) -> None:
        """Serving-plane liveness: refresh the heartbeat file (at most every
        ``HEARTBEAT_INTERVAL_S``)."""
        self._last_step = step
        self._write_heartbeat(step)

    def _write_heartbeat(self, step: int, force: bool = False) -> None:
        if self._hb_path is None:
            return
        now = time.time()
        if not force and now - self._hb_last_write < self._hb_interval:
            return
        self._hb_last_write = now
        beat = {"rank": self.rank, "attempt": self.attempt, "step": step,
                "n": len(self._recent), "updated_at": time.time()}
        if self._recent:
            steps = [s for s, _ in self._recent]
            hosts = [h for _, h in self._recent]
            beat.update(step_p50=round(percentile(steps, 50), 6),
                        step_p95=round(percentile(steps, 95), 6),
                        host_p50=round(percentile(hosts, 50), 6))
        tmp = self._hb_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(beat, f)
            os.replace(tmp, self._hb_path)
        except OSError:
            pass                       # heartbeats are best-effort telemetry

    def wall_s(self) -> float:
        """Wall time of the run so far, the init phase included."""
        return time.time() - self._t0 + self.init_s

    def close(self, **extra) -> Optional[dict]:
        """Emit the ``run_end`` goodput summary and close the stream."""
        if self._f.closed:
            return None
        if self._last_step is not None:
            self._write_heartbeat(self._last_step, force=True)
        wall = max(self.wall_s(), 1e-9)
        ev = self.emit(
            "run_end", wall_s=round(wall, 3),
            productive_s=round(self.productive_s, 3),
            goodput=round(min(1.0, self.productive_s / wall), 4),
            init_s=round(self.init_s, 3), compile_s=round(self.compile_s, 3),
            checkpoint_s=round(self.checkpoint_s, 3), eval_s=round(self.eval_s, 3),
            data_wait_s=round(self.data_s, 3), h2d_s=round(self.h2d_s, 3),
            drain_s=round(self.drain_s, 3),
            **({"prefetch_s": round(self.prefetch_s, 3)}
               if self.prefetch_s else {}),
            **({"drain_ovl_s": round(self.drain_ovl_s, 3)}
               if self.drain_ovl_s else {}),
            steps=self.steps, **extra)
        with self._lock:
            self._f.close()
        return ev


# -- straggler detection -------------------------------------------------------

def heartbeat_dir(outpath: str) -> str:
    return os.path.join(outpath, HEARTBEAT_DIRNAME)


def read_heartbeats(dirpath: str) -> dict[int, dict]:
    """All parseable ``rank<r>.json`` beats, keyed by rank; a torn or
    garbage file is skipped."""
    beats: dict[int, dict] = {}
    try:
        names = os.listdir(dirpath)
    except OSError:
        return beats
    for fn in names:
        if not (fn.startswith("rank") and fn.endswith(".json")):
            continue
        try:
            with open(os.path.join(dirpath, fn)) as f:
                b = json.load(f)
            beats[int(b["rank"])] = b
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return beats


def find_stragglers(beats: dict[int, dict], factor: float = 4.0,
                    min_host_s: float = 0.05, min_steps: int = 2,
                    attempt: Optional[int] = None,
                    max_age_s: float = 60.0) -> list[dict]:
    """Ranks whose per-step host overhead (``host_p50``) is more than
    ``factor`` times the median of the OTHER ranks' (so a 2-rank fleet is
    decidable), tpudist's rule. ``min_host_s`` is an absolute floor
    against jitter; ``attempt``/``max_age_s`` drop beats of an earlier
    attempt."""
    now = time.time()
    live = {}
    for rank, b in beats.items():
        if b.get("n", 0) < min_steps or "host_p50" not in b:
            continue
        if attempt is not None and b.get("attempt") != attempt:
            continue
        if now - b.get("updated_at", 0.0) > max_age_s:
            continue
        live[rank] = b
    if len(live) < 2:
        return []
    out = []
    for rank, b in sorted(live.items()):
        others = [o["host_p50"] for r, o in live.items() if r != rank]
        med = percentile(others, 50)
        host = b["host_p50"]
        if host >= min_host_s and host > factor * max(med, 1e-4):
            out.append({"straggler_rank": rank,
                        "host_p50_s": round(host, 6),
                        "median_others_s": round(med, 6),
                        "factor": round(host / max(med, 1e-4), 2),
                        "step": b.get("step")})
    return out
