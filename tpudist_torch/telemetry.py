"""Structured run events, goodput accounting and heartbeats for the port.

The port's copy of the part of ``tpudist/telemetry.py`` that serving and
the one-card trainer use. Events are byte-compatible with the JAX
package's: the same envelope (``t``/``type``/``rank``/``attempt``), the
same required fields per type and the same ``events.<rank>.jsonl`` and
``heartbeats/rank<r>.json`` files, so ``python -m tpudist.summarize
<outpath>`` reads a port run.
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
}

# Fields that must be numeric when present (timings and accounting).
_NUMERIC = {"t", "rank", "attempt", "step", "epoch", "seconds", "n_devices",
            "global_batch", "wall_s", "productive_s", "goodput", "n_sites",
            "n_fused", "n_buckets", "bucket", "n_valid", "queue_depth",
            "n_requests", "n_images", "image_size", "steps"}


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
    """``events.<rank>.jsonl`` under the run dir."""
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


def env_attempt() -> int:
    """The launcher's restart counter (``TPUDIST_RESTART_COUNT``), 0 when
    unset or malformed."""
    try:
        return int(os.environ.get("TPUDIST_RESTART_COUNT", 0))
    except ValueError:
        return 0


class Telemetry:
    """Per-rank structured event stream + goodput accounting + heartbeat.

    Thread-safe emit (the batcher's loop thread emits); every line is
    flushed on write."""

    def __init__(self, outpath: str, rank: int = 0):
        self.outpath = outpath
        self.rank = rank
        self.attempt = env_attempt()
        os.makedirs(outpath, exist_ok=True)
        self.path = events_path(outpath, rank)
        self._f = open(self.path, "a", buffering=1)
        self._lock = threading.Lock()
        self._t0 = time.time()
        # goodput buckets (seconds)
        self.compile_s = 0.0
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
        self._hb_last_write = 0.0
        self._last_step: Optional[int] = None
        if rank >= 0:
            hb_dir = os.path.join(outpath, HEARTBEAT_DIRNAME)
            os.makedirs(hb_dir, exist_ok=True)
            self._hb_path = os.path.join(hb_dir, f"rank{rank}.json")

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
        return ev

    def note_compile(self, seconds: float, phase: str, **extra) -> None:
        self.compile_s += seconds
        self.emit("compile", seconds=round(seconds, 6), phase=phase, **extra)

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
        if not force and now - self._hb_last_write < HEARTBEAT_INTERVAL_S:
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
        return time.time() - self._t0

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
            init_s=0.0, compile_s=round(self.compile_s, 3),
            checkpoint_s=0.0, eval_s=round(self.eval_s, 3),
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
