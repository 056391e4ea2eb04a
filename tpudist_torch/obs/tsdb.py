"""Fleet time-series recorder: the port's copy of ``tpudist/obs/tsdb.py``.

On the launcher's ~1 s supervision poll, one flat JSON row snapshots the
fleet's headline gauges (world/alive, straggler and supervision counters,
step/host percentiles from the heartbeats the poll already read, the
per-rank endpoint samples the background scrape already holds) into
``fleet_ts.<attempt>.jsonl`` beside the event streams, tpudist's file
and row format.

- No filesystem read of its own: a sample takes the poll's heartbeat dict
  and ``FleetMetrics.gauges()`` (memory); its one I/O is the append.
- Size-capped as the telemetry is: past the cap the live file rolls to
  ``fleet_ts.<attempt>.1.jsonl``, replacing the previous rollover.

Readers go through ``load_rows`` / ``latest_path`` / ``query`` (the
launcher's ``/dashboard``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Iterable, Optional

from tpudist_torch.telemetry import percentile

# Every numeric field a row may carry, in stable order. ``query`` accepts
# any subset; the dashboard's live panel iterates this for its panels.
SERIES_FIELDS: tuple[str, ...] = (
    "world", "alive", "stragglers", "restarts", "reforms", "evictions",
    "collective_deadlines", "rank_exits", "incidents", "step_p50_s",
    "step_p95_s",
    "host_p50_s", "heartbeat_age_s", "steps", "goodput", "mfu",
    "faults", "doctor", "queue_depth", "serve_requests", "serve_req_s",
    "serve_p50_s", "serve_p99_s",
)


def ts_path(rundir: str, attempt: int) -> str:
    """``fleet_ts.<attempt>.jsonl`` under the run dir — one file per
    launch attempt, mirroring ``events.<rank>.jsonl`` naming."""
    return os.path.join(rundir, f"fleet_ts.{int(attempt)}.jsonl")


def rotated_path(path: str) -> str:
    base, ext = path.rsplit(".jsonl", 1)
    return f"{base}.1.jsonl{ext}"


def _agg(vals: list, how: str) -> Optional[float]:
    xs = [float(v) for v in vals if isinstance(v, (int, float))]
    if not xs:
        return None
    if how == "sum":
        return sum(xs)
    if how == "max":
        return max(xs)
    if how == "mean":
        return sum(xs) / len(xs)
    return percentile(xs, 50)                       # "median"


def fleet_row(fleet=None, beats=None, attempt: Optional[int] = None,
              now: Optional[float] = None) -> dict:
    """One flat sample row from in-memory state only.

    ``fleet`` is a ``FleetMetrics`` (or anything with a ``gauges()``
    returning its counter/scrape snapshot); ``beats`` is the heartbeat
    dict the supervision poll already read. Either may be None (a
    launcher without fleet metrics still records heartbeat-derived
    series). All values numeric or absent — the row is schema-light by
    design: new gauges append as new keys without a migration.
    """
    now = time.time() if now is None else now
    row: dict = {"t": now}
    g = fleet.gauges() if fleet is not None else {}
    if attempt is None:
        attempt = g.get("attempt", 0)
    row["attempt"] = int(attempt)
    for k in ("world", "restarts", "reforms", "evictions",
              "collective_deadlines", "rank_exits", "stragglers",
              "incidents"):
        if k in g:
            row[k] = g[k]
    beats = beats or {}
    live = {r: b for r, b in beats.items()
            if b.get("attempt") in (None, attempt)}
    row["alive"] = len(live)
    if live:
        bs = list(live.values())
        for key, out, how in (("step_p50", "step_p50_s", "median"),
                              ("step_p95", "step_p95_s", "max"),
                              ("host_p50", "host_p50_s", "median")):
            v = _agg([b.get(key) for b in bs], how)
            if v is not None:
                row[out] = round(v, 6)
        ages = [now - b["updated_at"] for b in bs
                if isinstance(b.get("updated_at"), (int, float))]
        if ages:
            row["heartbeat_age_s"] = round(max(0.0, max(ages)), 3)
    samples = list(g.get("rank_samples", {}).values())
    if samples:
        for key, out, how in (("steps", "steps", "sum"),
                              ("goodput", "goodput", "mean"),
                              ("mfu", "mfu", "mean"),
                              ("faults", "faults", "sum"),
                              ("doctor", "doctor", "sum"),
                              ("queue_depth", "queue_depth", "sum"),
                              ("serve_requests", "serve_requests", "sum"),
                              ("serve_req_s", "serve_req_s", "sum"),
                              ("serve_p50", "serve_p50_s", "max"),
                              ("serve_p99", "serve_p99_s", "max")):
            v = _agg([s.get(key) for s in samples], how)
            if v is not None:
                row[out] = round(v, 6)
    return row


class FleetSeriesRecorder:
    """Append-only sampler for the launcher's supervision poll.

    Not thread-safe by contract: ``sample()`` is called from the single
    supervision loop. ``min_interval_s`` throttles below the poll rate
    (0 records every call — the poll itself is already ~1 s-gated).
    """

    def __init__(self, rundir: str, attempt: int = 0,
                 max_mb: float = 16.0, min_interval_s: float = 0.0):
        self.rundir = rundir
        self.attempt = int(attempt)
        self.path = ts_path(rundir, attempt)
        os.makedirs(rundir, exist_ok=True)
        self._f = open(self.path, "a", buffering=1)
        # <= 0 means UNCAPPED — same contract as Telemetry(max_mb=...).
        self._max_bytes = max(1, int(max_mb * 2**20)) \
            if max_mb and max_mb > 0 else 0
        try:
            self._bytes = os.path.getsize(self.path)
        except OSError:
            self._bytes = 0
        self._min_interval = min_interval_s
        self._last_t = 0.0

    def _maybe_rotate(self) -> None:
        if not self._max_bytes or self._bytes < self._max_bytes:
            return
        try:
            self._f.close()
            os.replace(self.path, rotated_path(self.path))
            self._f = open(self.path, "a", buffering=1)
            self._bytes = 0
        except OSError:
            # Best-effort, same as Telemetry: keep appending rather than
            # losing samples.
            if self._f.closed:
                self._f = open(self.path, "a", buffering=1)

    def sample(self, fleet=None, beats=None,
               now: Optional[float] = None) -> Optional[dict]:
        """Record one row; returns it (None when throttled/closed)."""
        now = time.time() if now is None else now
        if self._min_interval and now - self._last_t < self._min_interval:
            return None
        if self._f.closed:
            return None
        row = fleet_row(fleet, beats, attempt=self.attempt, now=now)
        line = json.dumps(row)
        self._f.write(line + "\n")
        self._bytes += len(line) + 1
        self._maybe_rotate()
        self._last_t = now
        return row

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


def load_rows(path: str) -> list[dict]:
    """All rows for one series file, rotated segment first (chronological),
    malformed lines skipped — a reader must survive a row the recorder was
    killed in the middle of writing."""
    rows: list[dict] = []
    for p in (rotated_path(path), path):
        try:
            with open(p, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        r = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if isinstance(r, dict) and isinstance(
                            r.get("t"), (int, float)):
                        rows.append(r)
        except OSError:
            continue
    return rows


def latest_path(rundir: str) -> Optional[str]:
    """The live series file of the HIGHEST attempt in a run dir (rotated
    segments excluded) — what an after-the-fact reader wants."""
    best, best_attempt = None, -1
    try:
        entries = os.listdir(rundir)
    except OSError:
        return None
    for name in entries:
        if not (name.startswith("fleet_ts.") and name.endswith(".jsonl")):
            continue
        mid = name[len("fleet_ts."):-len(".jsonl")]
        if not mid.isdigit():               # skips "3.1" rotated segments
            continue
        if int(mid) > best_attempt:
            best_attempt, best = int(mid), os.path.join(rundir, name)
    return best


def query(rows: Iterable[dict], window: Optional[float] = None,
          names: Optional[Iterable[str]] = None) -> dict[str, list]:
    """Pure projection of sample rows into per-series point lists.

    ``window`` keeps only rows within the trailing ``window`` seconds of
    the NEWEST row (no wall clock — same answer for a file read tomorrow);
    ``names`` selects fields (default: every SERIES_FIELDS key present).
    Returns ``{name: [(t, value), ...]}`` sorted by t, absent/non-numeric
    values dropped per-series.
    """
    rows = sorted((r for r in rows
                   if isinstance(r.get("t"), (int, float))),
                  key=lambda r: r["t"])
    if window is not None and rows:
        cutoff = rows[-1]["t"] - float(window)
        rows = [r for r in rows if r["t"] >= cutoff]
    if names is None:
        present: set[str] = set()
        for r in rows:
            present.update(r)
        names = [n for n in SERIES_FIELDS if n in present]
    out: dict[str, list] = {}
    for name in names:
        pts = [(r["t"], float(r[name])) for r in rows
               if isinstance(r.get(name), (int, float))]
        out[name] = pts
    return out
