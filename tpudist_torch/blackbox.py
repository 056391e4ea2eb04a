"""The flight recorder, anomaly-triggered deep capture and incident
bundles: the port's copy of ``tpudist/blackbox.py``.

- **Flight recorder** (``BlackboxRecorder``, ``--blackbox``): a rank's
  in-memory ring of its last N telemetry events of the types in
  ``_RING_TYPES``, fed as another ``Telemetry`` sink beside the metrics
  registry, so the hot loop gains no clock and no host read (one deque
  append a step).
- **Deep capture**: a trigger (a ``doctor`` event, a divergent
  ``sdc_probe``, a ``fault``, a ``preempt``, SIGUSR2 or ``POST /capture``
  on the rank's metrics endpoint) dumps the ring to
  ``<outpath>/blackbox/dump.<rank>.<seq>.json`` and arms a one-shot
  ``torch.profiler`` trace of the next ``--blackbox-capture-steps``
  steps into ``blackbox/capture.<rank>.<seq>/`` (``utils.profiling.
  Capture``; on the card it records the kernels). Each trigger class has
  its own cooldown: inside it a repeat trigger emits an ``incident``
  event and dumps nothing. While the ``--profile`` window holds the
  profiler the dump is kept and the trace skipped. The card has no
  optimized HLO, so a capture writes no ``optimized_hlo.txt``.
- **Incident bundler** (``IncidentBundler``, the launcher's side): on its
  supervision poll it gathers new rank dumps and its own fleet triggers
  (a nonzero rank exit, a straggler; eviction and the collective
  deadline once the port has them) that fall in one coalescing window
  into ``incidents/<id>/``: ``manifest.json``, the rank dumps,
  ``fleet_ts.jsonl`` (the launcher's series, ``obs.tsdb``) and
  ``events.jsonl`` (the causal chain), keeping the newest
  ``--incident-keep`` bundles under a size cap.
- **CLI**: ``python -m tpudist_torch.blackbox list|report <rundir>``.
  ``report --trace`` needs tpudist's ``obs/trace.py``, which the port
  does not have yet: refused by name.

Import-light: no torch at import (the launcher and the CLI import it);
the capture imports the profiler in the trainer's process.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import threading
import time
from collections import deque
from typing import Optional

BLACKBOX_DIRNAME = "blackbox"
INCIDENT_DIRNAME = "incidents"

# tpudist's trigger matrix. Rank-side classes fire inside
# the trainer process (through the telemetry sink or the manual surface);
# launcher-side classes fire in the supervisor; "gate" is emitted by the
# perf-CI runner on a regression/failed stage (no live job — event only).
RANK_TRIGGERS = ("doctor", "sdc", "fault", "preempt", "manual")
LAUNCHER_TRIGGERS = ("rank_exit", "straggler", "eviction",
                     "collective_deadline")
TRIGGER_CLASSES = RANK_TRIGGERS + LAUNCHER_TRIGGERS + ("gate",)

# Event types the ring records verbatim (full-resolution context around
# any trigger). Trigger-relevant types are ALSO ring-recorded so a dump
# shows the causal chain inline with the step samples.
_RING_TYPES = ("step", "compile", "epoch", "eval", "checkpoint_save",
               "checkpoint_restore", "doctor", "sdc_probe", "fault",
               "preempt")


def blackbox_dir(outpath: str) -> str:
    return os.path.join(outpath, BLACKBOX_DIRNAME)


def incidents_dir(rundir: str) -> str:
    return os.path.join(rundir, INCIDENT_DIRNAME)


def _trigger_class(ev: dict) -> Optional[str]:
    """Map a telemetry event to the trigger class it arms (None: not a
    trigger). ``sdc_probe`` triggers only on divergence/tie — clean
    probes are routine context, not anomalies."""
    et = ev.get("type")
    if et == "doctor":
        return "doctor"
    if et == "sdc_probe" and (ev.get("divergent") or ev.get("tie")):
        return "sdc"
    if et == "fault":
        return "fault"
    if et == "preempt":
        return "preempt"
    if et == "straggler":
        return "straggler"
    if et == "eviction":
        return "eviction"
    if et == "collective_deadline":
        return "collective_deadline"
    if et == "rank_exit" and ev.get("code"):
        return "rank_exit"
    return None


class BlackboxRecorder:
    """Per-rank flight recorder + one-shot deep-capture trigger engine.

    Registered as a ``Telemetry`` sink (``telemetry.add_sink(r.observe)``)
    exactly like ``MetricsRegistry``: ``observe`` sees every schema-valid
    event AFTER it is persisted, outside the emit lock, so re-emitting an
    ``incident`` event from a trigger path cannot deadlock. Per-step cost
    is one deque append; triggers (rare by definition) pay the dump I/O.

    ``poll(global_step)`` must be called once per training step beside
    ``StepProfiler.step`` — it consumes the armed capture request (starts
    the bounded ``torch.profiler`` trace; ``cuda`` adds the card's
    activity) and the manual-capture flag set by SIGUSR2 / ``POST
    /capture``. The idle-path cost is two attribute checks: no lock, no
    clock.
    """

    def __init__(self, outpath: str, rank: int = 0, ring: int = 256,
                 capture_steps: int = 8, cooldown_s: float = 120.0,
                 telemetry=None, cuda: bool = False):
        self.outpath = outpath
        self.dir = blackbox_dir(outpath)
        self.rank = int(rank)
        self.capture_steps = max(1, int(capture_steps))
        self.cooldown_s = float(cooldown_s)
        self.telemetry = telemetry
        self.cuda = bool(cuda)
        self._ring: deque = deque(maxlen=max(8, int(ring)))
        self._lock = threading.Lock()
        self._last_capture: dict[str, float] = {}   # class -> monotonic
        self._counts: dict[str, int] = {}
        self._seq = 0
        # Plain attribute flags: the SIGUSR2 handler runs on the main
        # thread between bytecodes and must never touch a lock.
        self._armed: Optional[dict] = None
        self._manual = False
        self._capture = None           # utils.profiling.Capture while open
        self._capture_dir: Optional[str] = None
        self._capture_stop = 0
        self.traces: list[str] = []    # the capture traces written

    # -- telemetry sink (hot path) ----------------------------------------
    def observe(self, ev: dict) -> None:
        et = ev.get("type")
        if et in _RING_TYPES:
            with self._lock:
                self._ring.append(ev)
        cls = _trigger_class(ev)
        if cls is not None and cls in RANK_TRIGGERS:
            self.trigger(cls, step=ev.get("step"),
                         detail=str(ev.get("action") or ev.get("point")
                                    or ev.get("signal") or et))

    # -- manual surface ----------------------------------------------------
    def request_capture(self, source: str = "manual") -> None:
        """Arm a ``manual``-class trigger, consumed by the next ``poll``.
        Async-signal-safe: sets one flag, no locks, no I/O — shared by the
        SIGUSR2 handler and the rank MetricsServer's ``POST /capture``."""
        self._manual_source = source
        self._manual = True

    # -- trigger engine ----------------------------------------------------
    def trigger(self, cls: str, step=None, detail: str = "") -> Optional[str]:
        """Fire a trigger: always emits a schema-valid ``incident`` event;
        outside the per-class cooldown it also dumps the ring and arms the
        one-shot deep capture. Returns the dump path (None inside the
        cooldown)."""
        now = time.monotonic()
        with self._lock:
            self._counts[cls] = self._counts.get(cls, 0) + 1
            last = self._last_capture.get(cls)
            cooled = last is not None and now - last < self.cooldown_s
            if not cooled:
                self._last_capture[cls] = now
                self._seq += 1
                seq = self._seq
                ring = list(self._ring)
        if cooled:
            self._emit_incident(cls, step=step, captured=0, detail=detail)
            return None
        path = self._dump(cls, seq, ring, step=step, detail=detail)
        cap_dir = os.path.join(self.dir,
                               f"capture.{self.rank}.{seq}") if path else None
        if cap_dir is not None:
            # One-shot: a newer trigger before poll() consumed the previous
            # request simply replaces it — there is one profiler, and the
            # newest anomaly is the interesting one.
            self._armed = {"cls": cls, "dir": cap_dir, "seq": seq}
        self._emit_incident(cls, step=step, captured=1, detail=detail,
                            dump=os.path.basename(path) if path else None,
                            ring_rows=len(ring))
        return path

    def _emit_incident(self, cls: str, step=None, captured: int = 0,
                       detail: str = "", dump=None, ring_rows=None) -> None:
        tel = self.telemetry
        if tel is None:
            return
        fields = dict(trigger=cls, suspect_rank=self.rank,
                      captured=captured)
        if step is not None:
            fields["step"] = step
        if detail:
            fields["detail"] = detail
        if dump:
            fields["dump"] = dump
        if ring_rows is not None:
            fields["ring_rows"] = ring_rows
        try:
            tel.emit("incident", **fields)
        except Exception:
            pass       # the recorder must never cost the run its telemetry

    def _dump(self, cls: str, seq: int, ring: list, step=None,
              detail: str = "") -> Optional[str]:
        """Write the ring + header atomically (tmp + rename, the heartbeat
        convention: the bundler's scan must never see a torn dump)."""
        path = os.path.join(self.dir, f"dump.{self.rank}.{seq}.json")
        try:
            os.makedirs(self.dir, exist_ok=True)
            doc = {"version": 1, "trigger": cls, "rank": self.rank,
                   "seq": seq, "t": time.time(), "step": step,
                   "detail": detail, "counts": dict(self._counts),
                   "capture_steps": self.capture_steps,
                   "ring": ring}
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
            return path
        except OSError:
            return None

    # -- deep capture (trainer step boundary) ------------------------------
    @property
    def _capture_active(self) -> bool:
        return self._capture is not None

    def poll(self, global_step: int) -> None:
        """Once per training step, before its dispatch. Idle cost: two
        attribute reads."""
        if self._manual:
            self._manual = False
            self.trigger("manual", step=global_step,
                         detail=getattr(self, "_manual_source", "manual"))
        if self._armed is None and self._capture is None:
            return
        if self._capture is not None:
            if global_step >= self._capture_stop:
                self._stop_trace()
            else:
                self._capture.note(global_step)
            return
        with self._lock:
            armed, self._armed = self._armed, None
        if armed is None:
            return
        self._capture_dir = armed["dir"]
        try:
            from tpudist_torch.utils.profiling import Capture
            os.makedirs(self._capture_dir, exist_ok=True)
            cap = Capture(self._capture_dir, self.cuda)
            if cap.start(global_step):
                self._capture = cap
                self._capture_stop = global_step + self.capture_steps
        except Exception:   # noqa: BLE001 — keep the dump, skip the trace
            self._capture = None

    def _stop_trace(self) -> None:
        cap, self._capture = self._capture, None
        if cap is None:
            return
        try:
            path = cap.stop()
            if path:
                self.traces.append(path)
        except Exception:   # noqa: BLE001 — the run outlives its capture
            pass

    def close(self) -> None:
        """Stop a still-open capture (the trainer's teardown)."""
        self._stop_trace()


def install_sigusr2(recorder: BlackboxRecorder) -> bool:
    """SIGUSR2 -> arm a manual capture on this rank. The handler body is
    one flag write (``request_capture``) — async-signal-safe by
    construction. Returns False where signals aren't installable (non-main
    thread, platforms without SIGUSR2)."""
    import signal
    if not hasattr(signal, "SIGUSR2"):
        return False
    try:
        signal.signal(signal.SIGUSR2,
                      lambda signum, frame: recorder.request_capture(
                          "sigusr2"))
        return True
    except (ValueError, OSError):      # non-main thread / exotic platform
        return False


# -- launcher-side incident bundler ------------------------------------------

class IncidentBundler:
    """Correlate rank dumps + fleet triggers into ``incidents/<id>/``.

    Rides the launcher's existing ~1 s supervision poll: ``observe`` is a
    sink on the launcher's telemetry (fleet-level triggers arrive with
    zero filesystem work), and ``poll()`` scans ``<rundir>/blackbox/`` for
    new rank dumps on a throttle (default every 2 s — the scan is the one
    filesystem read this plane adds, and it is NOT on the per-poll hot
    path; heartbeat reads stay single-pass). Everything that fires inside
    one ``coalesce_s`` window lands in ONE bundle — a nanbomb's fault
    event, the doctor's skip_step, and the rank dump are one incident,
    not three.

    Bundle layout::

        incidents/<id>/manifest.json     # trigger, suspect rank, inventory
        incidents/<id>/dump.<rank>.<seq>.json
        incidents/<id>/fleet_ts.jsonl    # the matching tsdb window
        incidents/<id>/events.jsonl      # causal chain (trigger-relevant)

    Retention mirrors checkpoints: keep-last-``keep`` bundles, oldest
    deleted; per-bundle copies are size-capped (an over-cap dump is
    referenced in the manifest instead of copied).
    """

    def __init__(self, rundir: str, telemetry=None, keep: int = 4,
                 max_mb: float = 64.0, coalesce_s: float = 20.0,
                 window_s: float = 120.0, scan_interval_s: float = 2.0,
                 cooldown_s: float = 60.0):
        self.rundir = rundir
        self.dir = incidents_dir(rundir)
        self.telemetry = telemetry
        self.keep = max(1, int(keep))
        self.max_bytes = int(max_mb * 2**20)
        self.coalesce_s = float(coalesce_s)
        self.window_s = float(window_s)
        self.scan_interval_s = float(scan_interval_s)
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        self._pending: list[dict] = []       # launcher triggers awaiting poll
        self._seen_dumps: set[str] = set()
        self._last_scan = 0.0
        self._last_trigger: dict[str, float] = {}
        self._open: Optional[dict] = None    # {id, dir, t_last, manifest}
        self._seq = self._max_existing_seq()

    def _max_existing_seq(self) -> int:
        best = 0
        for p in glob.glob(os.path.join(self.dir, "inc-*")):
            parts = os.path.basename(p).split("-")
            if len(parts) >= 2 and parts[1].isdigit():
                best = max(best, int(parts[1]))
        return best

    # -- launcher telemetry sink ------------------------------------------
    def observe(self, ev: dict) -> None:
        cls = _trigger_class(ev)
        if cls is None or cls not in LAUNCHER_TRIGGERS:
            return
        rank = ev.get("exit_rank", ev.get("straggler_rank",
                                          ev.get("suspect_rank", -1)))
        with self._lock:
            self._pending.append({"trigger": cls, "suspect_rank": rank,
                                  "t": ev.get("t", time.time()),
                                  "event": ev})

    # -- supervision-poll hook --------------------------------------------
    def poll(self, now: Optional[float] = None) -> list[str]:
        """Drain pending fleet triggers + scan for new rank dumps; returns
        the bundle dirs touched this call."""
        now = time.monotonic() if now is None else now
        with self._lock:
            pending, self._pending = self._pending, []
        dumps = []
        if now - self._last_scan >= self.scan_interval_s:
            self._last_scan = now
            dumps = self._scan_dumps()
        touched = []
        for item in pending:
            last = self._last_trigger.get(item["trigger"])
            if last is not None and now - last < self.cooldown_s:
                continue                     # flapping fleet trigger: bounded
            self._last_trigger[item["trigger"]] = now
            touched.append(self._attach_trigger(item))
        for d in dumps:
            touched.append(self._attach_dump(d))
        return [t for t in touched if t]

    def _scan_dumps(self) -> list[str]:
        out = []
        try:
            names = os.listdir(blackbox_dir(self.rundir))
        except OSError:
            return out
        for fn in sorted(names):
            if fn.startswith("dump.") and fn.endswith(".json") \
                    and fn not in self._seen_dumps:
                self._seen_dumps.add(fn)
                out.append(os.path.join(blackbox_dir(self.rundir), fn))
        return out

    # -- bundling ----------------------------------------------------------
    def _incident_for(self, trigger: str, t: float) -> dict:
        """The open bundle if ``t`` falls inside its coalescing window,
        else a fresh ``incidents/<id>/``."""
        if self._open is not None \
                and t - self._open["t_last"] <= self.coalesce_s:
            self._open["t_last"] = t
            return self._open
        self._seq += 1
        iid = f"inc-{self._seq:03d}-{trigger}"
        d = os.path.join(self.dir, iid)
        os.makedirs(d, exist_ok=True)
        self._open = {"id": iid, "dir": d, "t_first": t, "t_last": t,
                      "manifest": {"version": 1, "id": iid, "t": t,
                                   "trigger": trigger, "suspect_rank": None,
                                   "triggers": [], "dumps": [],
                                   "captures": [], "artifacts": []}}
        self._retain()
        return self._open

    def _attach_trigger(self, item: dict) -> Optional[str]:
        try:
            inc = self._incident_for(item["trigger"], item["t"])
            m = inc["manifest"]
            m["triggers"].append({"trigger": item["trigger"],
                                  "suspect_rank": item["suspect_rank"],
                                  "t": item["t"]})
            if m["suspect_rank"] is None:
                m["suspect_rank"] = item["suspect_rank"]
            self._finish(inc)
            self._emit(item["trigger"], item["suspect_rank"], inc["id"],
                       captured=0)
            return inc["dir"]
        except OSError:
            return None

    def _attach_dump(self, dump_path: str) -> Optional[str]:
        try:
            with open(dump_path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        try:
            inc = self._incident_for(doc.get("trigger", "fault"),
                                     float(doc.get("t") or time.time()))
            m = inc["manifest"]
            base = os.path.basename(dump_path)
            size = os.path.getsize(dump_path)
            if self._bundle_bytes(inc["dir"]) + size <= self.max_bytes:
                shutil.copy2(dump_path, os.path.join(inc["dir"], base))
                m["dumps"].append({"file": base, "rank": doc.get("rank"),
                                   "trigger": doc.get("trigger"),
                                   "step": doc.get("step"),
                                   "ring_rows": len(doc.get("ring") or [])})
            else:
                m["dumps"].append({"ref": dump_path,
                                   "rank": doc.get("rank"),
                                   "trigger": doc.get("trigger"),
                                   "step": doc.get("step"),
                                   "note": "size-capped: referenced, "
                                           "not copied"})
            if m["suspect_rank"] is None:
                m["suspect_rank"] = doc.get("rank")
            m["trigger"] = m.get("trigger") or doc.get("trigger")
            cap = os.path.join(blackbox_dir(self.rundir),
                               f"capture.{doc.get('rank')}.{doc.get('seq')}")
            if os.path.isdir(cap) and cap not in m["captures"]:
                m["captures"].append(cap)
            self._finish(inc)
            self._emit(doc.get("trigger", "fault"), doc.get("rank", -1),
                       inc["id"], captured=1, step=doc.get("step"))
            return inc["dir"]
        except OSError:
            return None

    def _bundle_bytes(self, d: str) -> int:
        total = 0
        try:
            for fn in os.listdir(d):
                try:
                    total += os.path.getsize(os.path.join(d, fn))
                except OSError:
                    pass
        except OSError:
            pass
        return total

    def _finish(self, inc: dict) -> None:
        """(Re)write the fleet_ts slice, causal event chain, and manifest.
        Idempotent: a coalesced second trigger re-finishes the same bundle
        with the wider window."""
        m = inc["manifest"]
        t_lo = inc["t_first"] - self.window_s
        t_hi = inc["t_last"] + self.window_s
        self._write_fleet_slice(inc["dir"], t_lo, t_hi)
        self._write_event_chain(inc["dir"], t_lo, t_hi)
        m["window"] = [t_lo, t_hi]
        m["artifacts"] = sorted(
            fn for fn in os.listdir(inc["dir"]) if fn != "manifest.json")
        tmp = os.path.join(inc["dir"], "manifest.json.tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(m, f, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(inc["dir"], "manifest.json"))

    def _write_fleet_slice(self, d: str, t_lo: float, t_hi: float) -> None:
        from tpudist_torch.obs import tsdb
        path = tsdb.latest_path(self.rundir)
        if not path:
            return
        rows = [r for r in tsdb.load_rows(path) if t_lo <= r["t"] <= t_hi]
        if not rows:
            return
        try:
            with open(os.path.join(d, "fleet_ts.jsonl"), "w",
                      encoding="utf-8") as f:
                for r in rows:
                    f.write(json.dumps(r) + "\n")
        except OSError:
            pass

    def _write_event_chain(self, d: str, t_lo: float, t_hi: float) -> None:
        """The causal chain: every trigger-relevant event any rank (or the
        launcher) recorded inside the window, time-sorted. Reads the run
        dir's event files — bounded work, paid only when an incident
        actually happened."""
        chain: list[dict] = []
        keep = ("fault", "preempt", "doctor", "sdc_probe", "incident",
                "rank_exit", "restart", "straggler", "eviction",
                "collective_deadline", "topology_change", "checkpoint_save",
                "checkpoint_restore")
        for path in sorted(glob.glob(
                os.path.join(self.rundir, "events.*.jsonl"))):
            try:
                with open(path, encoding="utf-8") as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            ev = json.loads(line)
                        except ValueError:
                            continue
                        if isinstance(ev, dict) \
                                and ev.get("type") in keep \
                                and isinstance(ev.get("t"), (int, float)) \
                                and t_lo <= ev["t"] <= t_hi:
                            chain.append(ev)
            except OSError:
                continue
        if not chain:
            return
        chain.sort(key=lambda e: e["t"])
        try:
            with open(os.path.join(d, "events.jsonl"), "w",
                      encoding="utf-8") as f:
                for ev in chain:
                    f.write(json.dumps(ev) + "\n")
        except OSError:
            pass

    def _retain(self) -> None:
        """Keep-last-``keep`` bundles by id sequence (the checkpoint
        convention)."""
        dirs = sorted(glob.glob(os.path.join(self.dir, "inc-*")))
        for d in dirs[:-self.keep] if len(dirs) > self.keep else []:
            shutil.rmtree(d, ignore_errors=True)

    def _emit(self, trigger: str, suspect_rank, bundle: str,
              captured: int = 0, step=None) -> None:
        tel = self.telemetry
        if tel is None:
            return
        fields = dict(trigger=str(trigger),
                      suspect_rank=suspect_rank
                      if isinstance(suspect_rank, (int, float)) else -1,
                      captured=captured, bundle=bundle)
        if step is not None:
            fields["step"] = step
        try:
            tel.emit("incident", **fields)
        except Exception:
            pass

    def close(self) -> None:
        """Final sweep (launcher teardown): bundle any dump that landed
        after the last scan throttle window."""
        self._last_scan = -float("inf")
        try:
            self.poll()
        except Exception:
            pass


# -- reading bundles back (CLI / summarize / dashboard) ----------------------

def list_incidents(rundir: str) -> list[dict]:
    """Every bundle's manifest under ``<rundir>/incidents/``, oldest
    first; unreadable manifests are skipped, never fatal."""
    out = []
    for d in sorted(glob.glob(os.path.join(incidents_dir(rundir), "inc-*"))):
        try:
            with open(os.path.join(d, "manifest.json"),
                      encoding="utf-8") as f:
                m = json.load(f)
        except (OSError, ValueError):
            continue
        m["dir"] = d
        out.append(m)
    return out


def _load_bundle_events(d: str) -> list[dict]:
    out = []
    try:
        with open(os.path.join(d, "events.jsonl"), encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        pass
    except OSError:
        pass
    return out


def format_incident(m: dict) -> str:
    """Human report for one bundle: trigger, suspect rank, doctor
    response, ring coverage, artifact inventory."""
    L = [f"incident {m.get('id', '?')} — trigger {m.get('trigger', '?')}, "
         f"suspect rank {m.get('suspect_rank', '?')}"]
    if m.get("window"):
        span = m["window"][1] - m["window"][0]
        L.append(f"  window: {span:.0f}s around "
                 f"t={m.get('t', 0.0):.3f}")
    for tr in m.get("triggers") or []:
        L.append(f"  fleet trigger: {tr.get('trigger')} "
                 f"(suspect rank {tr.get('suspect_rank')})")
    for dmp in m.get("dumps") or []:
        where = dmp.get("file") or dmp.get("ref", "?")
        note = f" — {dmp['note']}" if dmp.get("note") else ""
        L.append(f"  dump: {where} (rank {dmp.get('rank')}, trigger "
                 f"{dmp.get('trigger')}, step {dmp.get('step')}, "
                 f"{dmp.get('ring_rows', '?')} ring rows){note}")
    evs = _load_bundle_events(m["dir"]) if m.get("dir") else []
    doctor = [e for e in evs if e.get("type") == "doctor"]
    if doctor:
        acts: dict = {}
        for e in doctor:
            a = str(e.get("action"))
            acts[a] = acts.get(a, 0) + 1
        L.append("  doctor response: "
                 + ", ".join(f"{k} x{v}" for k, v in sorted(acts.items())))
    if evs:
        L.append(f"  causal chain: {len(evs)} event(s) "
                 f"({', '.join(sorted({e.get('type', '?') for e in evs}))})")
    for cap in m.get("captures") or []:
        L.append(f"  deep capture: {cap}")
    if m.get("artifacts"):
        L.append("  artifacts: " + ", ".join(m["artifacts"]))
    return "\n".join(L)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpudist_torch.blackbox",
        description="List and report blackbox incident bundles "
                    "(incidents/<id>/ under a run dir)")
    sub = p.add_subparsers(dest="cmd", required=True)
    pl = sub.add_parser("list", help="one line per bundle")
    pl.add_argument("rundir")
    pl.add_argument("--json", action="store_true")
    pr = sub.add_parser("report", help="full report for one (or every) "
                                       "bundle")
    pr.add_argument("rundir")
    pr.add_argument("id", nargs="?", default=None,
                    help="bundle id (default: every bundle)")
    pr.add_argument("--json", action="store_true")
    pr.add_argument("--trace", default="", metavar="OUT.json",
                    help="not in the port yet (it needs tpudist's merged "
                         "Perfetto export, obs/trace.py): refused")
    args = p.parse_args(argv)
    if args.cmd == "report" and args.trace:
        p.error("unsupported in tpudist_torch.blackbox: --trace (the "
                "merged Perfetto export of tpudist's obs/trace.py is not "
                "in the port yet)")

    incidents = list_incidents(args.rundir)
    if not incidents:
        print(f"no incident bundles under "
              f"{incidents_dir(args.rundir)}", file=sys.stderr)
        return 1
    if args.cmd == "list":
        if args.json:
            print(json.dumps(incidents, indent=1, default=str))
            return 0
        for m in incidents:
            print(f"{m.get('id', '?'):<24} trigger={m.get('trigger', '?'):<20}"
                  f" suspect_rank={m.get('suspect_rank', '?'):<4} "
                  f"dumps={len(m.get('dumps') or [])} "
                  f"captures={len(m.get('captures') or [])}")
        return 0
    chosen = [m for m in incidents
              if args.id in (None, m.get("id"))]
    if not chosen:
        print(f"no bundle with id {args.id!r} "
              f"(have: {[m.get('id') for m in incidents]})", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(chosen, indent=1, default=str))
        return 0
    print("\n\n".join(format_incident(m) for m in chosen))
    return 0


if __name__ == "__main__":
    sys.exit(main())
