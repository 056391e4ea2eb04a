"""Per-rank Prometheus metrics endpoint and the launcher's fleet view.

The port's copy of ``tpudist/obs/server.py``: stdlib ``http.server`` only
(the launcher and the CPU tests serve and scrape it without a card). The
hot loop is not instrumented again: ``MetricsRegistry.observe`` is a
``tpudist_torch.telemetry.Telemetry`` sink, so every gauge comes from the
same schema-checked events that ``events.<rank>.jsonl`` keeps, and a run
without ``--metrics-port`` pays nothing.

The metric names (``tpudist_*``), labels and help strings are tpudist's,
so dashboards and alerts built for tpudist read the port unchanged.
Families fed by events the port does not emit (``program``'s FLOPs, the
compile introspection) render as tpudist renders them when those events
are absent; the doctor's (``doctor``, ``sdc_probe``) and the flight
recorder's (``incident``) count the port's events.

Endpoints (``GET``): ``/metrics`` (Prometheus text 0.0.4), ``/healthz``
(one-line JSON liveness) and, on the launcher's fleet endpoint,
``/dashboard``. ``POST /capture`` arms the flight recorder's one-shot
deep capture (``--blackbox``; answered 202) on an endpoint given a
capture hook (``set_capture``), and 404 on any other. ``--metrics-port
0`` binds an ephemeral port, written to ``<outpath>/metrics.<rank>.port``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterable, Optional

from tpudist_torch.telemetry import percentile

PORTFILE_FMT = "metrics.{rank}.port"


def portfile_path(outpath: str, rank) -> str:
    return os.path.join(outpath, PORTFILE_FMT.format(rank=rank))


def _esc(v) -> str:
    """Escape a Prometheus label value."""
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _labels(d: dict) -> str:
    if not d:
        return ""
    return "{" + ",".join(f'{k}="{_esc(v)}"' for k, v in sorted(d.items())) \
        + "}"


class PromText:
    """Tiny Prometheus text-format builder.

    Samples are grouped BY FAMILY at render time (insertion order of first
    appearance), not emitted in call order: the exposition format requires
    all lines of one metric to form a single group, and callers like the
    fleet view naturally loop per-rank across several families — strict
    parsers (OpenMetrics, promtool) reject interleaved re-appearances."""

    def __init__(self):
        self._families: dict[str, dict] = {}

    def sample(self, name: str, value, help: str = "", type: str = "gauge",
               **labels) -> None:
        if value is None:
            return
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = {"help": help, "type": type,
                                          "lines": []}
        elif help and not fam["help"]:
            fam["help"] = help
        fam["lines"].append(f"{name}{_labels(labels)} {float(value):g}")

    def render(self) -> str:
        out: list[str] = []
        for name, fam in self._families.items():
            if fam["help"]:
                out.append(f"# HELP {name} {fam['help']}")
            out.append(f"# TYPE {name} {fam['type']}")
            out.extend(fam["lines"])
        return "\n".join(out) + "\n"


class MetricsRegistry:
    """Event-driven aggregates for one rank's telemetry stream.

    Registered as the Telemetry sink: ``observe(ev)`` runs inside the
    already-taken emit lock's caller (cheap dict math, no I/O, no clocks
    beyond what the event carries), so the step loop's cost is unchanged.
    ``render()`` runs on the HTTP server thread under this registry's own
    lock — a scrape never blocks an emit for longer than the aggregate
    update itself.
    """

    def __init__(self, rank: int = 0, window: int = 128):
        self.rank = rank
        self._lock = threading.Lock()
        self._recent: deque[dict] = deque(maxlen=window)
        self._t_run_start: Optional[float] = None
        self._last_event_t: Optional[float] = None
        self._last_step: Optional[int] = None
        self._last_mfu: Optional[float] = None
        self._steps = 0
        self._productive_s = 0.0
        self._pending_compile_s = 0.0
        self._buckets = {"init": 0.0, "compile": 0.0, "checkpoint": 0.0,
                         "eval": 0.0}
        self._faults: dict[str, int] = {}
        self._quarantined = 0
        self._preempts = 0
        # Doctor plane (tpudist/doctor/): interventions by action, plus the
        # SDC probe census — derived from the same schema-validated events
        # the flight recorder persists, like every other gauge here.
        self._doctor: dict[str, int] = {}
        self._sdc_probes = 0
        self._sdc_divergent = 0
        # Blackbox plane (tpudist/blackbox.py): incident triggers by class,
        # plus how many armed a deep capture vs. were cooldown-suppressed.
        self._incidents: dict[str, int] = {}
        self._incident_captures = 0
        self._samples_skipped = 0
        self._samples_retried = 0
        self._flops_per_step: Optional[float] = None
        self._collective_bytes: Optional[float] = None
        self._collective_ops: Optional[float] = None
        self._temp_bytes: Optional[float] = None
        self._info: dict[str, str] = {}
        self._run_end: Optional[dict] = None
        # Serving plane (tpudist/serve/): derived from the same event
        # stream the batcher persists — request latencies over a recent
        # window (with timestamps, so req/s is a windowed rate, not a
        # lifetime average), batch occupancy, queue depth, AOT startup.
        self._serve_requests = 0
        self._serve_errors = 0
        self._serve_lat: deque[tuple[float, float]] = deque(maxlen=1024)
        self._serve_occ: deque[float] = deque(maxlen=256)
        self._serve_queue_depth: Optional[float] = None
        self._serve_batches = 0
        self._serve_start: Optional[dict] = None

    # -- sink --------------------------------------------------------------
    def observe(self, ev: dict) -> None:
        et = ev.get("type")
        with self._lock:
            self._last_event_t = ev.get("t")
            if et == "run_start":
                self._t_run_start = ev["t"]
                if ev.get("init_s"):
                    self._buckets["init"] = float(ev["init_s"])
                self._info = {k: str(ev[k]) for k in
                              ("platform", "arch", "device_kind") if k in ev}
            elif et == "step":
                self._steps += 1
                self._last_step = ev.get("step")
                # A compile-carrying step is preceded by its paired compile
                # event (Telemetry.step emits compile first): the stashed
                # seconds come OUT of this step's productive time, mirroring
                # Telemetry's own accounting (productive = step - compile) —
                # and the step stays OUT of the percentile window, matching
                # the heartbeat window and summarize's steady-state
                # percentiles (a minutes-long compile in the p95 would fire
                # step-time alerts at every restart).
                if self._pending_compile_s > 0.0:
                    self._productive_s += max(
                        0.0, ev["step_s"] - self._pending_compile_s)
                    self._pending_compile_s = 0.0
                else:
                    self._productive_s += ev["step_s"]
                    self._recent.append(ev)
                if "mfu" in ev:
                    self._last_mfu = ev["mfu"]
            elif et == "compile":
                self._buckets["compile"] += ev["seconds"]
                if ev.get("phase") == "train_step":
                    self._pending_compile_s += ev["seconds"]
                for src, dst in (("collective_bytes_per_step",
                                  "_collective_bytes"),
                                 ("collective_ops", "_collective_ops"),
                                 ("temp_bytes", "_temp_bytes")):
                    if ev.get(src) is not None:
                        setattr(self, dst, ev[src])
            elif et in ("checkpoint_save", "checkpoint_restore"):
                self._buckets["checkpoint"] += ev["seconds"]
            elif et == "eval":
                self._buckets["eval"] += ev["seconds"]
            elif et == "epoch":
                self._samples_skipped += ev.get("samples_skipped", 0) or 0
                self._samples_retried += ev.get("samples_retried", 0) or 0
            elif et == "fault":
                p = str(ev.get("point"))
                self._faults[p] = self._faults.get(p, 0) + 1
                if p == "checkpoint_quarantine":
                    # Storage damage deserves its own headline counter: a
                    # fleet quietly eating its keep-K fallback pool is an
                    # incident, not a per-point footnote.
                    self._quarantined += 1
            elif et == "preempt":
                self._preempts += 1
            elif et == "doctor":
                a = str(ev.get("action"))
                self._doctor[a] = self._doctor.get(a, 0) + 1
            elif et == "sdc_probe":
                self._sdc_probes += 1
                if ev.get("divergent") or ev.get("tie"):
                    self._sdc_divergent += 1
            elif et == "incident":
                tr = str(ev.get("trigger"))
                self._incidents[tr] = self._incidents.get(tr, 0) + 1
                if ev.get("captured"):
                    self._incident_captures += 1
            elif et == "request":
                self._serve_requests += 1
                if ev.get("error"):
                    # Failed requests count (and keep req/s honest about
                    # liveness via the errors counter) but stay out of the
                    # latency window — p50/p99 is SERVICE latency.
                    self._serve_errors += 1
                elif isinstance(ev.get("latency_s"), (int, float)):
                    self._serve_lat.append((ev["t"], ev["latency_s"]))
            elif et == "serve_batch":
                self._serve_batches += 1
                if ev.get("bucket"):
                    self._serve_occ.append(ev["n_valid"] / ev["bucket"])
                if ev.get("queue_depth") is not None:
                    self._serve_queue_depth = ev["queue_depth"]
            elif et == "serve_start":
                self._serve_start = ev
            elif et == "program":
                if ev.get("flops_per_step"):
                    self._flops_per_step = ev["flops_per_step"]
            elif et == "run_end":
                self._run_end = ev
                self._buckets["init"] = ev.get("init_s", self._buckets["init"])

    # -- exposition --------------------------------------------------------
    def snapshot(self) -> dict:
        """Point-in-time copy used by render() and /healthz."""
        with self._lock:
            now = time.time()
            recent = list(self._recent)
            out = {
                "rank": self.rank,
                "steps_total": self._steps,
                "last_step": self._last_step,
                "last_mfu": self._last_mfu,
                "flops_per_step": self._flops_per_step,
                "collective_bytes_per_step": self._collective_bytes,
                "collective_ops": self._collective_ops,
                "temp_bytes": self._temp_bytes,
                "productive_s": self._productive_s,
                "buckets": dict(self._buckets),
                "faults": dict(self._faults),
                "quarantined": self._quarantined,
                "preempts": self._preempts,
                "doctor": dict(self._doctor),
                "sdc_probes": self._sdc_probes,
                "sdc_divergent": self._sdc_divergent,
                "incidents": dict(self._incidents),
                "incident_captures": self._incident_captures,
                "samples_skipped": self._samples_skipped,
                "samples_retried": self._samples_retried,
                "info": dict(self._info),
                "heartbeat_age_s": (now - self._last_event_t
                                    if self._last_event_t else None),
                "run_end": self._run_end,
            }
            serve = None
            if self._serve_start is not None or self._serve_requests:
                lat = [v for _, v in self._serve_lat]
                serve = {
                    "requests_total": self._serve_requests,
                    "errors_total": self._serve_errors,
                    "batches_total": self._serve_batches,
                    "queue_depth": self._serve_queue_depth,
                    "latency_p50_s": (percentile(lat, 50) if lat else None),
                    "latency_p99_s": (percentile(lat, 99) if lat else None),
                    "occupancy": (sum(self._serve_occ)
                                  / len(self._serve_occ)
                                  if self._serve_occ else None),
                    "aot_s": (self._serve_start or {}).get("aot_s"),
                    "cache": (self._serve_start or {}).get("cache"),
                    "n_buckets": (self._serve_start or {}).get("n_buckets"),
                }
                # Windowed req/s ANCHORED TO NOW: only requests from the
                # last window count, and the span runs to the present —
                # so the gauge decays to 0 when traffic stops instead of
                # freezing at the last burst's rate forever (an
                # autoscaler reading phantom steady traffic), and a
                # lifetime average would flatten every rate change the
                # latency/throughput curve exists to show.
                window = 60.0
                recent_req = [t for t, _ in self._serve_lat
                              if now - t <= window]
                span = (now - min(recent_req)) if recent_req else 0.0
                serve["req_per_s"] = (len(recent_req) / span if span > 0
                                      else 0.0)
            out["serve"] = serve
        # goodput: the trainer's own run_end number once the run is over;
        # live runs use wall since run_start (+ init stashed before it).
        if self._run_end is not None:
            out["goodput"] = self._run_end.get("goodput")
            out["wall_s"] = self._run_end.get("wall_s")
        elif self._t_run_start is not None:
            wall = max(1e-9, now - self._t_run_start + out["buckets"]["init"])
            out["wall_s"] = wall
            out["goodput"] = min(1.0, out["productive_s"] / wall)
        else:
            out["goodput"] = None
            out["wall_s"] = None
        phases = {}
        if recent:
            for key in ("step_s", "data_s", "h2d_s", "compute_s", "drain_s"):
                xs = [e[key] for e in recent if key in e]
                if xs:
                    phases[key] = {"p50": percentile(xs, 50),
                                   "p95": percentile(xs, 95)}
        out["phases"] = phases
        return out

    def render(self) -> str:
        s = self.snapshot()
        p = PromText()
        if s["info"]:
            p.sample("tpudist_run_info", 1,
                     help="run identity labels (value is always 1)",
                     **s["info"])
        p.sample("tpudist_steps_total", s["steps_total"],
                 help="training steps completed", type="counter")
        if s["last_step"] is not None:
            p.sample("tpudist_last_step", s["last_step"],
                     help="most recent global step number")
        for key, phase in (("step_s", "step"), ("data_s", "data"),
                           ("h2d_s", "h2d"), ("compute_s", "compute"),
                           ("drain_s", "drain")):
            q = s["phases"].get(key)
            if not q:
                continue
            name = ("tpudist_step_time_seconds" if phase == "step"
                    else "tpudist_phase_time_seconds")
            hlp = ("per-step wall time over a recent window"
                   if phase == "step" else
                   "per-step phase breakdown over a recent window")
            kw = {} if phase == "step" else {"phase": phase}
            p.sample(name, q["p50"], help=hlp, quantile="0.5", **kw)
            p.sample(name, q["p95"], quantile="0.95", **kw)
        p.sample("tpudist_mfu", s["last_mfu"],
                 help="model FLOPs utilization of the most recent step")
        p.sample("tpudist_goodput", s["goodput"],
                 help="productive step time / wall time so far")
        p.sample("tpudist_productive_seconds_total", s["productive_s"],
                 help="accumulated productive step seconds", type="counter")
        for bucket, v in sorted(s["buckets"].items()):
            p.sample("tpudist_overhead_seconds_total", v,
                     help="non-productive wall attributed by bucket",
                     type="counter", bucket=bucket)
        p.sample("tpudist_flops_per_step", s["flops_per_step"],
                 help="per-device FLOPs of the compiled train step")
        p.sample("tpudist_collective_bytes_per_step",
                 s["collective_bytes_per_step"],
                 help="bytes moved by collective ops per compiled step "
                      "(XLA introspection)")
        p.sample("tpudist_collective_ops_per_step", s["collective_ops"],
                 help="collective op count in the compiled step")
        p.sample("tpudist_hbm_temp_bytes", s["temp_bytes"],
                 help="XLA buffer-assignment temp (scratch) bytes")
        p.sample("tpudist_samples_skipped_total", s["samples_skipped"],
                 help="data-path samples skipped after retries",
                 type="counter")
        p.sample("tpudist_samples_retried_total", s["samples_retried"],
                 help="data-path samples healed by retry", type="counter")
        for point, n in sorted(s["faults"].items()):
            p.sample("tpudist_faults_total", n,
                     help="fault injections/detections by point",
                     type="counter", point=point)
        p.sample("tpudist_checkpoint_quarantined_total", s["quarantined"],
                 help="checkpoints that failed integrity verification and "
                      "were quarantined aside (.corrupt)", type="counter")
        p.sample("tpudist_preemptions_total", s["preempts"],
                 help="SIGTERM/SIGINT preemption drains", type="counter")
        for action, n in sorted(s["doctor"].items()):
            p.sample("tpudist_doctor_interventions_total", n,
                     help="doctor interventions by action (skip_step / "
                          "spike / sdc_divergence / rollback / evict)",
                     type="counter", action=action)
        if s["sdc_probes"]:
            p.sample("tpudist_sdc_probes_total", s["sdc_probes"],
                     help="cross-replica replicated-state digest probes "
                          "run", type="counter")
            p.sample("tpudist_sdc_divergence_total", s["sdc_divergent"],
                     help="probes that found replicas disagreeing "
                          "(silent data corruption)", type="counter")
        for trigger, n in sorted(s["incidents"].items()):
            p.sample("tpudist_incidents_total", n,
                     help="blackbox incident triggers by class "
                          "(docs/INCIDENTS.md)", type="counter",
                     trigger=trigger)
        if s["incidents"]:
            p.sample("tpudist_incident_captures_total",
                     s["incident_captures"],
                     help="incidents that armed a deep capture (the rest "
                          "were cooldown-suppressed)", type="counter")
        p.sample("tpudist_heartbeat_age_seconds", s["heartbeat_age_s"],
                 help="seconds since this rank last emitted any event")
        sv = s.get("serve")
        if sv:
            p.sample("tpudist_serve_requests_total", sv["requests_total"],
                     help="serving requests completed", type="counter")
            p.sample("tpudist_serve_request_errors_total",
                     sv["errors_total"],
                     help="serving requests that completed with an error",
                     type="counter")
            p.sample("tpudist_serve_batches_total", sv["batches_total"],
                     help="bucketed micro-batches executed", type="counter")
            p.sample("tpudist_serve_request_latency_seconds",
                     sv["latency_p50_s"],
                     help="request latency (submit to result) over a "
                          "recent window", quantile="0.5")
            p.sample("tpudist_serve_request_latency_seconds",
                     sv["latency_p99_s"], quantile="0.99")
            p.sample("tpudist_serve_queue_depth", sv["queue_depth"],
                     help="requests waiting behind the most recent batch")
            p.sample("tpudist_serve_batch_occupancy", sv["occupancy"],
                     help="valid rows / bucket rows over a recent window "
                          "(1 - padding waste)")
            p.sample("tpudist_serve_requests_per_second", sv["req_per_s"],
                     help="completed-request rate over the latency window")
            p.sample("tpudist_serve_aot_seconds", sv["aot_s"],
                     help="startup AOT bucket-set compile wall seconds")
            if sv.get("cache") in ("warm", "cold"):
                p.sample("tpudist_serve_cache_warm",
                         1 if sv["cache"] == "warm" else 0,
                         help="1 when the persistent compile cache was "
                              "warm at AOT startup")
        p.sample("tpudist_run_ended", 1 if s["run_end"] is not None else 0,
                 help="1 once run_end was emitted (endpoint lingers briefly)")
        return p.render()


class _Handler(BaseHTTPRequestHandler):
    server_version = "tpudist-obs/1"

    def do_GET(self):  # noqa: N802 (http.server API)
        try:
            if self.path.split("?")[0] in ("/metrics", "/"):
                body = self.server.render_metrics().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif self.path.split("?")[0] == "/healthz":
                body = (json.dumps(self.server.render_health())
                        + "\n").encode()
                ctype = "application/json"
            elif self.path.split("?")[0] == "/dashboard" \
                    and getattr(self.server, "render_dashboard", None):
                # Attached only where there is something to draw (the
                # launcher's fleet endpoint); rank endpoints 404 here.
                body = self.server.render_dashboard().encode()
                ctype = "text/html; charset=utf-8"
            else:
                self.send_error(404)
                return
        except Exception as e:      # a scrape must never kill the server
            self.send_error(500, explain=repr(e))
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):  # noqa: N802 (http.server API)
        # POST /capture arms the recorder's one-shot capture (trigger
        # class ``manual``, the SIGUSR2 cooldown). POST, not GET: a crawler
        # or a prefetch must not burn the cooldown.
        if self.path.split("?")[0] != "/capture":
            self.send_error(404)
            return
        hook = getattr(self.server, "capture_hook", None)
        if hook is None:
            self.send_error(404, explain="no blackbox recorder attached "
                                         "(run with --blackbox)")
            return
        try:
            hook()
        except Exception as e:
            self.send_error(500, explain=repr(e))
            return
        body = b'{"ok": true, "armed": "manual"}\n'
        self.send_response(202)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):      # scrapes must not spam training stdout
        pass


class MetricsServer:
    """Threaded HTTP server around a render callable.

    ``port=0`` binds an ephemeral port (read ``.port`` after start). The
    server is a daemon thread: it can never keep a finished rank alive.
    """

    def __init__(self, registry, port: int = 0, host: str = "0.0.0.0",
                 dashboard=None):
        self.registry = registry
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.render_metrics = self._render
        self._httpd.render_health = self._health
        # ``dashboard``: () -> HTML str, served at /dashboard. Reads
        # (history file, tsdb window) happen in the HTTP handler thread —
        # never on the caller's supervision poll.
        if dashboard is not None:
            self._httpd.render_dashboard = dashboard
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="tpudist-metrics",
            daemon=True)
        self._portfile: Optional[str] = None

    def _render(self) -> str:
        return self.registry.render()

    def _health(self) -> dict:
        s = self.registry.snapshot() if hasattr(self.registry, "snapshot") \
            else {}
        return {"ok": True, "rank": s.get("rank"),
                "last_step": s.get("last_step"),
                "heartbeat_age_s": s.get("heartbeat_age_s")}

    def set_capture(self, hook) -> None:
        """Serve ``POST /capture``: ``hook()`` (cheap: it runs on the HTTP
        thread; the recorder's sets one flag)."""
        self._httpd.capture_hook = hook

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def write_portfile(self, outpath: str, rank) -> str:
        """Atomically record the bound port for discovery (fleet view,
        operators, the obs smoke test)."""
        path = portfile_path(outpath, rank)
        tmp = path + ".tmp"
        os.makedirs(outpath, exist_ok=True)
        with open(tmp, "w") as f:
            f.write(str(self.port))
        os.replace(tmp, path)
        self._portfile = path
        return path

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass
        if self._portfile:
            try:
                os.unlink(self._portfile)
            except OSError:
                pass
            self._portfile = None


# -- launcher-side fleet view -------------------------------------------------

class FleetMetrics:
    """The launcher's aggregate view: its own supervision counters, the
    ranks' heartbeats (straggler flags as gauges), and headline samples
    scraped from each rank's discovered endpoint.

    ``refresh()`` is called from the launcher's existing ~1 s poll loop —
    the HTTP handler serves the cached text, so a scrape never does
    filesystem or network work of its own. Heartbeats work across hosts
    (shared filesystem); endpoint scraping is same-host best-effort.
    """

    def __init__(self, rundir: str, nprocs: int, straggler_factor: float = 4.0):
        self.rundir = rundir
        self.nprocs = nprocs
        self.straggler_factor = straggler_factor
        self._lock = threading.Lock()
        self._launcher_events: deque[dict] = deque(maxlen=512)
        self._rank_exits: dict[str, int] = {}
        self._restarts = 0
        self._reforms = 0
        self._evictions = 0
        self._collective_deadlines = 0
        self._incidents: dict[str, int] = {}
        self._world = nprocs
        self._attempt = 0
        self._stragglers: set[int] = set()
        self._cached = "# tpudist fleet: no refresh yet\n"
        # rank-endpoint samples, updated by a BACKGROUND scrape thread: the
        # supervision poll that calls refresh() also implements
        # abort-on-peer-loss, and a wedged rank endpoint eating its full
        # connect timeout (x nprocs, serially) must not delay dead-rank
        # detection. refresh() publishes the previous scrape's samples
        # (≤ one poll interval stale) and kicks the next scrape.
        self._rank_samples: dict[int, dict] = {}
        self._scraping = False

    # sink for the launcher's own Telemetry stream
    def observe(self, ev: dict) -> None:
        with self._lock:
            self._launcher_events.append(ev)
            et = ev.get("type")
            if et == "rank_exit":
                c = str(ev.get("classification", "?"))
                self._rank_exits[c] = self._rank_exits.get(c, 0) + 1
            elif et == "restart":
                self._restarts += 1
            elif et == "topology_change":
                # Elastic world change: reform (shrink to survivors) or
                # serve-plane scale-up (grow). Either way the scrape loop
                # and gauges must follow the new world; only genuine
                # reforms count toward the reform SLO counter.
                if ev.get("mesh_action") != "scale_up":
                    self._reforms += 1
                try:
                    self._world = int(ev.get("to_world", self._world))
                except (TypeError, ValueError):
                    pass
                self.nprocs = self._world
            elif et == "launcher_start":
                self._attempt = ev.get("attempt", self._attempt)
                try:
                    self._world = int(ev.get("nprocs", self._world))
                except (TypeError, ValueError):
                    pass
                self.nprocs = self._world
                # New attempt: the previous attempt's straggler flags must
                # not latch into the restarted job's gauges.
                self._stragglers.clear()
            elif et == "straggler":
                self._stragglers.add(int(ev.get("straggler_rank", -1)))
            elif et == "eviction":
                # Proactive drains are NOT crash restarts: their own
                # counter, so an SLO on restart rate stays honest.
                self._evictions += 1
            elif et == "collective_deadline":
                self._collective_deadlines += 1
            elif et == "incident":
                # Emitted by the launcher-side bundler as it correlates
                # rank dumps / fleet triggers into incidents/<id>/.
                tr = str(ev.get("trigger"))
                self._incidents[tr] = self._incidents.get(tr, 0) + 1

    def _scrape_rank(self, rank: int, port: int, timeout: float = 0.25):
        """Headline gauges from one rank's /metrics (same-host best-effort).
        Serving replicas contribute their request counter and latency
        quantiles, so the fleet endpoint shows every replica's serving
        headline beside the training ones."""
        import urllib.request
        want = {"tpudist_goodput": "goodput", "tpudist_mfu": "mfu",
                "tpudist_steps_total": "steps",
                "tpudist_serve_requests_total": "serve_requests",
                "tpudist_serve_requests_per_second": "serve_req_s",
                "tpudist_serve_queue_depth": "queue_depth"}
        # Labeled counter families summed across labels (fault points,
        # doctor actions): one headline number per rank for the fleet
        # gauges and the tsdb recorder.
        summed = {"tpudist_faults_total": "faults",
                  "tpudist_doctor_interventions_total": "doctor"}
        out = {}
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=timeout) as r:
            for line in r.read().decode().splitlines():
                if line.startswith("#"):
                    continue
                name = line.split("{")[0].split(" ")[0]
                try:
                    val = float(line.rsplit(" ", 1)[1])
                except ValueError:
                    continue
                if name in want:
                    out[want[name]] = val
                elif name in summed:
                    key = summed[name]
                    out[key] = out.get(key, 0.0) + val
                elif name == "tpudist_serve_request_latency_seconds":
                    if 'quantile="0.5"' in line:
                        out["serve_p50"] = val
                    elif 'quantile="0.99"' in line:
                        out["serve_p99"] = val
        return out

    def _scrape_all(self) -> None:
        """Background pass over every discovered rank endpoint (daemon
        thread; at most one in flight)."""
        samples: dict[int, dict] = {}
        try:
            for rank in range(self.nprocs):
                try:
                    with open(portfile_path(self.rundir, rank)) as f:
                        port = int(f.read().strip())
                except (OSError, ValueError):
                    continue
                samples[rank] = {"port": port}
                try:
                    samples[rank].update(self._scrape_rank(rank, port))
                except Exception:
                    pass
        finally:
            with self._lock:
                self._rank_samples = samples
                self._scraping = False

    def _kick_scrape(self) -> None:
        if not (self.rundir and os.path.isdir(self.rundir)):
            return
        with self._lock:
            if self._scraping:
                return
            self._scraping = True
        threading.Thread(target=self._scrape_all,
                         name="tpudist-fleet-scrape", daemon=True).start()

    def refresh(self, attempt: Optional[int] = None, beats=None) -> None:
        """Rebuild the cached exposition from heartbeats (``beats`` lets the
        launcher share its own read) + the last background endpoint
        scrape, then kick the next scrape."""
        from tpudist_torch.telemetry import (find_stragglers,
                                             heartbeat_dir,
                                             read_heartbeats)
        if beats is None:
            beats = read_heartbeats(heartbeat_dir(self.rundir)) \
                if self.rundir else {}
        if attempt is not None:
            # Heartbeat files persist across attempts (nothing unlinks a
            # dead rank's file): after an elastic reform the removed rank's
            # stale beat would otherwise render frozen per-rank gauges —
            # and a growing heartbeat age — forever. Gate on the CURRENT
            # attempt, the same field find_stragglers gates on.
            beats = {r: b for r, b in beats.items()
                     if b.get("attempt") == attempt}
        now = time.time()
        p = PromText()
        with self._lock:
            p.sample("tpudist_fleet_nprocs", self.nprocs,
                     help="ranks the launcher supervises")
            p.sample("tpudist_fleet_attempt",
                     attempt if attempt is not None else self._attempt,
                     help="current launch attempt (restart counter)")
            p.sample("tpudist_fleet_restarts_total", self._restarts,
                     help="elastic restarts performed", type="counter")
            p.sample("tpudist_world_size", self._world,
                     help="current gang world size (shrinks on an elastic "
                          "reform)")
            p.sample("tpudist_fleet_reforms_total", self._reforms,
                     help="gang reformations (rank loss survived at a "
                          "smaller world)", type="counter")
            p.sample("tpudist_fleet_evictions_total", self._evictions,
                     help="persistent stragglers proactively drained "
                          "(--evict-stragglers; separate from crash "
                          "restarts)", type="counter")
            p.sample("tpudist_fleet_collective_deadline_total",
                     self._collective_deadlines,
                     help="wedged-gang escalations (--collective-deadline: "
                          "every rank's heartbeat stale past the deadline)",
                     type="counter")
            for c, n in sorted(self._rank_exits.items()):
                p.sample("tpudist_fleet_rank_exits_total", n,
                         help="nonzero rank exits by classification",
                         type="counter", classification=c)
            for tr, n in sorted(self._incidents.items()):
                p.sample("tpudist_incidents_total", n,
                         help="blackbox incidents bundled, by trigger "
                              "class (incidents/<id>/ under the run dir)",
                         type="counter", trigger=tr)
            flagged = set(self._stragglers)
        # factor <= 0 means detection is DISABLED (same contract as the
        # launcher's _check_stragglers): an unguarded factor-0 comparison
        # would flag every rank with any real host overhead.
        if self.straggler_factor > 0:
            live = find_stragglers(beats, factor=self.straggler_factor,
                                   attempt=attempt)
            flagged |= {s["straggler_rank"] for s in live}
        for rank, b in sorted(beats.items()):
            p.sample("tpudist_rank_last_step", b.get("step"),
                     help="per-rank most recent step (heartbeat)",
                     rank=rank)
            p.sample("tpudist_rank_step_seconds", b.get("step_p50"),
                     help="per-rank step-time p50 over the heartbeat window",
                     rank=rank, quantile="0.5")
            p.sample("tpudist_rank_step_seconds", b.get("step_p95"),
                     rank=rank, quantile="0.95")
            p.sample("tpudist_rank_host_seconds", b.get("host_p50"),
                     help="per-rank host-overhead p50 (the straggler signal)",
                     rank=rank, quantile="0.5")
            if b.get("updated_at"):
                p.sample("tpudist_rank_heartbeat_age_seconds",
                         max(0.0, now - b["updated_at"]),
                         help="seconds since the rank's heartbeat file moved",
                         rank=rank)
        for rank in sorted(set(beats) | flagged):
            if rank < 0:
                continue
            p.sample("tpudist_straggler", 1 if rank in flagged else 0,
                     help="1 once the rank was flagged as a straggler this "
                          "attempt (cleared on restart)",
                     rank=rank)
        # endpoint aggregation: publish the BACKGROUND scrape's last pass
        # (≤ one refresh interval stale) — never block this caller on HTTP
        with self._lock:
            samples = dict(self._rank_samples)
        for rank, got in sorted(samples.items()):
            p.sample("tpudist_rank_metrics_port", got.get("port"),
                     help="per-rank metrics endpoint (same-host scrape)",
                     rank=rank)
            p.sample("tpudist_rank_goodput", got.get("goodput"),
                     help="per-rank goodput (scraped from the rank "
                          "endpoint)", rank=rank)
            p.sample("tpudist_rank_mfu", got.get("mfu"),
                     help="per-rank last-step MFU (scraped)", rank=rank)
            p.sample("tpudist_rank_steps_total", got.get("steps"),
                     help="per-rank steps completed (scraped)",
                     type="counter", rank=rank)
            p.sample("tpudist_rank_serve_requests_total",
                     got.get("serve_requests"),
                     help="per-replica serving requests completed "
                          "(scraped)", type="counter", rank=rank)
            p.sample("tpudist_rank_serve_latency_seconds",
                     got.get("serve_p50"),
                     help="per-replica request latency (scraped)",
                     rank=rank, quantile="0.5")
            p.sample("tpudist_rank_serve_latency_seconds",
                     got.get("serve_p99"), rank=rank, quantile="0.99")
            p.sample("tpudist_rank_serve_requests_per_second",
                     got.get("serve_req_s"),
                     help="per-replica completed-request rate (scraped)",
                     rank=rank)
        with self._lock:
            self._cached = p.render()
        self._kick_scrape()

    def render(self) -> str:
        with self._lock:
            return self._cached

    def gauges(self) -> dict:
        """In-memory counter + endpoint-scrape snapshot for the fleet
        time-series recorder (``obs.tsdb``). Pure memory under the fleet
        lock — no filesystem or network work, because the recorder rides
        the supervision poll, whose single heartbeat-dir pass must remain
        its only read."""
        with self._lock:
            return {
                "world": self._world,
                "attempt": self._attempt,
                "restarts": self._restarts,
                "reforms": self._reforms,
                "evictions": self._evictions,
                "collective_deadlines": self._collective_deadlines,
                "rank_exits": sum(self._rank_exits.values()),
                "stragglers": len(self._stragglers),
                "incidents": sum(self._incidents.values()),
                "rank_samples": {r: dict(s)
                                 for r, s in self._rank_samples.items()},
            }

    def snapshot(self) -> dict:           # /healthz parity with the rank side
        with self._lock:
            return {"rank": -1, "last_step": None, "heartbeat_age_s": None,
                    "nprocs": self.nprocs}
