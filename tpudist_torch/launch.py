"""Multi-process launcher: ``python -m tpudist_torch.launch -n N -- CMD``.

Counterpart of ``tpudist/launch.py`` (the reference's
``torch.distributed.launch``, ``start.sh``). It starts ``N`` copies of
``CMD`` on this host, each with its rendezvous identity in the env that
``dist.initialize_runtime`` reads::

    TPUDIST_COORDINATOR    host:port of rank 0's TCP store
    TPUDIST_NUM_PROCESSES  N
    TPUDIST_PROCESS_ID     0 … N-1 (rank r binds cuda:r on the card)
    TPUDIST_RESTART_COUNT  the attempt (the telemetry's ``attempt``)

and supervises them: the first rank to exit non-zero tears the others
down (SIGTERM to each rank's process group, SIGKILL after a grace
period, which also reaches a rank blocked in a collective), and that
rank's exit code is the launcher's. ``--max-restarts K`` relaunches every
rank, on a fresh coordinator port, up to K times (torchrun's
``--max-restarts``): with the trainer's ``--resume auto --overwrite keep``
each relaunch continues from the last completed epoch's checkpoint in the
outpath (the live file, or the newest valid history copy when that one is
torn); the first attempt, finding none, starts fresh and says so.

A signal to the launcher reaches the ranks through the teardown: each
trainer drains (it finishes the step, writes an emergency checkpoint with
the epoch's sample cursor and exits 75, ``faults.PREEMPTED_EXIT_CODE``)
within the grace period, and the launcher exits 130; the same command
with ``--resume auto --overwrite keep`` continues the epoch where it
stopped. The restart and exhaustion lines name each exit code's meaning
(``faults.classify_exit``). ``--inject SPEC`` is parsed once here (a typo,
or a point whose plane the port lacks, fails at once) and given to every
rank as ``TPUDIST_INJECT``.

Observability, as tpudist's launcher: the launcher writes its own event
stream, ``events.launcher.jsonl`` (``launcher_start``, ``rank_exit`` with
the exit's meaning, ``restart``, ``straggler``), into ``--telemetry-dir``
(made at once: pair it with the trainer's ``--overwrite keep``) or, when
the command runs ``--telemetry`` with an ``--outpath``, into that outpath
once a rank has set it up. About once a second it reads the ranks'
heartbeat files: a rank whose per-step host time is over
``--straggler-factor`` times the others' median is named once an attempt
(a ``straggler`` event; 0 turns the check off). ``--metrics-port`` serves
the fleet view (``obs.server.FleetMetrics``: supervision counters, the
ranks' heartbeat gauges and straggler flags, headlines scraped from each
rank's own endpoint) at ``/metrics`` and ``/dashboard``, and records it
as ``fleet_ts.<attempt>.jsonl`` (``obs.tsdb``).

Incident bundles, as tpudist's launcher makes them: once a rank runs
``--blackbox`` (its ``blackbox/`` dir exists in the run dir), the
supervision poll gathers the ranks' dumps and the launcher's own
triggers (a nonzero ``rank_exit``, a ``straggler``) into
``incidents/<id>/`` (``blackbox.IncidentBundler``), keeping the newest
``--incident-keep`` (4); a last sweep runs as the launcher exits.

tpudist's other launcher flags (the elastic gang and its
``--drain-grace``, straggler eviction, the collective watchdog,
scale-up, and the JAX platform flags) are accepted by name and refused
when set::

    python -m tpudist_torch.launch -n 1 -- python -m tpudist_torch \\
        --distributed -a resnet18 --use_amp --fused-bn on -b 256 --synthetic
    python -m tpudist_torch.launch -n 2 -- python -m tpudist_torch \\
        --distributed --device cpu --synthetic -a resnet18 -b 16 ...
    python -m tpudist_torch.launch -n 1 --max-restarts 2 -- python -m \\
        tpudist_torch --distributed ... --resume auto --overwrite keep
    python -m tpudist_torch.launch -n 1 --telemetry-dir D --metrics-port 0 \\
        -- python -m tpudist_torch --distributed ... --telemetry \\
        --outpath D --overwrite keep
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Optional

from tpudist_torch import faults
from tpudist_torch import telemetry as telemetry_lib

# tpudist's launcher flags the port does not have: (flag, what is
# missing). A value given for any of them is refused by name.
_NOT_YET = {
    "devices_per_proc": ("--devices-per-proc",
                         "simulated JAX CPU devices (one card a rank)"),
    "platform": ("--platform", "a JAX platform (the trainer's --device "
                               "picks the card or the CPU)"),
    "elastic": ("--elastic", "the elastic gang (tpudist/elastic/)"),
    "min_ranks": ("--min-ranks", "the elastic gang"),
    "drain_grace": ("--drain-grace", "the elastic gang"),
    "evict_stragglers": ("--evict-stragglers", "straggler eviction"),
    "scale_up": ("--scale-up", "elastic scale-up"),
    "collective_deadline": ("--collective-deadline",
                            "the dead-collective watchdog"),
}


def find_free_port() -> int:
    """A free local TCP port for rank 0's store. Another process could
    take it before rank 0 binds it; rank 0 then fails to bind, and the
    teardown below ends the job rather than letting it hang."""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _terminate_all(procs, grace: float = 10.0) -> None:
    """SIGTERM each child's process group, then SIGKILL what is left after
    ``grace`` seconds: a rank blocked in a collective (or its children)
    must not outlive the job."""
    for pr in procs:
        try:
            os.killpg(pr.pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            pass
    deadline = time.monotonic() + grace
    for pr in procs:
        try:
            pr.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            try:
                os.killpg(pr.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
            pr.wait()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpudist_torch.launch",
        description="tpudist_torch multi-process launcher (one host)")
    p.add_argument("--nprocs", "-n", type=int, required=True,
                   help="number of ranks to start (on the card: at most "
                        "one a CUDA card)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0's rendezvous (default: "
                        "127.0.0.1:<a free port>, fresh for each attempt)")
    p.add_argument("--max-restarts", type=int, default=0,
                   help="after a failure tears the job down, relaunch all "
                        "ranks up to N times; with the trainer's --resume "
                        "auto --overwrite keep a relaunch continues from the "
                        "last completed epoch")
    p.add_argument("--inject", default=os.environ.get(faults.ENV_SPEC, ""),
                   help="fault-injection spec given to every rank as "
                        "TPUDIST_INJECT (tpudist_torch/faults.py), e.g. "
                        "'rank_exit@step=7@rank=1@attempt=0'")
    p.add_argument("--telemetry-dir", default="", dest="telemetry_dir",
                   help="run dir of the ranks' telemetry (heartbeats/, "
                        "events.*.jsonl): the launcher reads the heartbeats "
                        "for straggler detection and writes "
                        "events.launcher.jsonl there, creating it at once "
                        "(pair with the trainer's --overwrite keep). "
                        "Default: a command with --telemetry and --outpath "
                        "gives its outpath, used once a rank has made it")
    p.add_argument("--metrics-port", type=int, default=-1,
                   dest="metrics_port",
                   help="serve the fleet view on this port (0 = a free "
                        "port, announced on stderr): supervision counters, "
                        "per-rank heartbeat gauges, straggler flags, the "
                        "ranks' scraped headlines (/metrics) and a "
                        "/dashboard page; needs a telemetry dir. -1 = off")
    p.add_argument("--straggler-factor", type=float, default=4.0,
                   dest="straggler_factor",
                   help="flag a rank whose per-step host time (heartbeat "
                        "host_p50) is over this many times the other "
                        "ranks' median (0 = off)")
    p.add_argument("--incident-keep", type=int, default=4,
                   dest="incident_keep", metavar="K",
                   help="keep the newest K incident bundles under "
                        "<rundir>/incidents/ (the checkpoint keep-K "
                        "convention); the bundler arms itself once a rank "
                        "runs --blackbox")
    for dest, (flag, what) in _NOT_YET.items():
        kw = ({"action": "store_const", "const": True}
              if dest == "elastic" else {})
        p.add_argument(flag, dest=dest, default=None,
                       help=f"not in the port yet ({what}): refused", **kw)
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="command to run (prefix with --)")
    return p


def _rank_env(coordinator: str, rank: int, nprocs: int,
              attempt: int, inject: str = "") -> dict:
    env = dict(os.environ)
    if inject:
        env[faults.ENV_SPEC] = inject
    env["TPUDIST_COORDINATOR"] = coordinator
    env["TPUDIST_NUM_PROCESSES"] = str(nprocs)
    env["TPUDIST_PROCESS_ID"] = str(rank)
    env["TPUDIST_RESTART_COUNT"] = str(attempt)
    return env


def _maybe_bundler(args, telemetry, bundler):
    """The incident bundler, made once a rank's ``blackbox/`` dir exists
    (a run without ``--blackbox`` leaves no ``incidents/``); the one made
    before is returned as it is."""
    if bundler is not None or telemetry is None:
        return bundler
    from tpudist_torch.blackbox import IncidentBundler, blackbox_dir
    if not os.path.isdir(blackbox_dir(telemetry.outpath)):
        return None
    bundler = IncidentBundler(telemetry.outpath, telemetry=telemetry,
                              keep=args.incident_keep)
    # The launcher's own stream carries the fleet triggers; the lazy
    # stream has one sink slot (the fleet view may hold it): chain.
    if hasattr(telemetry, "add_sink"):
        telemetry.add_sink(bundler.observe)
    else:
        prev = telemetry.sink

        def _chained(ev, _prev=prev, _obs=bundler.observe):
            if _prev is not None:
                try:
                    _prev(ev)
                except Exception:   # noqa: BLE001 — a sink never fails emit
                    pass
            _obs(ev)

        telemetry.sink = _chained
    print(f"[tpudist_torch.launch] incident bundler armed "
          f"(keep {bundler.keep}, {bundler.dir})",
          file=sys.stderr, flush=True)
    return bundler


def _supervise_once(args, cmd, attempt: int, telemetry=None,
                    fleet=None, incidents: Optional[dict] = None) -> int:
    """Start every rank, wait for all of them, and return 0, or the exit
    code of the first rank that failed after tearing the others down
    (130 when the launcher itself was interrupted). About once a second
    it reads the ranks' heartbeats once, for the straggler check, the
    fleet view and its time series, and polls the incident bundler
    (``incidents["bundler"]``, made there once a rank runs
    ``--blackbox``)."""
    incidents = {} if incidents is None else incidents
    coordinator = args.coordinator or f"127.0.0.1:{find_free_port()}"
    procs: list[subprocess.Popen] = []
    # The ranks run in sessions of their own (so a teardown can signal
    # each whole process group); a signal to the launcher reaches them
    # through the teardown. Once it has begun, further signals are noted
    # and do not interrupt it.
    tearing_down = False
    interrupted = False

    def _on_signal(signum, frame):
        nonlocal interrupted
        interrupted = True
        if not tearing_down:
            raise KeyboardInterrupt

    prev_term = signal.signal(signal.SIGTERM, _on_signal)
    prev_int = signal.signal(signal.SIGINT, _on_signal)
    exit_code = 0
    if telemetry is not None:
        telemetry.emit("launcher_start", attempt=attempt,
                       nprocs=args.nprocs, coordinator=coordinator)
    rank_of: dict[int, int] = {}
    flagged: set[int] = set()
    # The fleet's series file opens once the run dir provably exists (the
    # ranks' heartbeats, or a live launcher stream), never before rank 0's
    # --overwrite handling.
    ts_recorder = None
    last_poll = time.monotonic()
    try:
        for rank in range(args.nprocs):
            procs.append(subprocess.Popen(
                cmd, env=_rank_env(coordinator, rank, args.nprocs, attempt,
                                   args.inject),
                start_new_session=True))
            rank_of[procs[-1].pid] = rank
        while procs:
            for pr in list(procs):
                rc = pr.poll()
                if rc is None:
                    continue
                procs.remove(pr)
                if rc != 0:
                    if telemetry is not None:
                        telemetry.emit("rank_exit", attempt=attempt,
                                       exit_rank=rank_of.get(pr.pid, -1),
                                       code=rc,
                                       classification=faults.classify_exit(
                                           rc))
                    exit_code = rc
                    tearing_down = True
                    _terminate_all(procs)
                    procs = []
                    break
            if procs and time.monotonic() - last_poll >= 1.0:
                last_poll = time.monotonic()
                if hasattr(telemetry, "flush"):
                    telemetry.flush()      # the lazy stream, once the dir is
                beats = None
                if telemetry is not None and (args.straggler_factor > 0
                                              or fleet is not None):
                    beats = telemetry_lib.read_heartbeats(
                        telemetry_lib.heartbeat_dir(telemetry.outpath))
                _check_stragglers(args, telemetry, attempt, flagged, beats)
                if fleet is not None:
                    fleet.refresh(attempt=attempt, beats=beats)
                    if ts_recorder is None and (
                            beats or getattr(telemetry, "_tel", True)
                            is not None):
                        from tpudist_torch.obs.tsdb import \
                            FleetSeriesRecorder
                        ts_recorder = FleetSeriesRecorder(
                            telemetry.outpath, attempt=attempt)
                    if ts_recorder is not None:
                        ts_recorder.sample(fleet, beats)
                bundler = incidents["bundler"] = _maybe_bundler(
                    args, telemetry, incidents.get("bundler"))
                if bundler is not None:
                    bundler.poll()
            if procs:
                time.sleep(0.2)
    except KeyboardInterrupt:
        tearing_down = True
        _terminate_all(procs)
        exit_code = 130
    finally:
        signal.signal(signal.SIGTERM, prev_term)
        signal.signal(signal.SIGINT, prev_int)
        if ts_recorder is not None:
            ts_recorder.sample(fleet, None)     # the closing counters
            ts_recorder.close()
    return 130 if interrupted else exit_code


def _check_stragglers(args, telemetry, attempt: int, flagged: set,
                      beats=None) -> list:
    """The ranks' heartbeats into straggler flags: a ``straggler`` event
    and a line once a rank an attempt. Returns every rank flagged by this
    read. Heartbeats exist only where the trainer runs ``--telemetry``;
    none is an empty read."""
    if telemetry is None or args.straggler_factor <= 0:
        return []
    if beats is None:
        beats = telemetry_lib.read_heartbeats(
            telemetry_lib.heartbeat_dir(telemetry.outpath))
    live = telemetry_lib.find_stragglers(beats, factor=args.straggler_factor,
                                         attempt=attempt)
    for st in live:
        rank = st["straggler_rank"]
        if rank in flagged:
            continue
        flagged.add(rank)
        print(f"[tpudist_torch.launch] straggler: rank {rank} per-step host "
              f"overhead p50 {st['host_p50_s'] * 1e3:.0f}ms vs fleet median "
              f"{st['median_others_s'] * 1e3:.0f}ms ({st['factor']:.1f}x, "
              f"attempt {attempt}) — investigate that host's input "
              f"pipeline/CPU before blaming the collective",
              file=sys.stderr, flush=True)
        telemetry.emit("straggler", attempt=attempt, straggler_rank=rank,
                       factor=st["factor"], host_p50_s=st["host_p50_s"],
                       median_others_s=st["median_others_s"])
    return live


class _LazyLauncherTelemetry:
    """The launcher's stream when the run dir is the command's outpath: it
    opens ``events.launcher.jsonl`` only once a rank has set the dir up
    (its ``heartbeats/`` exists), so rank 0's ``--overwrite`` handling
    never finds a dir the launcher made. Earlier events are kept (at most
    256, with their own times) and written on the first ready emit; the
    fleet view's sink sees every event at once."""

    _MAX_BUFFER = 256

    def __init__(self, outpath: str):
        self.outpath = outpath
        self._tel = None
        self._buf: list[tuple[float, str, dict]] = []
        self.sink = None

    def flush(self, force: bool = False) -> bool:
        """Open the stream and write the kept events once the dir exists
        (``force``, at the launcher's exit: make it, so a job that died
        before any rank set it up still leaves its timeline). True once
        the stream is live."""
        if self._tel is None:
            if not force and not os.path.isdir(
                    telemetry_lib.heartbeat_dir(self.outpath)):
                return False
            self._tel = telemetry_lib.Telemetry(
                self.outpath, rank=-1, attempt=0, name="launcher",
                heartbeat=False)
            for t0, etype, fields in self._buf:
                self._tel.emit(etype, t=t0, **fields)
            self._buf.clear()
        return True

    def emit(self, etype: str, **fields) -> None:
        if self.sink is not None:
            try:
                self.sink(dict(fields, t=time.time(), type=etype, rank=-1))
            except Exception:
                pass
        if not self.flush():
            if len(self._buf) < self._MAX_BUFFER:
                self._buf.append((time.time(), etype, fields))
            return
        self._tel.emit(etype, **fields)


def _launcher_telemetry(args, cmd):
    """The launcher's own stream: eager in an explicit ``--telemetry-dir``;
    else lazy in the command's ``--outpath`` when the command runs
    ``--telemetry``; else None (the launcher writes nothing)."""
    if args.telemetry_dir:
        return telemetry_lib.Telemetry(args.telemetry_dir, rank=-1,
                                       attempt=0, name="launcher",
                                       heartbeat=False)
    if "--telemetry" not in cmd:
        return None
    for i, tok in enumerate(cmd):
        if tok == "--outpath" and i + 1 < len(cmd):
            return _LazyLauncherTelemetry(cmd[i + 1])
        if tok.startswith("--outpath="):
            return _LazyLauncherTelemetry(tok.split("=", 1)[1])
    return None


def _fleet_metrics(args, telemetry, parser):
    """``--metrics-port``: a ``FleetMetrics`` fed by the launcher's own
    stream and refreshed by the supervision poll, behind an HTTP server
    whose ``/dashboard`` draws the fleet's series."""
    if args.metrics_port < 0:
        return None, None
    if telemetry is None:
        parser.error("--metrics-port needs a telemetry dir: pass "
                     "--telemetry-dir, or run a command with --telemetry "
                     "and an --outpath")
    from tpudist_torch.obs import dashboard
    from tpudist_torch.obs.server import FleetMetrics, MetricsServer
    fleet = FleetMetrics(telemetry.outpath, args.nprocs,
                         straggler_factor=args.straggler_factor)
    if hasattr(telemetry, "add_sink"):
        telemetry.add_sink(fleet.observe)
    else:
        telemetry.sink = fleet.observe
    # attempt 0, not None: a relaunch into a warm dir must not publish the
    # dead run's heartbeats.
    fleet.refresh(attempt=0)
    server = MetricsServer(
        fleet, port=args.metrics_port,
        dashboard=dashboard.live_renderer(telemetry.outpath)).start()
    print(f"[tpudist_torch.launch] fleet metrics on :{server.port} "
          f"(/metrics, /dashboard)", file=sys.stderr, flush=True)
    return fleet, server


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        p.error("no command given (append: -- python -m tpudist_torch ...)")
    if args.nprocs < 1:
        p.error("--nprocs must be >= 1")
    if args.max_restarts < 0:
        p.error("--max-restarts must be >= 0 (there is no infinite mode: "
                "an unrecoverable fault would relaunch forever)")
    if args.incident_keep < 1:
        p.error("--incident-keep must be >= 1 (0 would delete every "
                "bundle the moment it lands)")
    refused = [f"{flag} ({what})" for dest, (flag, what)
               in _NOT_YET.items() if getattr(args, dest) is not None]
    if refused:
        p.error("unsupported in tpudist_torch.launch: "
                + "; ".join(refused))
    if args.inject:
        try:
            faults.check_spec(args.inject)      # fail fast on a typo
        except ValueError as e:
            p.error(f"unsupported in tpudist_torch.launch: --inject "
                    f"{args.inject!r}: {e}")
    telemetry = _launcher_telemetry(args, cmd)
    fleet, server = _fleet_metrics(args, telemetry, p)
    incidents: dict = {}
    attempt = 0
    try:
        while True:
            exit_code = _supervise_once(args, cmd, attempt, telemetry, fleet,
                                        incidents)
            if exit_code in (0, 130):
                return exit_code
            why = faults.classify_exit(exit_code)
            if attempt >= args.max_restarts:
                print(f"[tpudist_torch.launch] job failed (exit "
                      f"{exit_code}: {why}) — restart budget exhausted",
                      file=sys.stderr, flush=True)
                return exit_code
            attempt += 1
            print(f"[tpudist_torch.launch] job failed (exit {exit_code}: "
                  f"{why}) — restart {attempt}/{args.max_restarts}",
                  file=sys.stderr, flush=True)
            if telemetry is not None:
                telemetry.emit("restart", attempt=attempt,
                               prev_exit=exit_code)
    finally:
        if hasattr(telemetry, "flush"):
            telemetry.flush(force=True)    # the job is over: land the events
        # The last sweep: dumps the ranks wrote as they went down.
        bundler = _maybe_bundler(args, telemetry, incidents.get("bundler"))
        if bundler is not None:
            bundler.close()
        if server is not None:
            server.close()


if __name__ == "__main__":
    sys.exit(main())
