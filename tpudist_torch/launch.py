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

tpudist's other launcher flags (the elastic gang and its
``--drain-grace``, launcher telemetry, metrics, straggler and collective
watchdogs, scale-up, incident bundles, and the JAX platform flags) are
accepted by name and refused when set::

    python -m tpudist_torch.launch -n 1 -- python -m tpudist_torch \\
        --distributed -a resnet18 --use_amp --fused-bn on -b 256 --synthetic
    python -m tpudist_torch.launch -n 2 -- python -m tpudist_torch \\
        --distributed --device cpu --synthetic -a resnet18 -b 16 ...
    python -m tpudist_torch.launch -n 1 --max-restarts 2 -- python -m \\
        tpudist_torch --distributed ... --resume auto --overwrite keep
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

from tpudist_torch import faults

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
    "telemetry_dir": ("--telemetry-dir", "the launcher's telemetry"),
    "metrics_port": ("--metrics-port", "the fleet metrics endpoint"),
    "straggler_factor": ("--straggler-factor", "straggler detection"),
    "evict_stragglers": ("--evict-stragglers", "straggler eviction"),
    "scale_up": ("--scale-up", "elastic scale-up"),
    "collective_deadline": ("--collective-deadline",
                            "the dead-collective watchdog"),
    "incident_keep": ("--incident-keep", "incident bundles (blackbox.py)"),
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


def _supervise_once(args, cmd, attempt: int) -> int:
    """Start every rank, wait for all of them, and return 0, or the exit
    code of the first rank that failed after tearing the others down
    (130 when the launcher itself was interrupted)."""
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
    try:
        for rank in range(args.nprocs):
            procs.append(subprocess.Popen(
                cmd, env=_rank_env(coordinator, rank, args.nprocs, attempt,
                                   args.inject),
                start_new_session=True))
        while procs:
            for pr in list(procs):
                rc = pr.poll()
                if rc is None:
                    continue
                procs.remove(pr)
                if rc != 0:
                    exit_code = rc
                    tearing_down = True
                    _terminate_all(procs)
                    procs = []
                    break
            if procs:
                time.sleep(0.2)
    except KeyboardInterrupt:
        tearing_down = True
        _terminate_all(procs)
        exit_code = 130
    finally:
        signal.signal(signal.SIGTERM, prev_term)
        signal.signal(signal.SIGINT, prev_int)
    return 130 if interrupted else exit_code


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
    attempt = 0
    while True:
        exit_code = _supervise_once(args, cmd, attempt)
        if exit_code in (0, 130):
            return exit_code
        why = faults.classify_exit(exit_code)
        if attempt >= args.max_restarts:
            print(f"[tpudist_torch.launch] job failed (exit {exit_code}: "
                  f"{why}) — restart budget exhausted", file=sys.stderr,
                  flush=True)
            return exit_code
        attempt += 1
        print(f"[tpudist_torch.launch] job failed (exit {exit_code}: {why}) "
              f"— restart {attempt}/{args.max_restarts}", file=sys.stderr,
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
