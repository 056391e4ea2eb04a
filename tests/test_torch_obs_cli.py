"""The observability flags of the port's entry points, driven on the CPU.

- ``python -m tpudist_torch --telemetry --metrics-port 0
  --telemetry-max-mb ... --profile 1:3`` (one tiny resnet18 run): its
  endpoint, found through its port file and scraped while it trains,
  agrees with the events it wrote (mirrors tpudist's
  ``test_trainer_metrics_endpoint_consistent_with_events``); the rotated
  and live event files hold every step; the window wrote one Chrome trace
  with exactly 2 ``train`` ranges.
- ``launch._check_stragglers`` over written heartbeat files flags only the
  slow rank, once.
- ``python -m tpudist_torch.launch -n 1|2 --telemetry-dir D
  --metrics-port 0`` over a trivial child is scraped (tpudist's
  ``test_launch_fleet_metrics_endpoint``), and its ``/dashboard`` answers.
- The serve CLI's endpoint counts the requests it served.
- Slow tier: a 2-rank launch with ``slow_peer`` on rank 1 and
  ``--straggler-factor 3`` names rank 1 (tpudist's
  ``test_launch_flags_slow_peer_straggler``).
"""

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401

pytest.importorskip("jax")

from tpudist.summarize import load_events  # noqa: E402

from tpudist_torch import __main__ as cli  # noqa: E402
from tpudist_torch import launch, telemetry  # noqa: E402
from tpudist_torch.obs import server  # noqa: E402
from tpudist_torch.serve import __main__ as serve_cli  # noqa: E402

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# A cap the run's events overflow once (and not twice): 8 steps' events
# and the rest, ≈ 4–6 KB.
MAX_MB = "0.003"


def _parse_prom(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, val = line.rsplit(" ", 1)
            out[key] = float(val)
    return out


@pytest.fixture(scope="module")
def observed_run(tmp_path_factory):
    """One tiny CPU run with every observability flag, scraped through its
    port file while it trains: (outpath, [(t_before, t_after, text)],
    stdout)."""
    out = str(tmp_path_factory.mktemp("obs") / "run")
    argv = ["--device", "cpu", "--synthetic", "-a", "resnet18",
            "--num-classes", "4", "--image-size", "32", "-b", "16",
            "--synthetic-size", "64", "--epochs", "2", "--step", "1",
            "-p", "1", "--seed", "0", "--keep-checkpoints", "0",
            "--telemetry", "--metrics-port", "0", "--telemetry-max-mb",
            MAX_MB, "--profile", "1:3", "--outpath", out]
    scrapes, stop = [], threading.Event()

    def scraper():
        portfile = server.portfile_path(out, 0)
        while not stop.is_set():
            try:
                port = int(open(portfile).read())
                t0 = time.time()
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics", timeout=2) as r:
                    text = r.read().decode()
                scrapes.append((t0, time.time(), text))
            except (OSError, ValueError):
                pass
            time.sleep(0.02)

    th = threading.Thread(target=scraper, daemon=True)
    th.start()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            assert cli.main(argv) == 0
    finally:
        stop.set()
        th.join(timeout=10)
    return out, scrapes, buf.getvalue()


def test_endpoint_agrees_with_the_event_stream(observed_run):
    out, scrapes, text = observed_run
    assert "=> live metrics on :" in open(os.path.join(
        out, "experiment.log")).read()
    assert not os.path.exists(server.portfile_path(out, 0))   # closed
    steps = [e for e in load_events(out, strict=True) if e["type"] == "step"]
    assert len(steps) == 8
    seen = [(t0, t1, _parse_prom(s)) for t0, t1, s in scrapes
            if "tpudist_last_step" in s]
    assert seen, "no scrape saw a completed step"
    for t0, t1, m in seen:
        lo = sum(e["t"] < t0 for e in steps)
        hi = sum(e["t"] <= t1 for e in steps)
        n = int(m["tpudist_steps_total"])
        assert lo - 1 <= n <= hi, (lo, n, hi)
        assert m["tpudist_last_step"] == steps[n - 1]["step"]
    assert max(int(m["tpudist_steps_total"]) for _, _, m in seen) >= 4


def test_rotated_and_live_files_hold_every_step(observed_run):
    out = observed_run[0]
    rotated = os.path.join(out, "events.0.1.jsonl")
    assert os.path.exists(rotated)
    limit = float(MAX_MB) * 2**20
    assert os.path.getsize(os.path.join(out, "events.0.jsonl")) < limit + 2048
    steps = sorted(e["step"] for e in load_events(out, strict=True)
                   if e["type"] == "step")
    assert steps == list(range(8))
    assert any(json.loads(ln)["type"] == "step" for ln in open(rotated))


def test_profile_window_writes_one_trace_of_two_steps(observed_run):
    out = observed_run[0]
    d = os.path.join(out, "profile", "attempt_0")
    assert os.listdir(d) == ["steps1-2.pt.trace.json"]
    with open(os.path.join(d, "steps1-2.pt.trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events if e.get("ph") == "X"]
    assert names.count("train") == 2
    assert names.count("tpudist.h2d") == 2
    assert "tpudist.data_wait" in names and "tpudist.metric_drain" in names


def test_check_stragglers_flags_only_the_slow_rank(tmp_path):
    """Heartbeats of 3 ranks, rank 2 slow: flagged once (a line and a
    ``straggler`` event), never again this attempt; factor 0 is off."""
    rundir = str(tmp_path)
    for rank, host in ((0, 0.01), (1, 0.012), (2, 0.4)):
        tel = telemetry.Telemetry(rundir, rank=rank, heartbeat_interval_s=0)
        for s in range(5):
            tel.step(step=s, epoch=0, data_s=0.0, h2d_s=0.0, compute_s=0.05,
                     drain_s=0.0, step_s=0.05 + host)
        tel.close()
    ltel = telemetry.Telemetry(rundir, rank=-1, attempt=0, name="launcher",
                               heartbeat=False)
    args = argparse.Namespace(straggler_factor=4.0)
    flagged: set = set()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        live = launch._check_stragglers(args, ltel, 0, flagged)
        again = launch._check_stragglers(args, ltel, 0, flagged)
    assert [s["straggler_rank"] for s in live] == [2] == \
        [s["straggler_rank"] for s in again]
    assert err.getvalue().count("straggler: rank 2") == 1
    assert "rank 0" not in err.getvalue() and "rank 1" not in err.getvalue()
    events = [json.loads(ln) for ln in open(os.path.join(
        rundir, "events.launcher.jsonl"))]
    assert [(e["type"], e["straggler_rank"]) for e in events] == \
        [("straggler", 2)]
    assert events[0]["factor"] > 4
    assert launch._check_stragglers(argparse.Namespace(straggler_factor=0),
                                    ltel, 0, set()) == []


_FLEET_CHILD = r"""
import os, time
from tpudist_torch.telemetry import Telemetry
rank = int(os.environ["TPUDIST_PROCESS_ID"])
tel = Telemetry(os.environ["TPUDIST_TEST_OUT"], rank=rank)
for s in range(30):
    tel.step(step=s, epoch=0, data_s=0.0, h2d_s=0.0, compute_s=0.01,
             drain_s=0.0, step_s=0.1)
    time.sleep(0.1)
tel.close()
print(f"RANK{rank}_DONE", flush=True)
"""


@pytest.mark.parametrize("nprocs", [1, 2])
def test_launcher_fleet_endpoint_and_dashboard(tmp_path, nprocs):
    out = tmp_path / "run"
    out.mkdir()
    env = dict(os.environ, TPUDIST_TEST_OUT=str(out))
    last = nprocs - 1
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpudist_torch.launch", "-n", str(nprocs),
         "--telemetry-dir", str(out), "--metrics-port", "0",
         "--", sys.executable, "-c", _FLEET_CHILD],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        port, deadline = None, time.time() + 60
        while time.time() < deadline:
            m = re.search(r"fleet metrics on :(\d+)",
                          proc.stderr.readline() or "")
            if m:
                port = int(m.group(1))
                break
        assert port, "the launcher never announced its fleet endpoint"
        text = ""
        while time.time() < deadline and proc.poll() is None:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics", timeout=2) as r:
                    text = r.read().decode()
            except OSError:
                text = ""
            if f'tpudist_rank_last_step{{rank="{last}"}}' in text:
                break
            time.sleep(0.3)
        assert f"tpudist_fleet_nprocs {nprocs}" in text, text[-2000:]
        assert 'tpudist_rank_last_step{rank="0"}' in text, text[-2000:]
        assert 'tpudist_straggler{rank="0"} 0' in text
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/dashboard",
                                    timeout=5) as r:
            page = r.read().decode()
        assert page.startswith("<!doctype html>") and "tpudist console" \
            in page
        stdout, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.terminate()
            proc.wait(timeout=30)
    assert proc.returncode == 0
    assert all(f"RANK{r}_DONE" in stdout for r in range(nprocs))
    events = [json.loads(ln) for ln in
              (out / "events.launcher.jsonl").read_text().splitlines()]
    for ev in events:
        telemetry.validate_event(ev)
    assert [e["type"] for e in events] == ["launcher_start"]
    assert events[0]["nprocs"] == nprocs
    assert (out / "fleet_ts.0.jsonl").exists()


def test_serve_endpoint_counts_the_requests_it_served(tmp_path,
                                                      monkeypatch):
    """The endpoint is scraped as it closes (after ``run_end``): its
    request counter is the summary's request count."""
    final = []
    close = server.MetricsServer.close

    def scrape_then_close(self):
        with urllib.request.urlopen(f"http://127.0.0.1:{self.port}/metrics",
                                    timeout=5) as r:
            final.append(r.read().decode())
        close(self)

    monkeypatch.setattr(server.MetricsServer, "close", scrape_then_close)
    out = str(tmp_path / "srv")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_cli.main(["--device", "cpu", "-a", "resnet18",
                             "--num-classes", "8", "--image-size", "32",
                             "--buckets", "1,2", "--load-rate", "40",
                             "--load-duration", "1", "--telemetry",
                             "--metrics-port", "0", "--outpath", out])
    assert rc == 0
    text = buf.getvalue()
    summary = json.loads(text.split("SERVE_SUMMARY ", 1)[1])
    assert "=> serve metrics on :" in text
    m = _parse_prom(final[0])
    assert summary["n_requests"] > 10
    assert m["tpudist_serve_requests_total"] == summary["n_requests"]
    assert m["tpudist_serve_request_errors_total"] == 0
    assert m["tpudist_run_ended"] == 1
    assert not os.path.exists(server.portfile_path(out, 0))


_STRAGGLER_CHILD = r"""
import os, time
import torch
from tpudist_torch import faults
from tpudist_torch.telemetry import Telemetry
rank = int(os.environ["TPUDIST_PROCESS_ID"])
tel = Telemetry(os.environ["TPUDIST_TEST_OUT"], rank=rank)
x = torch.ones(128, 128)
t_prev = time.time()
for s in range(14):
    faults.maybe_slow_peer(s)          # the injected rank stalls host-side
    t_c = time.time()
    (x @ x).sum().item()
    compute_s = time.time() - t_c
    step_s = time.time() - t_prev
    tel.step(step=s, epoch=0, data_s=0.0, h2d_s=0.0, compute_s=compute_s,
             drain_s=0.0, step_s=step_s,
             compile_s=step_s if s == 0 else 0.0)
    t_prev = time.time()
tel.close()
print(f"RANK{rank}_STEPS_DONE", flush=True)
"""


@pytest.mark.slow
def test_launch_flags_slow_peer_straggler(tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    env = dict(os.environ, TPUDIST_TEST_OUT=str(out), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "tpudist_torch.launch", "--nprocs", "2",
         "--telemetry-dir", str(out), "--straggler-factor", "3",
         "--inject", "slow_peer:ms=400@rank=1",
         "--", sys.executable, "-c", _STRAGGLER_CHILD],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    assert "RANK0_STEPS_DONE" in r.stdout and "RANK1_STEPS_DONE" in r.stdout
    assert "straggler: rank 1" in r.stderr, r.stderr[-3000:]
    assert "straggler: rank 0" not in r.stderr
    levents = [json.loads(ln) for ln in
               (out / "events.launcher.jsonl").read_text().splitlines()]
    for ev in levents:
        telemetry.validate_event(ev)
    assert any(e["type"] == "launcher_start" for e in levents)
    flags = [e for e in levents if e["type"] == "straggler"]
    assert len(flags) == 1 and flags[0]["straggler_rank"] == 1
    assert flags[0]["factor"] >= 3.0
    from tpudist.summarize import analyze
    a = analyze(load_events(str(out), strict=True))
    assert set(a["ranks"]) == {0, 1}
    assert [s["straggler_rank"] for s in a["stragglers"]] == [1]
