"""The port's observability plane held against tpudist's, on the CPU.

- ``obs.server.MetricsRegistry``: the same seeded event stream (step,
  compile, eval, epoch, checkpoint, fault, preempt, request, serve_batch,
  serve_start, run_end) into tpudist's registry and the port's gives the
  same ``render()`` and ``snapshot()``, exactly: both are read with the
  wall clock stopped at one instant (``_clock_stopped``), so the gauges
  that read it (``heartbeat_age_s``, a live run's ``wall_s``/``goodput``,
  the windowed ``req_per_s``) must agree to the last digit too.
- ``FleetMetrics`` over a heartbeat directory that the port's
  ``Telemetry`` wrote for 2 ranks (one slow), with a rank endpoint to
  scrape; ``find_stragglers``; the tsdb's rows, rotation and ``query``;
  the dashboard's HTML: each the same as tpudist's.
- A rotated port event stream, read by ``tpudist.summarize``'s loader,
  has every step; ``parse_window`` matches tpudist's on a table of specs,
  the errors included; ``straggle`` fires and notifies as tpudist's.
"""

import contextlib
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401

pytest.importorskip("jax")

from tpudist import faults as jax_faults  # noqa: E402
from tpudist import telemetry as jax_telemetry  # noqa: E402
from tpudist.obs import dashboard as jax_dashboard  # noqa: E402
from tpudist.obs import server as jax_server  # noqa: E402
from tpudist.obs import tsdb as jax_tsdb  # noqa: E402
from tpudist.summarize import load_events  # noqa: E402
from tpudist.utils import profiling as jax_profiling  # noqa: E402

from tpudist_torch import faults  # noqa: E402
from tpudist_torch import telemetry  # noqa: E402
from tpudist_torch.obs import dashboard, server, tsdb  # noqa: E402
from tpudist_torch.utils import profiling  # noqa: E402

pytestmark = pytest.mark.torch_port



def _parse_prom(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, val = line.rsplit(" ", 1)
            out[key] = float(val)
    return out


@contextlib.contextmanager
def _clock_stopped():
    """``time.time()`` returns one instant inside the block, for tpudist's
    server and the port's alike (each reads the clock through it)."""
    now = time.time()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(time, "time", lambda: now)
        yield


def _same_exposition(ours: str, theirs: str) -> None:
    """The same text, line for line: HELP/TYPE lines, keys, order, values."""
    assert ours.splitlines() == theirs.splitlines()


def _event_stream(seed: int, kind: str) -> list[dict]:
    """A seeded stream of schema-valid events, timestamps in the last
    minute (so the serving rate's window holds them)."""
    rng = np.random.default_rng(seed)
    t = time.time() - 50.0
    evs = []

    def ev(etype, **fields):
        nonlocal t
        t += float(rng.uniform(0.01, 0.2))
        e = {"t": round(t, 6), "type": etype, "rank": 0, "attempt": 0,
             **fields}
        telemetry.validate_event(e)
        jax_telemetry.validate_event(e)
        evs.append(e)

    r = lambda lo, hi: round(float(rng.uniform(lo, hi)), 6)  # noqa: E731
    if kind in ("train", "train_live", "faults"):
        ev("run_start", platform="gpu", n_devices=1, arch="resnet18",
           global_batch=256, device_kind="NVIDIA H100 80GB HBM3",
           init_s=r(0.5, 2))
        ev("compile", seconds=r(1, 3), phase="kernel_build")
        for step in range(int(rng.integers(6, 14))):
            if step == 0:
                ev("compile", seconds=r(0.5, 1), phase="train_step",
                   step=step)
            ev("step", step=step, epoch=step // 5, data_s=r(0, 0.01),
               h2d_s=r(0, 0.002), compute_s=r(0.05, 0.1),
               drain_s=r(0, 0.003), step_s=r(0.1, 0.2),
               prefetch_s=r(0, 0.001), drain_ovl_s=r(0, 0.001))
            if kind == "faults" and step in (2, 5):
                ev("fault", point="slow_peer" if step == 2
                   else "checkpoint_quarantine", step=step)
            if step % 5 == 4:
                ev("eval", epoch=step // 5, seconds=r(0.5, 1), acc1=r(0, 1))
                ev("checkpoint_save", seconds=r(0.1, 1), kind="epoch",
                   epoch=step // 5)
                ev("epoch", epoch=step // 5, seconds=r(1, 2),
                   samples_skipped=int(rng.integers(0, 3)),
                   samples_retried=int(rng.integers(0, 3)))
        if kind == "faults":
            ev("checkpoint_restore", seconds=r(0.1, 1), path="/x/c.msgpack")
            ev("preempt", signal="SIGTERM", epoch=1)
        if kind != "train_live":
            ev("run_end", wall_s=r(30, 60), productive_s=r(1, 2),
               goodput=r(0, 0.1), init_s=r(0.5, 2), compile_s=r(1, 3),
               steps=len([e for e in evs if e["type"] == "step"]))
    else:                                              # serve
        ev("run_start", platform="gpu", n_devices=1, arch="vit_b_16",
           global_batch=8, mode="serve")
        ev("serve_start", n_buckets=4, aot_s=r(1, 5), cache="off")
        for _ in range(int(rng.integers(20, 40))):
            b = int(rng.choice([1, 2, 4, 8]))
            ev("serve_batch", bucket=b, n_valid=int(rng.integers(1, b + 1)),
               batch_s=r(0.001, 0.01), queue_depth=int(rng.integers(0, 5)))
            if rng.uniform() < 0.1:
                ev("request", latency_s=r(0.001, 0.05), error=1)
            else:
                ev("request", latency_s=r(0.001, 0.05))
        ev("run_end", wall_s=r(10, 20), productive_s=0.0, goodput=0.0,
           mode="serve")
    return evs


@pytest.mark.parametrize("seed,kind", [(0, "train"), (1, "train_live"),
                                       (2, "faults"), (3, "serve")])
def test_registry_renders_as_tpudists(seed, kind):
    evs = _event_stream(seed, kind)
    ours, theirs = server.MetricsRegistry(rank=0), \
        jax_server.MetricsRegistry(rank=0)
    for e in evs:
        ours.observe(dict(e))
        theirs.observe(dict(e))
    with _clock_stopped():
        assert ours.snapshot() == theirs.snapshot()
        _same_exposition(ours.render(), theirs.render())
    assert "tpudist_steps_total" in ours.render()


def _two_rank_heartbeats(rundir: str, slow: float = 0.3) -> None:
    """Heartbeats of 2 ranks written by the port's ``Telemetry``: rank 1's
    host time per step is ``slow`` seconds, rank 0's 10 ms."""
    for rank, host in ((0, 0.01), (1, slow)):
        tel = telemetry.Telemetry(rundir, rank=rank, heartbeat_interval_s=0)
        for s in range(6):
            tel.step(step=s, epoch=0, data_s=0.0, h2d_s=0.0, compute_s=0.05,
                     drain_s=0.0, step_s=0.05 + host,
                     compile_s=0.05 if s == 0 else 0.0)
        tel.close()


def test_fleet_view_renders_as_tpudists(tmp_path):
    """Over the same heartbeats and launcher events, with rank 0's live
    endpoint discovered through its port file and scraped."""
    rundir = str(tmp_path)
    _two_rank_heartbeats(rundir)
    reg = server.MetricsRegistry(rank=0)
    for e in _event_stream(4, "train"):
        reg.observe(e)
    rank_srv = server.MetricsServer(reg, port=0).start()
    rank_srv.write_portfile(rundir, 0)
    launcher = [
        {"t": time.time(), "type": "launcher_start", "rank": -1,
         "attempt": 0, "nprocs": 2},
        {"t": time.time(), "type": "rank_exit", "rank": -1, "attempt": 0,
         "code": 41, "classification": "crash (exit 41)", "exit_rank": 1},
        {"t": time.time(), "type": "restart", "rank": -1, "attempt": 1},
        {"t": time.time(), "type": "straggler", "rank": -1, "attempt": 0,
         "straggler_rank": 1, "factor": 30.0}]
    try:
        fleets = []
        with _clock_stopped():
            for mod in (server, jax_server):
                fleet = mod.FleetMetrics(rundir, 2, straggler_factor=4.0)
                for e in launcher:
                    fleet.observe(dict(e))
                fleet.refresh(attempt=0)
                deadline = time.monotonic() + 10
                while fleet._scraping and time.monotonic() < deadline:
                    time.sleep(0.02)
                fleet.refresh(attempt=0)
                fleets.append(fleet)
        ours, theirs = fleets
        _same_exposition(ours.render(), theirs.render())
        m = _parse_prom(ours.render())
        assert m['tpudist_straggler{rank="1"}'] == 1
        assert m['tpudist_straggler{rank="0"}'] == 0
        assert m['tpudist_rank_last_step{rank="1"}'] == 5
        assert m['tpudist_rank_steps_total{rank="0"}'] > 0
        g_ours, g_theirs = ours.gauges(), theirs.gauges()
        assert g_ours == g_theirs
        assert ours.snapshot() == theirs.snapshot()
    finally:
        rank_srv.close()
    assert not os.path.exists(server.portfile_path(rundir, 0))


@pytest.mark.parametrize("factor", [0.5, 3.0, 4.0, 40.0])
def test_find_stragglers_as_tpudists(tmp_path, factor):
    _two_rank_heartbeats(str(tmp_path))
    beats = telemetry.read_heartbeats(telemetry.heartbeat_dir(str(tmp_path)))
    assert beats == jax_telemetry.read_heartbeats(
        jax_telemetry.heartbeat_dir(str(tmp_path)))
    now = time.time()
    table = {r: dict(b, updated_at=now) for r, b in beats.items()}
    table[2] = dict(table[0], rank=2, host_p50=0.012)
    table[3] = dict(table[0], rank=3, host_p50=0.2, attempt=1)
    for kw in ({}, {"attempt": 0}, {"attempt": 1}, {"min_host_s": 0.5}):
        got = telemetry.find_stragglers(table, factor=factor, **kw)
        assert got == jax_telemetry.find_stragglers(table, factor=factor,
                                                    **kw)
    flagged = [s["straggler_rank"] for s in
               telemetry.find_stragglers(table, factor=factor, attempt=0)]
    assert flagged == ([1] if factor < 20 else [])


def test_tsdb_rows_rotation_and_query_as_tpudists(tmp_path):
    rundir = str(tmp_path)
    _two_rank_heartbeats(rundir)
    beats = telemetry.read_heartbeats(telemetry.heartbeat_dir(rundir))
    fleets = {}
    for name, mod in (("ours", server), ("theirs", jax_server)):
        fleet = mod.FleetMetrics(rundir, 2)
        fleet.observe({"t": 1.0, "type": "launcher_start", "rank": -1,
                       "attempt": 0, "nprocs": 2})
        fleets[name] = fleet
    t0 = 1_700_000_000.0
    rows = {}
    for name, mod in (("ours", tsdb), ("theirs", jax_tsdb)):
        d = os.path.join(rundir, name)
        rec = mod.FleetSeriesRecorder(d, attempt=0, max_mb=0.001)
        for i in range(40):
            rec.sample(fleets[name], beats, now=t0 + i)
        rec.close()
        assert os.path.exists(mod.rotated_path(mod.ts_path(d, 0)))
        assert mod.latest_path(d) == mod.ts_path(d, 0)
        rows[name] = mod.load_rows(mod.ts_path(d, 0))
    assert rows["ours"] == rows["theirs"] and rows["ours"]
    assert rows["ours"][-1]["stragglers"] == 0
    assert rows["ours"][-1]["alive"] == 2
    for window, names in ((None, None), (10.0, None),
                          (5.0, ["alive", "host_p50_s", "nope"])):
        assert tsdb.query(rows["ours"], window=window, names=names) == \
            jax_tsdb.query(rows["theirs"], window=window, names=names)


def test_dashboard_html_as_tpudists(tmp_path):
    """The same bench history (a gate band and a regression) and the same
    fleet series render the same page; with no history named, the port
    draws none (it never reads the JAX package's TPU history)."""
    hist = tmp_path / "history.jsonl"
    rows = [{"metric": "resnet18_img_s", "per_device_batch": 256,
             "value": v, "unit": "images/sec"} for v in (100, 104, 99, 70)]
    rows += [{"metric": "flash_ms", "value": v, "unit": "ms"}
             for v in (1.0, 1.02, 0.99)]
    hist.write_text("".join(json.dumps(r) + "\n" for r in rows))
    live = str(tmp_path / "fleet_ts.0.jsonl")
    with open(live, "w") as f:
        for i in range(5):
            f.write(json.dumps({"t": 1000.0 + i, "attempt": 0, "alive": 2,
                                "world": 2, "step_p50_s": 0.1 + i / 100})
                    + "\n")
    kw = dict(live_path=live, refresh_s=5)
    ours = dashboard.render_history_file(history=str(hist), **kw)
    assert ours == jax_dashboard.render_history_file(history=str(hist), **kw)
    assert 'data-regressions="1"' in ours and "fleet (live" in ours
    assert dashboard.render(history_rows=dashboard.load_history(str(hist)),
                            window=3, threshold=0.2) == \
        jax_dashboard.render(history_rows=dashboard.load_history(str(hist)),
                             window=3, threshold=0.2)
    assert 'data-series="0"' in dashboard.render_history_file(live_path=live)


def test_rotated_port_stream_reads_every_step_in_summarize(tmp_path):
    tel = telemetry.Telemetry(str(tmp_path), rank=0, max_mb=0.003)
    tel.emit("run_start", platform="cpu", n_devices=1, arch="resnet18",
             global_batch=16)
    for s in range(20):
        tel.step(step=s, epoch=0, data_s=0.001, h2d_s=0.0, compute_s=0.01,
                 drain_s=0.0, step_s=0.02, compile_s=0.01 if s == 0 else 0)
    tel.close()
    assert os.path.exists(tel.rotated_path())
    assert tel.rotated_path().endswith("events.0.1.jsonl")
    events = load_events(str(tmp_path), strict=True)
    assert [e["step"] for e in events if e["type"] == "step"] == \
        list(range(20))
    assert events[-1]["type"] == "run_end"


@pytest.mark.parametrize("spec", ["", "5", "0:1", "10:20", "3:3", "7:2",
                                  "a:b", "4:", "1:2:3", "-2:1"])
def test_parse_window_as_tpudists(spec):
    def call(fn):
        try:
            return fn(spec)
        except ValueError as e:
            return ("error", str(e))
    assert call(profiling.parse_window) == call(jax_profiling.parse_window)


def test_straggle_fires_from_step_and_notifies(monkeypatch):
    """As tpudist's: every step from ``from=`` on, rank-gated, each firing
    notified; the same steps as tpudist's injector."""
    for mod in (faults, jax_faults):
        seen = []
        mod.set_observer(lambda point, step, info: seen.append((point, step)))
        try:
            mod.configure("straggle:ms=1,from=3")
            for s in range(6):
                mod.maybe_straggle(s)
            assert [s for p, s in seen if p == "straggle"] == [3, 4, 5]
            inj = mod.get_injector().should_fire("straggle", consume=False)
            assert inj.fired == 3
            seen.clear()
            monkeypatch.setenv(mod.ENV_RANK, "2")
            mod.configure("straggle:ms=1@rank=1")
            mod.maybe_straggle(0)
            assert not seen
            monkeypatch.setenv(mod.ENV_RANK, "1")
            mod.configure("straggle:ms=1@rank=1")
            mod.maybe_straggle(0)
            assert seen == [("straggle", 0)]
        finally:
            mod.set_observer(None)
            mod.configure("")
    assert "straggle" in faults.POINTS


def test_metrics_server_serves_text_health_and_no_dashboard(tmp_path):
    reg = server.MetricsRegistry(rank=3)
    for e in _event_stream(5, "train"):
        reg.observe(e)
    srv = server.MetricsServer(reg, port=0).start()
    try:
        path = srv.write_portfile(str(tmp_path), 3)
        assert int(open(path).read()) == srv.port
        url = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(f"{url}/metrics", timeout=5) as r:
            assert "text/plain" in r.headers["Content-Type"]
            m = _parse_prom(r.read().decode())
        assert m["tpudist_steps_total"] == reg.snapshot()["steps_total"]
        with urllib.request.urlopen(f"{url}/healthz", timeout=5) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["rank"] == 3
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{url}/dashboard", timeout=5)
        assert e.value.code == 404
    finally:
        srv.close()
    assert not os.path.exists(server.portfile_path(str(tmp_path), 3))
