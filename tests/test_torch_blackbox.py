"""The port's flight recorder (``tpudist_torch/blackbox.py``), ``POST
/capture`` and a doctor run's events against tpudist's, on the CPU.

- ``BlackboxRecorder`` and tpudist's, each a sink of its own telemetry,
  fed the same events: the same ring (its depth, its filter), the same
  dumps (trigger, step, detail, counts, the ring's events), the same
  ``incident`` events (captured or cooldown-suppressed, per class), the
  same manual trigger; the deep capture is one ``torch.profiler`` trace
  of ``--blackbox-capture-steps`` steps, and none while another profiler
  records (the ``--profile`` window), the dump kept.
- ``IncidentBundler`` and tpudist's over the same rank dumps, run events
  and launcher triggers: the same bundles (ids, manifests, copied dumps,
  ``events.jsonl``), the same coalescing, retention and size cap, and
  ``format_incident`` reads either's bundle alike; the CLI lists and
  reports, and refuses ``report --trace`` by name.
- ``POST /capture`` on the port's ``MetricsServer``: 404 without a hook,
  202 with one.
- A CPU doctor run (``--doctor --blackbox``, ``nanbomb`` then
  ``lossbomb``): every event it writes is valid to tpudist's schema,
  ``tpudist.summarize`` reads its doctor, SDC-probe and incident sections
  as it reads tpudist's, the doctor's replay state rides its checkpoints
  (read by tpudist's loader, and re-armed by a resumed port run), and the
  launcher bundles a ``--blackbox`` rank's dumps under ``--incident-keep``.
"""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

pytest.importorskip("jax")

from tpudist import blackbox as jax_bb  # noqa: E402
from tpudist import checkpoint as jax_ckpt  # noqa: E402
from tpudist import telemetry as jax_tel  # noqa: E402
from tpudist.summarize import analyze, format_report, load_events  # noqa: E402

from tpudist_torch import __main__ as cli  # noqa: E402
from tpudist_torch import blackbox as bb  # noqa: E402
from tpudist_torch import faults  # noqa: E402
from tpudist_torch import telemetry as port_tel  # noqa: E402
from tpudist_torch.obs.server import MetricsRegistry, MetricsServer  # noqa: E402
from tpudist_torch.utils.profiling import StepProfiler  # noqa: E402

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_current():
    port_tel.set_current(None)
    faults.configure("")
    yield
    port_tel.set_current(None)
    faults.configure("")


def _pair(tmp_path, **kw):
    """(port telemetry + recorder, tpudist's) in two run dirs."""
    out = []
    for name, tel_mod, mod in (("port", port_tel, bb),
                               ("jax", jax_tel, jax_bb)):
        d = str(tmp_path / name)
        tel = tel_mod.Telemetry(d, rank=0, attempt=0, heartbeat=False)
        rec = mod.BlackboxRecorder(d, rank=0, telemetry=tel, **kw)
        tel.add_sink(rec.observe)
        out.append((d, tel, rec))
    return out


def _feed(tel, script):
    for etype, fields in script:
        tel.emit(etype, **fields)


def _strip(ev):
    return {k: v for k, v in ev.items() if k != "t"}


def _events(d):
    got = []
    for fn in sorted(os.listdir(d)):
        if fn.startswith("events.") and fn.endswith(".jsonl"):
            with open(os.path.join(d, fn)) as f:
                got.extend(json.loads(line) for line in f if line.strip())
    return got


def _dumps(d):
    bd = os.path.join(d, "blackbox")
    if not os.path.isdir(bd):
        return {}
    got = {}
    for fn in sorted(os.listdir(bd)):
        if fn.startswith("dump."):
            with open(os.path.join(bd, fn)) as f:
                doc = json.load(f)
            doc.pop("t")
            doc["ring"] = [_strip(e) for e in doc["ring"]]
            got[fn] = doc
    return got


def _step(i):
    return ("step", dict(step=i, epoch=0, data_s=0.001, h2d_s=0.001,
                         compute_s=0.01, drain_s=0.001, step_s=0.014))


SCRIPTS = {
    "ring_then_fault": [_step(i) for i in range(40)]
    + [("fault", dict(point="nanbomb", step=39))],
    "storm": [_step(i) for i in range(3)]
    + [("fault", dict(point="nanbomb", step=2))] * 3,
    "classes": [_step(i) for i in range(5)]
    + [("doctor", dict(action="skip_step", step=4)),
       ("fault", dict(point="nanbomb", step=4)),
       ("sdc_probe", dict(step=5, world=3, divergent=0, tie=0)),
       ("sdc_probe", dict(step=6, world=3, divergent=1, tie=0)),
       ("compile", dict(seconds=1.0, phase="kernel_build")),
       ("eval", dict(epoch=0, seconds=0.5)),
       ("preempt", dict(signal="SIGTERM", epoch=0)),
       ("doctor", dict(action="rollback", step=7, reason="loss_spike"))],
}


@pytest.mark.parametrize("script,kw", [
    ("ring_then_fault", dict(ring=16)), ("storm", dict(cooldown_s=3600.0)),
    ("storm", dict(cooldown_s=0.0)), ("classes", dict(ring=8)),
    ("classes", dict(ring=64, cooldown_s=3600.0))])
def test_recorder_dumps_and_incidents_as_tpudists(tmp_path, script, kw):
    (d_a, tel_a, rec_a), (d_b, tel_b, rec_b) = _pair(tmp_path, **kw)
    _feed(tel_a, SCRIPTS[script])
    _feed(tel_b, SCRIPTS[script])
    for rec in (rec_a, rec_b):
        rec.request_capture("http")
        rec.poll(global_step=99)       # the manual trigger's dump
        rec.close()                    # (the traces are held below)
    tel_a.close()
    tel_b.close()
    assert _dumps(d_a) == _dumps(d_b)
    assert _dumps(d_a)
    inc = [[_strip(e) for e in _events(d) if e["type"] == "incident"]
           for d in (d_a, d_b)]
    assert inc[0] == inc[1] and inc[0]
    for e in _events(d_a):
        jax_tel.validate_event(e)
    assert rec_a._counts == rec_b._counts
    assert [e["type"] for e in rec_a._ring] == [e["type"]
                                                for e in rec_b._ring]


def test_deep_capture_is_one_torch_profiler_trace(tmp_path):
    (d, tel, rec), _ = _pair(tmp_path, capture_steps=2)
    tel.emit("fault", point="nanbomb", step=4)
    assert rec._armed is not None
    x = torch.ones(64)
    for step in range(5, 9):
        rec.poll(global_step=step)
        (x * 2 + 1).sum()
    rec.close()
    tel.close()
    cap = os.path.join(d, "blackbox", "capture.0.1")
    assert os.listdir(cap) == ["steps5-6.pt.trace.json"]
    assert rec.traces == [os.path.join(cap, "steps5-6.pt.trace.json")]
    with open(rec.traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mul" in names
    # No HLO on the card: the capture writes none.
    assert not os.path.exists(os.path.join(cap, "optimized_hlo.txt"))


def test_capture_keeps_the_dump_and_skips_the_trace_in_a_profile_window(
        tmp_path):
    (d, tel, rec), _ = _pair(tmp_path, capture_steps=2)
    prof = StepProfiler("5:7", d, device="cpu")
    tel.emit("fault", point="nanbomb", step=4)
    for step in range(5, 9):
        prof.step(step)
        rec.poll(global_step=step)
    prof.close()
    rec.close()
    tel.close()
    assert os.path.isfile(os.path.join(d, "blackbox", "dump.0.1.json"))
    assert rec.traces == []
    assert os.listdir(os.path.join(d, "profile", "attempt_0")) == [
        "steps5-6.pt.trace.json"]


def _write_dump(rundir, rank, seq, trigger, t, step=5, pad_bytes=0):
    os.makedirs(os.path.join(rundir, "blackbox"), exist_ok=True)
    ring = [{"t": t - (8 - i) * 0.01, "type": "step", "rank": rank,
             "attempt": 0, "step": step - 8 + i, "epoch": 0, "data_s": 0.001,
             "h2d_s": 0.001, "compute_s": 0.01, "drain_s": 0.001,
             "step_s": 0.014} for i in range(8)]
    doc = {"version": 1, "trigger": trigger, "rank": rank, "seq": seq,
           "t": t, "step": step, "detail": trigger, "counts": {trigger: 1},
           "capture_steps": 2, "ring": ring}
    if pad_bytes:
        doc["pad"] = "x" * pad_bytes
    with open(os.path.join(rundir, "blackbox", f"dump.{rank}.{seq}.json"),
              "w") as f:
        json.dump(doc, f)


def _bundles(rundir, lister):
    got = []
    for m in lister(rundir):
        d = m.pop("dir")
        for dump in m.get("dumps", []):
            if "ref" in dump:
                dump["ref"] = os.path.basename(dump["ref"])
        m["captures"] = [os.path.basename(c) for c in m.get("captures", [])]
        files = {}
        for fn in sorted(os.listdir(d)):
            with open(os.path.join(d, fn)) as f:
                files[fn] = (f.read() if fn != "manifest.json" else None)
        got.append((m, files))
    return got


@pytest.mark.parametrize("case", ["coalesce", "retention", "size_cap",
                                  "fleet_trigger"])
def test_bundler_bundles_as_tpudists(tmp_path, case):
    t0 = time.time()
    runs = []
    for name, tel_mod, mod in (("port", port_tel, bb),
                               ("jax", jax_tel, jax_bb)):
        run = str(tmp_path / name)
        os.makedirs(run)
        tel = tel_mod.Telemetry(run, rank=0, attempt=0, heartbeat=False)
        tel.emit("fault", point="nanbomb", step=5, t=t0)
        tel.emit("doctor", action="skip_step", step=5, t=t0 + 0.5)
        tel.close()
        kw = {}
        if case == "coalesce":
            _write_dump(run, 0, 1, "fault", t0)
            _write_dump(run, 1, 1, "doctor", t0 + 2.0)
        elif case == "retention":
            for i in range(5):
                _write_dump(run, 0, i + 1, "fault", t0 - 1000 + i * 100)
            kw = dict(keep=2)
        elif case == "size_cap":
            _write_dump(run, 0, 1, "fault", t0, pad_bytes=300_000)
            kw = dict(max_mb=0.1)
        launcher = None
        if case == "fleet_trigger":
            launcher = tel_mod.Telemetry(run, rank=-1, attempt=0,
                                         name="launcher", heartbeat=False)
            kw = dict(telemetry=launcher)
        b = mod.IncidentBundler(run, **kw)
        if case == "fleet_trigger":
            for code, who in ((76, 1), (0, 0)):
                b.observe({"t": t0 + 1, "type": "rank_exit", "rank": -1,
                           "attempt": 0, "code": code, "exit_rank": who})
            b.poll()
        b.close()
        if launcher is not None:
            launcher.close()
        runs.append(run)
    (port_run, jax_run) = runs
    ours, theirs = (_bundles(port_run, bb.list_incidents),
                    _bundles(jax_run, jax_bb.list_incidents))
    assert ours == theirs and ours
    for m in bb.list_incidents(port_run):
        assert bb.format_incident(m) == jax_bb.format_incident(m)
    if case == "fleet_trigger":
        inc = [e for e in _events(port_run) if e["type"] == "incident"]
        assert [(e["trigger"], e["suspect_rank"], e["bundle"]) for e in inc] \
            == [("rank_exit", 1, "inc-001-rank_exit")]


def test_cli_lists_reports_and_refuses_the_trace_export(tmp_path, capsys):
    run = str(tmp_path)
    _write_dump(run, 0, 1, "fault", time.time())
    bb.IncidentBundler(run).close()
    assert bb.main(["list", run]) == 0
    assert "inc-001-fault" in capsys.readouterr().out
    assert bb.main(["report", run, "inc-001-fault"]) == 0
    out = capsys.readouterr().out
    assert "trigger fault" in out and "suspect rank 0" in out
    assert bb.main(["report", run, "inc-999"]) == 1
    with pytest.raises(SystemExit) as e:
        bb.main(["report", run, "--trace", str(tmp_path / "t.json")])
    assert e.value.code == 2
    assert "unsupported in tpudist_torch.blackbox: --trace" in \
        capsys.readouterr().err
    os.makedirs(tmp_path / "empty")
    assert bb.main(["list", str(tmp_path / "empty")]) == 1


def test_post_capture_arms_through_the_endpoint():
    srv = MetricsServer(MetricsRegistry(rank=0), port=0).start()
    url = f"http://127.0.0.1:{srv.port}/capture"
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(url,
                                                          method="POST"),
                                   timeout=10)
        assert e.value.code == 404
        calls = []
        srv.set_capture(lambda: calls.append(1))
        with urllib.request.urlopen(urllib.request.Request(
                url, method="POST"), timeout=10) as r:
            assert r.status == 202 and json.loads(r.read())["ok"] is True
        assert calls == [1]
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                url.replace("/capture", "/nope"), method="POST"), timeout=10)
        assert e.value.code == 404
    finally:
        srv.close()


# -- a doctor run on the CPU ----------------------------------------------------

RUN = ["--device", "cpu", "--synthetic", "-a", "resnet18", "--num-classes",
       "4", "--image-size", "32", "-b", "16", "--synthetic-size", "64",
       "--epochs", "3", "-p", "1", "--seed", "0", "--lr", "0.01",
       "--telemetry", "--doctor", "--doctor-probe-freq", "2",
       "--doctor-spike-min-steps", "2", "--blackbox",
       "--blackbox-capture-steps", "2", "--replica-check-freq", "1",
       "--stall-timeout", "120", "--keep-checkpoints", "3"]


@pytest.fixture(scope="module")
def doctor_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("doctor") / "run"
    torch.set_num_threads(2)
    cli.main(RUN + ["--inject", "nanbomb@step=2;lossbomb@step=6",
                    "--outpath", str(out)])
    return str(out)


def test_tpudists_summarize_reads_the_doctor_run(doctor_run):
    events = load_events(doctor_run)
    for e in events:
        jax_tel.validate_event(e)
    a = analyze(events)
    doctor = [e for e in events if e["type"] == "doctor"]
    assert [(e["action"], e.get("step")) for e in doctor][:2] == [
        ("skip_step", 2), ("spike", 6)]
    assert a["doctor"]["by_action"]["rollback"] == 1
    assert a["doctor"]["probes"] == len(
        [e for e in events if e["type"] == "sdc_probe"]) >= 4
    assert a["doctor"]["divergent_probes"] == 0
    rb = next(e for e in doctor if e["action"] == "rollback")
    assert (rb["reason"], rb["to_epoch"], rb["window_epoch"],
            rb["window_start"], rb["window_end"]) == (
        "loss_spike", 1, 1, 32, 48)
    assert a["incidents"]["by_trigger"]["fault"] >= 1
    assert a["incidents"]["by_trigger"]["doctor"] >= 1
    report = format_report(a, doctor_run)
    assert "doctor: " in report and "rollback x1" in report
    assert "incidents: " in report
    with open(os.path.join(doctor_run, "experiment.log")) as f:
        log = f.read()
    assert log.count("replica consistency check skipped: no replicated "
                     "leaves (single device or fully sharded state)") == 3
    assert "epoch 1 replays with poisoned window(s) [(32, 48)] excised (3 " \
           "steps remain)" in log
    # The skipped step is out of the optimizer's count: 12 dispatches, a
    # rollback to epoch 1's start, 3 replayed steps, 4 more, one skip.
    tree = jax_ckpt.load_checkpoint(os.path.join(doctor_run,
                                                 "checkpoint.msgpack"))
    assert int(tree["state"]["opt_state"]["count"]) == 4 + 3 + 4 - 1
    assert tree["doctor"] == {"rollbacks": 1,
                              "poison_windows": {"1": [[32, 48]]}}


def test_a_resumed_doctor_run_rearms_the_windows(doctor_run, tmp_path):
    import shutil
    out = tmp_path / "resumed"
    shutil.copytree(doctor_run, out)
    cli.main(RUN[:RUN.index("--epochs")] + ["--epochs", "3"]
             + RUN[RUN.index("--epochs") + 2:]
             + ["--resume", "auto", "--overwrite", "keep",
                "--outpath", str(out)])
    with open(out / "experiment.log") as f:
        log = f.read()
    assert ("=> doctor: checkpoint carries poison windows {1: [(32, 48)]} "
            "(rollbacks so far: 1)") in log


def test_the_launcher_bundles_a_blackbox_ranks_dumps(tmp_path):
    out = tmp_path / "l"
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "tpudist_torch.launch", "-n", "1",
         "--incident-keep", "1", "--", sys.executable, "-m",
         "tpudist_torch", "--distributed", "--device", "cpu", "--synthetic",
         "-a", "resnet18", "--num-classes", "4", "--image-size", "32", "-b",
         "16", "--synthetic-size", "32", "--epochs", "1", "-p", "1",
         "--telemetry", "--blackbox", "--doctor", "--inject",
         "nanbomb@step=1", "--outpath", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "incident bundler armed (keep 1" in r.stderr
    (m,) = bb.list_incidents(str(out))
    assert m["trigger"] == "fault" and m["suspect_rank"] == 0
    assert {d["trigger"] for d in m["dumps"]} == {"fault", "doctor"}
    assert "events.jsonl" in m["artifacts"]
    report = jax_bb.format_incident(m)
    assert "doctor response: skip_step x1" in report
