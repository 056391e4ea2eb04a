"""The port's stall watchdog (``tpudist_torch/utils/watchdog.py``) and
replica check (``tpudist_torch/utils/debug.py``) against tpudist's, on
the CPU.

- ``Watchdog`` and tpudist's, with the same timeout and callbacks: both
  fire on a missed kick with the same reason shape, neither fires while
  kicked, both fire at once on the ``watchdog_expire`` point (reason
  ``injected: watchdog_expire fault``); the default callback ends a process with 117, every thread's
  stack on stderr and a last ``fault`` event (``watchdog_stall``).
- The trainer: ``--stall-timeout`` shorter than a cold start (a kernel
  build and dispatch probe that outlast it) does not fire; an injected
  expiry ends the run with 117 and the event.
- The replica check: at world 1 it checks nothing (the trainer logs
  tpudist's "skipped" line); over two gloo ranks equal states pass and a
  flipped bit on rank 1 raises ``AssertionError`` naming the leaf on both
  ranks; NaN-for-NaN and -0 for +0 count as the bits they are.
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

pytest.importorskip("jax")

from tpudist import faults as jax_faults  # noqa: E402
from tpudist.utils.watchdog import Watchdog as JaxWatchdog  # noqa: E402

from tpudist_torch import __main__ as cli  # noqa: E402
from tpudist_torch import faults  # noqa: E402
from tpudist_torch.trainer import Trainer  # noqa: E402
from tpudist_torch.utils import debug  # noqa: E402
from tpudist_torch.utils.watchdog import STALL_EXIT_CODE, Watchdog  # noqa: E402

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarmed():
    faults.configure("")
    jax_faults.configure("")
    yield
    faults.configure("")
    jax_faults.configure("")


def _run(cls, timeout, kicks, spec="", every=0.02, idle=1.5):
    """Run a watchdog for ``kicks`` kicks ``every`` seconds apart, then
    idle until it fires or ``idle`` seconds pass; returns what the
    callback saw."""
    seen = []
    fired = threading.Event()

    def on_stall(elapsed, budget, reason):
        seen.append((round(budget, 3), reason.split(" (")[0]
                     .split("for ")[0]))
        fired.set()
    (faults if cls is Watchdog else jax_faults).configure(spec)
    wd = cls(timeout, on_stall=on_stall, poll_interval=0.01).start()
    for _ in range(kicks):
        time.sleep(every)
        wd.kick()
    fired.wait(idle)
    wd.stop()
    return seen, wd.fired, wd.fire_reason is not None


@pytest.mark.parametrize("timeout,kicks,spec", [
    (0.2, 0, ""), (0.2, 20, ""), (0.3, 5, ""),
    (60.0, 0, "watchdog_expire"), (0.5, 0, "watchdog_expire"),
    (0.0, 0, "watchdog_expire")])
def test_watchdog_fires_as_tpudists(timeout, kicks, spec):
    idle = 1.5 if timeout else 0.3      # a disabled one never fires
    ours = _run(Watchdog, timeout, kicks, spec, idle=idle)
    theirs = _run(JaxWatchdog, timeout, kicks, spec, idle=idle)
    assert ours == theirs
    if timeout and (spec or kicks < 20 or timeout < kicks * 0.02):
        assert ours[1], "the watchdog must fire"
    if spec and timeout:
        assert ours[0][0][1] == "injected: watchdog_expire fault"


def test_kicks_keep_it_quiet():
    seen, fired, _ = _run(Watchdog, 0.3, kicks=60, every=0.01, idle=0)
    assert (seen, fired) == ([], False)


_STALL = """
import sys, time
from tpudist_torch import telemetry
from tpudist_torch.utils.watchdog import Watchdog
tel = telemetry.Telemetry(sys.argv[1], rank=0, attempt=0, heartbeat=False)
telemetry.set_current(tel)
Watchdog(0.3, poll_interval=0.05).start()
time.sleep(30)
"""


def test_default_stall_ends_the_process_with_117_and_an_event(tmp_path):
    r = subprocess.run([sys.executable, "-c", _STALL, str(tmp_path)],
                       cwd=REPO, capture_output=True, text=True, timeout=60,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == STALL_EXIT_CODE == 117
    assert "no training-step progress" in r.stderr
    assert "--- thread" in r.stderr
    with open(tmp_path / "events.0.jsonl") as f:
        last = [json.loads(line) for line in f][-1]
    assert (last["type"], last["point"]) == ("fault", "watchdog_stall")
    assert last["elapsed_s"] > 0.3
    assert faults.classify_exit(r.returncode) == \
        jax_faults.classify_exit(r.returncode)


TINY = ["--device", "cpu", "--synthetic", "-a", "resnet18", "--num-classes",
        "4", "--image-size", "32", "-b", "8", "--synthetic-size", "16",
        "--epochs", "1", "-p", "1", "--seed", "0", "--telemetry"]


def test_a_cold_start_slower_than_the_timeout_does_not_fire(tmp_path,
                                                            monkeypatch):
    """The kernels are built and the dispatch probed in ``__init__``,
    before ``fit`` starts the watchdog: a cold nvcc build (here a probe
    that sleeps 3x the timeout) is never a stall."""
    real = Trainer._resolve_fused_norm_dispatch

    def cold_probe(self):
        time.sleep(1.5)
        return real(self)

    monkeypatch.setattr(Trainer, "_resolve_fused_norm_dispatch", cold_probe)
    torch.set_num_threads(2)
    out = tmp_path / "cold"
    cli.main(TINY + ["--stall-timeout", "0.5", "--replica-check-freq", "1",
                     "--outpath", str(out)])
    with open(out / "events.0.jsonl") as f:
        events = [json.loads(line) for line in f]
    assert not [e for e in events if e["type"] == "fault"]
    assert events[-1]["type"] == "run_end"
    with open(out / "experiment.log") as f:
        log = f.read()
    assert ("replica consistency check skipped: no replicated leaves "
            "(single device or fully sharded state)") in log


def test_an_injected_expiry_ends_the_trainer_with_117(tmp_path):
    out = tmp_path / "exp"
    r = subprocess.run(
        [sys.executable, "-m", "tpudist_torch", *TINY, "--stall-timeout",
         "2", "--inject", "watchdog_expire", "--outpath", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    assert r.returncode == 117, r.stderr[-2000:]
    assert "fire reason: injected: watchdog_expire fault" in r.stderr
    with open(out / "events.0.jsonl") as f:
        points = [e.get("point") for e in map(json.loads, f)
                  if e["type"] == "fault"]
    assert points[-2:] == ["watchdog_expire", "watchdog_stall"]


# -- the replica check ------------------------------------------------------------

def test_the_check_of_one_rank_checks_nothing():
    m = torch.nn.Linear(3, 2)
    assert debug.check_replica_consistency(debug.replica_leaves(m)) == ([],
                                                                        0)
    assert debug.assert_replicas_consistent(debug.replica_leaves(m)) == 0


_RANK = """
import os, sys, torch, torch.distributed as dist
from tpudist_torch.utils import debug
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
torch.manual_seed(0)
m = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))
leaves = debug.replica_leaves(m)
print("clean", debug.assert_replicas_consistent(leaves), flush=True)
nan = torch.tensor([float("nan"), -0.0])
print("nan", debug.check_replica_consistency([("x", nan)]), flush=True)
zero = torch.tensor([0.0 if rank == 0 else -0.0])
print("zero", debug.check_replica_consistency([("z", zero)]), flush=True)
if rank == 1:
    with torch.no_grad():
        m[0].bias.view(torch.int32)[0] ^= 1 << 23
try:
    debug.assert_replicas_consistent(leaves)
except AssertionError as e:
    print("raised", e, flush=True)
dist.destroy_process_group()
"""


def test_two_gloo_ranks_name_the_divergent_leaf():
    from tpudist_torch.launch import find_free_port
    port = str(find_free_port())
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), port],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        lines = dict(line.split(" ", 1) for line in out.splitlines())
        assert lines["clean"] == "6"      # 4 parameters, 2 statistics
        assert lines["nan"] == "([], 1)"
        assert lines["zero"] == "([('z', 0.0)], 1)"
        assert lines["raised"].startswith(
            "replica divergence on 1 state leaves: params/0.bias (Δ=")
