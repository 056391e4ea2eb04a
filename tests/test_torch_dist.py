"""The port's data-parallel plane on the CPU: gloo ranks, the launcher.

- Two ranks, started by ``python -m tpudist_torch.launch -n 2`` and joined
  over gloo by ``dist.initialize_runtime``, train a tiny resnet18 (width
  16, 32 px, 8 classes, f32, the flax init of seed 0 through the weight
  bridge) for 2 SGD steps at global batch 16 under DDP, with and without
  SyncBN. The oracle is tpudist's ``make_train_step`` on a 2-device CPU
  mesh in this process at the same global batch, its plain BN epilogue.
  The losses agree within 1e-5 after one step and 1e-4 after two; every
  parameter and BN running buffer within 1e-3 of its largest update (or
  1e-6 absolute), the bounds of ``tests/test_torch_train.py``; and the
  two ranks end bit-identical. A third case takes 2 microbatches a step
  (``--accum-steps 2``, 8 rows each, one gradient all-reduce a step). The
  slow tier adds 4 ranks and a tiny ViT
  through the flash ``Function`` at 2 ranks. Every rank takes 8 rows a
  step, so 4 ranks run at global batch 32: at 4 rows a rank, layer4's
  BatchNorm (1x1 spatial at 32 px) normalises 4 values a channel, and
  the two frameworks' f32 gradients of one shard already differ by up to
  3e-4 of a leaf's largest entry (seed 0), more than the bound allows
  once averaged.
- The launcher hands each rank its identity, propagates the first failing
  rank's exit code after tearing the others down, relaunches all ranks up
  to ``--max-restarts`` times, and refuses tpudist's other flags by name.
- ``initialize_runtime`` raises within its deadline on an unreachable
  coordinator and refuses more ranks than CUDA cards; ``reduce_mean``,
  ``barrier`` (and its deadline) and the differentiable all-reduce work
  over two gloo ranks.
- ``python -m tpudist_torch --distributed`` over two gloo ranks logs from
  rank 0 only, writes one event stream a rank with the real ``init_s``
  and the backend, and ``tpudist.summarize`` reads the run.

Run as a script (``--worker``), this file is one rank of the parity runs.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

from tpudist_torch import config as port_config
from tpudist_torch import dist as dist_lib
from tpudist_torch import launch
from tpudist_torch import train as port_train
from tpudist_torch.models import create_model
from tpudist_torch.models.vit import VisionTransformer

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_BATCH = 8
STEPS = 2
LR = 0.005
TINY_RESNET = dict(num_classes=8, width=16)
TINY_VIT = dict(patch_size=8, hidden_dim=64, num_layers=2, num_heads=4,
                mlp_dim=128, num_classes=8)
# Each rank holds torch to 2 threads; the suite runs test files side by
# side.
RANK_ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")


def _launch(nprocs, cmd, timeout, extra=()):
    """``python -m tpudist_torch.launch -n nprocs [extra] -- cmd`` as a
    subprocess: (returncode, stdout, stderr)."""
    r = subprocess.run(
        [sys.executable, "-m", "tpudist_torch.launch", "-n", str(nprocs),
         *extra, "--", *cmd], cwd=REPO, env=RANK_ENV, capture_output=True,
        text=True, timeout=timeout)
    return r.returncode, r.stdout, r.stderr


# -- one rank of the parity runs (run as a script) ---------------------------

def _port_model(arch: str, sync: bool) -> torch.nn.Module:
    if arch == "vit":
        return VisionTransformer(*TINY_VIT.values(), image_size=32,
                                 flash=True)
    return create_model("resnet18", dtype=torch.float32, fused_bn=True,
                        sync_batchnorm=sync, **TINY_RESNET)


def _worker(workdir: str, arch: str, sync: bool, accum: int) -> None:
    torch.set_num_threads(2)
    dist_lib.initialize_runtime(device="cpu")
    rank, world = dist_lib.data_rank_world()
    data = np.load(os.path.join(workdir, "inputs.npz"))
    model = _port_model(arch, sync)
    model.load_state_dict({k[len("init/"):]: torch.from_numpy(data[k])
                           for k in data.files if k.startswith("init/")},
                          strict=True)
    cfg = port_config.Config(arch="resnet18", lr=LR,
                             batch_size=RANK_BATCH * accum * world,
                             accum_steps=accum,
                             sync_batchnorm=sync).finalize(world)
    ddp = port_train.data_parallel(model, torch.device("cpu"))
    step = port_train.make_train_step(
        ddp, port_train.make_optimizer(model, cfg), cfg)
    shard = slice(rank * cfg.per_device_batch_size,
                  (rank + 1) * cfg.per_device_batch_size)
    losses = []
    for x, y in zip(data["x"], data["y"]):
        m = step(torch.from_numpy(x[shard]), torch.from_numpy(y[shard]), LR)
        losses.append([float(m["loss"]), float(m["acc1"])])
    np.savez(os.path.join(workdir, f"rank{rank}.npz"),
             losses=np.asarray(losses),
             **{k: v.detach().numpy() for k, v in model.state_dict().items()})
    dist_lib.shutdown()


# -- the oracle ---------------------------------------------------------------

def _inputs(arch: str, world: int, sync: bool, accum: int = 1):
    """tpudist's initial state, the batches, and its per-step metrics and
    final state from its step on a ``world``-device mesh (``accum``
    microbatches of ``RANK_BATCH`` a rank)."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from jax.sharding import Mesh

    from tpudist import config as jax_config
    from tpudist import train as jax_train
    from tpudist.ops import norm_dispatch
    from tpudist_torch.compat.jax_params import (resnet_state_dict_from_jax,
                                                 vit_state_dict_from_jax)
    batch = RANK_BATCH * accum * world
    rng = np.random.default_rng(0)
    x = rng.standard_normal((STEPS, batch, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 8, (STEPS, batch)).astype(np.int32)
    jcfg = jax_config.Config(arch="resnet18", num_classes=8, image_size=32,
                             batch_size=batch, lr=LR, seed=0,
                             use_amp=False, fused_bn="off",
                             sync_batchnorm=sync, accum_steps=accum)
    if arch == "vit":
        from tpudist.models.vit import VisionTransformer as JaxViT
        jm = JaxViT(**TINY_VIT, flash=True)
        bridge = lambda v: vit_state_dict_from_jax(v["params"])  # noqa: E731
    else:
        from tpudist.models import resnet as jax_resnet
        jm = jax_resnet.resnet18(dtype=jnp.float32, sync_batchnorm=sync,
                                 **TINY_RESNET)
        bridge = lambda v: resnet_state_dict_from_jax(  # noqa: E731
            v["params"], v["batch_stats"])
    norm_dispatch.set_mode("off")
    try:
        state = jax_train.create_train_state(
            jax.random.PRNGKey(0), jm, jcfg, input_shape=(1, 32, 32, 3))
        init = jax.device_get({"params": state.params,
                               "batch_stats": state.batch_stats})
        mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
        jstep = jax_train.make_train_step(mesh, jm, jcfg)
        metrics = []
        for xs, ys in zip(x, y):
            state, m = jstep(state, jnp.asarray(xs), jnp.asarray(ys),
                             jnp.asarray(LR, jnp.float32))
            metrics.append([float(m["loss"]), float(m["acc1"])])
        final = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})
    finally:
        norm_dispatch.set_mode(None)
    return x, y, bridge(init), np.asarray(metrics), bridge(final)


def _run_parity(tmp_path, arch, world, sync, timeout, accum=1):
    x, y, init, want_metrics, want = _inputs(arch, world, sync, accum)
    np.savez(tmp_path / "inputs.npz", x=x, y=y,
             **{f"init/{k}": v.numpy() for k, v in init.items()})
    cmd = [sys.executable, os.path.join(REPO, "tests",
                                        "test_torch_dist.py"),
           "--worker", str(tmp_path), arch, str(int(sync)), str(accum)]
    rc, out, err = _launch(world, cmd, timeout)
    assert rc == 0, out + err[-3000:]
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]
    for r in ranks[1:]:                    # every rank ends bit-identical
        for k in ranks[0].files:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    got = ranks[0]
    for i, (tol, (loss, acc), (jloss, jacc)) in enumerate(zip(
            (1e-5, 1e-4), got["losses"], want_metrics)):
        assert abs(loss - jloss) <= tol, (i, loss, jloss)
        assert acc == pytest.approx(jacc, abs=1e-6), (i, acc, jacc)
    assert set(got.files) - {"losses"} == set(want)
    for k, w in want.items():
        w = w.numpy()
        update = float(np.abs(w - init[k].numpy()).max())
        err = float(np.abs(got[k] - w).max())
        assert err <= max(1e-3 * update, 1e-6), (k, err, update)


@pytest.mark.parametrize("sync,accum", [(False, 1), (True, 1), (False, 2)],
                         ids=["ddp", "syncbn", "ddp_accum2"])
def test_two_gloo_ranks_match_tpudists_two_device_step(tmp_path, sync,
                                                       accum):
    """Parameters and BN running buffers both: with DDP's buffer
    broadcast left on, the buffers would be rank 0's, not the average;
    with a SyncBN all-reduce that drops its gradient, the losses would
    match and the updates would not. Under ``--accum-steps 2`` every
    microbatch but the last runs under DDP's ``no_sync``."""
    _run_parity(tmp_path, "resnet18", 2, sync, timeout=60, accum=accum)


@pytest.mark.slow
@pytest.mark.parametrize("arch,world,sync", [("resnet18", 4, False),
                                             ("resnet18", 4, True),
                                             ("vit", 2, False)])
def test_more_ranks_and_vit_match_tpudist(tmp_path, arch, world, sync):
    _run_parity(tmp_path, arch, world, sync, timeout=300)


# -- the launcher ---------------------------------------------------------------

# Each rank writes a file named for it and waits until every rank of its
# attempt has, so none exits (and none is torn down) before all started.
_ALL_STARTED = """
import os, sys, time
def all_started(tag, value):
    n = int(os.environ["TPUDIST_NUM_PROCESSES"])
    rank = os.environ["TPUDIST_PROCESS_ID"]
    path = os.path.join(sys.argv[1], f"{tag}.{rank}")
    with open(path + ".tmp", "w") as f:
        f.write(value)
    os.replace(path + ".tmp", path)
    deadline = time.monotonic() + 30
    while not all(os.path.exists(os.path.join(sys.argv[1], f"{tag}.{r}"))
                  for r in range(n)):
        assert time.monotonic() < deadline, "a peer never started"
        time.sleep(0.02)
"""

_RANK_EXITS = _ALL_STARTED + """
all_started("pid", str(os.getpid()))
if os.environ["TPUDIST_PROCESS_ID"] == "1":
    sys.exit(17)
time.sleep(120)
"""


def test_first_failing_rank_exit_code_propagates_and_peers_are_aborted(
        tmp_path):
    t0 = time.monotonic()
    rc, _, _ = _launch(2, [sys.executable, "-c", _RANK_EXITS,
                           str(tmp_path)], timeout=60)
    assert rc == 17
    assert time.monotonic() - t0 < 45          # rank 0's sleep was cut
    pid0 = int((tmp_path / "pid.0").read_text())
    with pytest.raises(ProcessLookupError):
        os.kill(pid0, 0)


_ATTEMPTS = _ALL_STARTED + """
attempt = int(os.environ["TPUDIST_RESTART_COUNT"])
all_started(f"attempt{attempt}", os.environ["TPUDIST_NUM_PROCESSES"])
sys.exit(0 if attempt >= int(sys.argv[2]) else 3)
"""


@pytest.mark.parametrize("heals_at,want_rc", [(1, 0), (5, 3)],
                         ids=["recovers", "exhausted"])
def test_max_restarts_relaunches_every_rank_once(tmp_path, heals_at,
                                                 want_rc):
    rc, _, err = _launch(2, [sys.executable, "-c", _ATTEMPTS, str(tmp_path),
                             str(heals_at)], timeout=60,
                         extra=("--max-restarts", "1"))
    assert rc == want_rc, err
    started = {f.name: f.read_text() for f in tmp_path.iterdir()
               if f.name.startswith("attempt")}
    assert started == {"attempt0.0": "2", "attempt0.1": "2",
                       "attempt1.0": "2", "attempt1.1": "2"}
    assert "restart 1/1" in err
    assert ("restart budget exhausted" in err) == (want_rc != 0)


@pytest.mark.parametrize("flags", [
    ["--elastic"], ["--min-ranks", "1"], ["--drain-grace", "5"],
    ["--inject", "bitflp@step=1"], ["--evict-stragglers", "2"],
    ["--scale-up", "2@10"],
    ["--collective-deadline", "30"],
    ["--inject", "lossbomb@step=1;watchdog_expired"],
    ["--platform", "cpu"], ["--devices-per-proc", "2"]])
def test_launcher_refuses_tpudists_other_flags_by_name(flags, capsys):
    with pytest.raises(SystemExit) as e:
        launch.main(["-n", "1", *flags, "--", sys.executable, "-c", "0"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "unsupported in tpudist_torch.launch" in err and flags[0] in err


# -- the runtime ------------------------------------------------------------------

_UNREACHABLE = """
import sys, time
from tpudist_torch import dist
t0 = time.monotonic()
try:
    dist.initialize_runtime(sys.argv[1], 2, int(sys.argv[2]), timeout_s=2,
                            retries=0, device="cpu")
except RuntimeError as e:
    print("RAISED", round(time.monotonic() - t0, 2), e)
"""


@pytest.mark.parametrize("rank", [0, 1], ids=["peer_missing",
                                              "coordinator_missing"])
def test_initialize_runtime_raises_within_its_deadline(rank):
    r = subprocess.run([sys.executable, "-c", _UNREACHABLE,
                        f"127.0.0.1:{launch.find_free_port()}", str(rank)],
                       cwd=REPO, env=RANK_ENV, capture_output=True,
                       text=True, timeout=60)
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("RAISED"))
    assert float(line.split()[1]) < 20
    assert "distributed runtime init failed after 1 attempt(s) (deadline " \
           "2s per attempt" in line


def test_more_ranks_than_cards_and_no_card_are_refused_by_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        dist_lib.initialize_runtime("127.0.0.1:1", 1, 0, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 rank.* but 1 CUDA card"):
        dist_lib.initialize_runtime("127.0.0.1:1", 2, 0, device="cuda")
    with pytest.raises(ValueError, match="TPUDIST_COORDINATOR"):
        dist_lib.initialize_runtime(None, 1, 0, device="cpu")
    assert not dist_lib.is_initialized()
    assert dist_lib.data_rank_world() == (0, 1)


_COLLECTIVES = """
import os, sys, time
import torch
from tpudist_torch import dist
init_s = dist.initialize_runtime(device="cpu")
rank, world = dist.data_rank_world()
mean = dist.reduce_mean(torch.tensor([rank + 1.0, 10.0 * rank]))
x = torch.tensor([float(rank + 1)], requires_grad=True)
(dist.all_reduce_sum(x * x) * (rank + 1)).sum().backward()
dist.barrier()
# One write a line: the two ranks share the launcher's stdout.
sys.stdout.write(f"RANK {rank} {world} {mean.tolist()} {x.grad.item()} "
                 f"{init_s > 0} {dist.is_primary()} {dist.device_count()} "
                 f"{dist.process_index()} {dist.backend()}\\n")
sys.stdout.flush()
if rank == 1:
    time.sleep(6)                # late for the second barrier
    os._exit(0)
try:
    dist.barrier("late", timeout_s=2)
except TimeoutError as e:
    sys.stdout.write(f"TIMEOUT {e}\\n")
    sys.stdout.flush()
    os._exit(0)
"""


def test_reduce_mean_all_reduce_sum_and_barrier_over_two_gloo_ranks():
    rc, out, err = _launch(2, [sys.executable, "-c", _COLLECTIVES],
                           timeout=60)
    assert rc == 0, out + err[-3000:]
    rows = sorted(ln.split(" ", 1)[1] for ln in out.splitlines()
                  if ln.startswith("RANK"))
    # d/dx_r of sum_r' (r'+1)·(x_0² + x_1²) = 3 · 2·x_r.
    assert rows == ["0 2 [1.5, 5.0] 6.0 True True 2 0 gloo",
                    "1 2 [1.5, 5.0] 12.0 True False 2 1 gloo"]
    assert "host barrier 'late' did not complete within 2s" in out


# -- the CLI over two ranks -------------------------------------------------------

def test_distributed_cli_over_two_gloo_ranks(tmp_path):
    pytest.importorskip("jax")
    from tpudist import summarize
    from tpudist import telemetry as jax_telemetry
    out = tmp_path / "run"
    rc, text, err = _launch(2, [
        sys.executable, "-m", "tpudist_torch", "--distributed", "--device",
        "cpu", "--synthetic", "-a", "resnet18", "--num-classes", "8",
        "--image-size", "32", "-b", "17", "--epochs", "1",
        "--synthetic-size", "32", "-p", "1", "-j", "2", "--telemetry",
        "--seed", "0", "--outpath", str(out)], timeout=90)
    assert rc == 0, text + err[-3000:]
    lines = text.splitlines()
    assert lines.count("=> data-parallel: world 2, backend gloo, DDP "
                       "(buffers averaged after the step)") == 1
    assert sum(ln.startswith("Epoch[0]:\t[") for ln in lines) == 2
    assert lines.count("best_acc1=" + lines[-1].split("=")[1]) == 2
    assert "Grad strides do not match" not in err
    with open(out / "settings.log") as f:
        settings = f.read()
    assert "batch_size: 16\n" in settings and "nprocs: 2\n" in settings
    for rank in (0, 1):
        with open(out / f"events.{rank}.jsonl") as f:
            events = [json.loads(ln) for ln in f]
        for ev in events:
            jax_telemetry.validate_event(ev)
        start, end = events[0], events[-1]
        assert (start["type"], end["type"]) == ("run_start", "run_end")
        assert {e["rank"] for e in events} == {rank}
        assert (start["n_devices"], start["backend"]) == (2, "gloo")
        assert start["global_batch"] == 16
        assert start["init_s"] > 0 and end["init_s"] > 0
        assert end["steps"] == 2
        assert (out / "heartbeats" / f"rank{rank}.json").exists()
    assert summarize.main([str(out)]) == 0


def test_global_batch_is_divided_over_the_ranks():
    cfg = port_config.Config(batch_size=17).finalize(2)
    assert (cfg.per_device_batch_size, cfg.batch_size, cfg.nprocs) == \
        (8, 16, 2)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2], sys.argv[3], sys.argv[4] == "1", int(sys.argv[5]))
