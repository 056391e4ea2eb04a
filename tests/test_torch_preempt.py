"""The preemption drain, the emergency checkpoint and the fault points of
the port's trainer, against tpudist's, on the CPU.

- Across packages: a tpudist emergency checkpoint (``state_to_dict(...,
  data_cursor=...)``) resumes in the port's trainer at its cursor, and the
  rest of the epoch trains on tpudist's batches; the port's emergency
  checkpoint restores in tpudist (``restore_train_state``, then the
  trainer's ``_after_restore``) with the same cursor; for the same state
  and cursor the two files are the same bytes. After a cursor, the
  loaders give tpudist's batches on the synthetic, PIL-stack, native-crop
  and native-JPEG paths, at world 1 and 2.
- Through ``python -m tpudist_torch.launch -n 1``: SIGTERM to the launcher
  mid-epoch makes the rank drain (the ``caught SIGTERM`` and ``exiting 75
  (resumable)`` lines, a ``preempt`` event, a ``checkpoint_save`` of kind
  ``emergency``, a live file whose cursor counts whole steps) and the
  launcher exit 130; the same command continues the epoch at the cursor
  and ends with the straight run's checkpoint, byte for byte. So does a
  run under ``--accum-steps 2 --mixup-alpha 0.2 --cutmix-alpha 1.0``:
  the cursor counts whole optimizer steps and the relaunch draws the
  mixing of the steps it has not taken.
- ``checkpoint_corrupt`` flips the bytes of the second epoch's save; the
  resume falls back to the first epoch's history file, quarantines the
  two bad files and emits the ``fault`` events.
- The slow tier: ``rank_exit`` at a step of attempt 0 under
  ``--max-restarts 1`` (the relaunch resumes and ends with the straight
  run's file), and the drain over two gloo ranks (both stop after the
  same step; the relaunch ends with a straight two-rank run's file).
"""

import contextlib
import functools
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

jax = pytest.importorskip("jax")

from tpudist import checkpoint as jax_ckpt  # noqa: E402
from tpudist import train as jax_train  # noqa: E402
from tpudist.config import Config as JaxConfig  # noqa: E402
from tpudist.data import native as jax_native  # noqa: E402
from tpudist.data import pipeline as jax_pipeline  # noqa: E402
from tpudist.models import create_model as jax_create  # noqa: E402
from tpudist.trainer import Trainer as JaxTrainer  # noqa: E402

from tpudist_torch import __main__ as cli  # noqa: E402
from tpudist_torch import checkpoint as ckpt  # noqa: E402
from tpudist_torch import faults  # noqa: E402
from tpudist_torch import serialization as ser  # noqa: E402
from tpudist_torch.compat.jax_params import state_dict_from_jax  # noqa: E402
from tpudist_torch.config import Config  # noqa: E402
from tpudist_torch.data import (CROP, JPEG, PIL_STACK,  # noqa: E402
                                build_train_val_loaders)
from tpudist_torch.data import native  # noqa: E402
from tpudist_torch.models import create_model  # noqa: E402
from tpudist_torch.train import make_optimizer  # noqa: E402
from tpudist_torch.trainer import Trainer  # noqa: E402

from test_torch_data import make_tree  # noqa: E402
from test_torch_native_data import jax_lib  # noqa: E402,F401 (a fixture)

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = dict(arch="resnet18", num_classes=8, image_size=32, batch_size=16,
              synthetic=True, synthetic_size=64, seed=0, use_amp=False,
              epochs=2, step=[1], print_freq=1, workers=2)
CURSOR = {"epoch": 1, "consumed": 32, "samples_skipped": 1,
          "samples_retried": 2}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _drop_run_dirs(tmp_path):
    """Full-width resnet18 checkpoints are tens of MB each: free the disk
    as each test ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True)
def _disarmed():
    faults.configure("")
    yield
    faults.configure("")


@pytest.fixture
def one_device(monkeypatch):
    """tpudist's pipeline for one device a process, as the port's one card
    a rank."""
    monkeypatch.setattr(jax, "local_device_count", lambda: 1)


@functools.lru_cache(maxsize=None)
def _jax_state():
    jcfg = JaxConfig(**FIELDS)
    model = jax_create("resnet18", num_classes=8)
    state = jax_train.create_train_state(jax.random.PRNGKey(0), model, jcfg,
                                         input_shape=(1, 32, 32, 3))
    return jcfg, jax.device_get(state)


def _topology():
    return ckpt.topology_tag(1, 16, 16)


# -- across packages -------------------------------------------------------------

def test_tpudist_emergency_file_continues_in_the_port(tmp_path, one_device,
                                                      capsys):
    jcfg, state = _jax_state()
    tree = jax_ckpt.state_to_dict(state, "resnet18", 0, 12.5,
                                  topology=_topology(), data_cursor=CURSOR)
    os.makedirs(tmp_path / "jax")
    jax_ckpt.save_checkpoint(tree, False, str(tmp_path / "jax"))
    cfg = Config(**FIELDS, device="cpu", overwrite="delete",
                 resume=str(tmp_path / "jax" / ckpt.CKPT_NAME),
                 outpath=str(tmp_path / "port"))
    tr = Trainer(cfg)
    assert (tr.start_epoch, tr.best_acc1) == (1, 12.5)
    assert tr._pending_cursor == CURSOR
    seen = []
    step = tr.train_step

    def recorded(images, labels, lr):
        seen.append((images.numpy().copy(), labels.numpy().copy()))
        return step(images, labels, lr)
    tr.train_step = recorded
    tr.fit()
    text = capsys.readouterr().out
    assert ("=> checkpoint carries a mid-epoch sample cursor: epoch 1 "
            "continues at global sample 32 (no replay, no drop)") in text
    assert "=> elastic continuation: epoch 1 resumes at global sample 32 " \
        "(2 steps remain on world 1)" in text
    jtrain, _ = jax_pipeline.build_train_val_loaders(jcfg.finalize(1))
    jtrain.set_epoch(1)
    jtrain.set_cursor(32)
    want = list(jtrain)
    assert len(seen) == len(want) == 2
    for (a, la), (b, lb) in zip(seen, want):
        assert np.array_equal(a, b) and np.array_equal(la, lb)
    assert tr.global_step == 2


def _port_trainer(tmp_path, **kw):
    cfg = Config(**{**FIELDS, **kw}, device="cpu", overwrite="delete",
                 outpath=str(tmp_path / "port"))
    return Trainer(cfg)


def test_port_emergency_file_restores_in_tpudist(tmp_path):
    tr = _port_trainer(tmp_path)
    tr._epoch_consumed = CURSOR["consumed"]
    loader = types.SimpleNamespace(samples_skipped=1, samples_retried=2)
    tr.save_emergency(1, loader)
    path = str(tmp_path / "port" / ckpt.CKPT_NAME)
    assert not os.path.exists(tmp_path / "port" / "checkpoint-ep00001.msgpack")
    tree = jax_ckpt.load_checkpoint(path)
    assert tree["epoch"] == 1 and tree["data_cursor"] == CURSOR
    _, fresh = _jax_state()
    restored = jax_ckpt.restore_train_state(fresh, tree)
    want = state_dict_from_jax("resnet18", restored.params,
                               restored.batch_stats)
    for name, t in tr.model.state_dict().items():
        assert torch.equal(t, want[name]), name
    # tpudist's trainer takes the cursor from the restored tree.
    lines = []
    host = types.SimpleNamespace(log=lines.append, doctor=None,
                                 telemetry=None, _pending_cursor=None)
    JaxTrainer._after_restore(host, tree)
    assert host._pending_cursor == CURSOR
    assert lines == ["=> checkpoint carries a mid-epoch sample cursor: "
                     "epoch 1 continues at global sample 32 (no replay, no "
                     "drop)"]


def test_cursor_bytes_equal_tpudists_for_the_same_tree(tmp_path):
    jcfg, state = _jax_state()
    model = create_model("resnet18", num_classes=8)
    model.load_state_dict(state_dict_from_jax("resnet18", state.params,
                                              state.batch_stats))
    pcfg = Config(**FIELDS)
    mine = ckpt.state_to_dict(model, make_optimizer(model, pcfg),
                              arch="resnet18", epoch=0, best_acc1=12.5,
                              step=0, topology=_topology(),
                              data_cursor=CURSOR)
    theirs = jax_ckpt.state_to_dict(state, "resnet18", 0, 12.5,
                                    topology=_topology(), data_cursor=CURSOR)
    for d, tree, save in (("port", mine, ckpt.save_checkpoint),
                          ("jax", theirs, jax_ckpt.save_checkpoint)):
        os.makedirs(tmp_path / d)
        save(tree, False, str(tmp_path / d))
    a, b = (open(tmp_path / d / ckpt.CKPT_NAME, "rb").read()
            for d in ("port", "jax"))
    assert a == b
    assert b"data_cursor" in a
    assert ser.msgpack_restore(a)["data_cursor"] == CURSOR


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("tree"), per_class=10)


@pytest.mark.parametrize("path", ["synthetic", PIL_STACK, CROP, JPEG])
@pytest.mark.parametrize("world,rank", [(1, 0), (2, 1)])
def test_batches_after_the_cursor_equal_tpudists(tree, jax_lib, one_device,
                                                 monkeypatch, path, world,
                                                 rank):
    kw = dict(image_size=32, val_resize=40, batch_size=8, workers=3, seed=5)
    if path == "synthetic":
        kw.update(synthetic=True, synthetic_size=40)
    else:
        kw.update(data=str(tree))               # 40 train images
    if path == PIL_STACK:
        for mod in (native, jax_native):
            monkeypatch.setattr(mod, "available", lambda: False)
    if path in (PIL_STACK, CROP):
        for mod in (native, jax_native):
            monkeypatch.setattr(mod, "jpeg_available", lambda: False)
    monkeypatch.setenv("TPUDIST_ELASTIC", "1")
    monkeypatch.setenv("TPUDIST_NUM_PROCESSES", str(world))
    monkeypatch.setenv("TPUDIST_PROCESS_ID", str(rank))
    train, _ = build_train_val_loaders(Config(**kw).finalize(world), rank,
                                       world)
    jtrain, _ = jax_pipeline.build_train_val_loaders(
        JaxConfig(**kw).finalize(1))
    assert train.data_path[0] == path or path == "synthetic"
    for loader in (train, jtrain):
        loader.set_epoch(1)
        loader.set_cursor(16, samples_skipped=2, samples_retried=1)
    got, want = list(train), list(jtrain)
    assert len(got) == len(want) == len(train) == (40 - 16) // 8
    for (a, la), (b, lb) in zip(got, want):
        assert np.array_equal(a, b) and np.array_equal(la, lb)
    assert (train.samples_skipped, train.samples_retried) == (2, 1) == \
        (jtrain.samples_skipped, jtrain.samples_retried)


# -- the CLI and the launcher ------------------------------------------------------

CLI = ["--device", "cpu", "--synthetic", "-a", "resnet18", "--num-classes",
       "8", "--image-size", "32", "-b", "16", "--step", "1", "-p", "1",
       "--synthetic-size", "96", "--seed", "0", "--model-ema-decay", "0.5",
       "--telemetry", "-j", "2"]
KEEP = ["--resume", "auto", "--overwrite", "keep"]
# The drained runs stall each step (numerics unchanged), so that the
# signal sent at epoch 1's third step lands before the epoch's end on a
# loaded host.
SLOW = ["--inject", "slow_peer:ms=200"]


def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")


def _launch(out, n=1, extra=(), args=(), launcher=()):
    return [sys.executable, "-m", "tpudist_torch.launch", "-n", str(n),
            *launcher, "--", sys.executable, "-m", "tpudist_torch",
            "--distributed", *CLI, "--epochs", "2", *args, *extra,
            "--outpath", str(out)]


def _run(cmd, timeout=240):
    r = subprocess.run(cmd, cwd=REPO, env=_env(), capture_output=True,
                       text=True, timeout=timeout)
    return r


def _preempted(cmd, marker, timeout=240):
    """Run ``cmd`` and send SIGTERM to it (the launcher) once its output
    shows ``marker``; returns (exit code, stdout, stderr)."""
    proc = subprocess.Popen(cmd, cwd=REPO, env=_env(), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    lines, deadline = [], time.monotonic() + timeout
    for line in proc.stdout:
        lines.append(line)
        if marker in line:
            proc.send_signal(signal.SIGTERM)
            break
        assert time.monotonic() < deadline, "".join(lines)[-3000:]
    out, err = proc.communicate(timeout=timeout)
    return proc.returncode, "".join(lines) + out, err


def _events(out, rank=0):
    with open(os.path.join(out, f"events.{rank}.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _file(out):
    with open(os.path.join(out, ckpt.CKPT_NAME), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The uninterrupted two-epoch run through the launcher."""
    out = tmp_path_factory.mktemp("straight") / "run"
    r = _run(_launch(out))
    assert r.returncode == 0, r.stderr[-3000:]
    want = _file(out)
    shutil.rmtree(out.parent, ignore_errors=True)
    return want


def _check_drain(out, code, text, err, world=1):
    assert code == 130, err[-3000:]
    assert "=> caught SIGTERM — draining for preemption" in text
    assert "=> emergency checkpoint complete; exiting 75 (resumable)" in text
    tree = ckpt.load_checkpoint(str(out))
    cur = tree["data_cursor"]
    assert tree["epoch"] == 1 and cur["epoch"] == 1
    assert 0 < cur["consumed"] < 96 and cur["consumed"] % 16 == 0
    steps = int(tree["state"]["step"])
    assert steps == 6 + cur["consumed"] // 16       # dispatched steps
    for rank in range(world):
        events = _events(out, rank)
        assert [e["signal"] for e in events if e["type"] == "preempt"] \
            in (["SIGTERM"], ["a peer's signal"])
        saves = [e for e in events if e["type"] == "checkpoint_save"]
        assert [e["kind"] for e in saves] == ["epoch", "emergency"]
        assert sum(e["type"] == "step" for e in events) == steps
        assert events[-1]["type"] == "run_end"
    # The emergency save wrote the live file only: the history copy of the
    # same stored epoch is still the epoch boundary's.
    hist = ckpt.load_checkpoint(os.path.join(out,
                                             "checkpoint-ep00001.msgpack"))
    assert "data_cursor" not in hist and int(hist["state"]["step"]) == 6
    return cur


def test_sigterm_drains_exits_75_and_the_relaunch_ends_as_straight(
        tmp_path, straight):
    out = tmp_path / "run"
    cmd = _launch(out, extra=KEEP + SLOW)
    code, text, err = _preempted(cmd, "Epoch[1]:\t[2/6]")
    cur = _check_drain(out, code, text, err)
    r = _run(cmd)
    assert r.returncode == 0, r.stderr[-3000:]
    assert f"=> resumed from '{out}/checkpoint.msgpack' (epoch 1, " in \
        r.stdout
    assert (f"=> elastic continuation: epoch 1 resumes at global sample "
            f"{cur['consumed']} ({6 - cur['consumed'] // 16} steps remain "
            f"on world 1)") in r.stdout
    assert _file(out) == straight


ACCUM_MIX = ["--accum-steps", "2", "--mixup-alpha", "0.2", "--cutmix-alpha",
             "1.0"]


def test_drain_under_accumulation_and_mixing_ends_as_straight(tmp_path):
    ref = tmp_path / "straight"
    r = _run(_launch(ref, extra=ACCUM_MIX))
    assert r.returncode == 0, r.stderr[-3000:]
    want = _file(ref)
    shutil.rmtree(ref)
    out = tmp_path / "run"
    cmd = _launch(out, extra=ACCUM_MIX + KEEP + SLOW)
    code, text, err = _preempted(cmd, "Epoch[1]:\t[2/6]")
    cur = _check_drain(out, code, text, err)
    r = _run(cmd)
    assert r.returncode == 0, r.stderr[-3000:]
    assert (f"=> elastic continuation: epoch 1 resumes at global sample "
            f"{cur['consumed']} ({6 - cur['consumed'] // 16} steps remain "
            f"on world 1)") in r.stdout
    assert _file(out) == want


def test_checkpoint_corrupt_falls_back_and_quarantines(tmp_path):
    out = str(tmp_path / "run")
    args = list(CLI)
    args[args.index("--synthetic-size") + 1] = "32"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(args + ["--epochs", "2", "--inject",
                                "checkpoint_corrupt@step=2", "--outpath",
                                out]) == 0
        assert cli.main(args + ["--epochs", "3", *KEEP, "--outpath",
                                out]) == 0
    text = buf.getvalue()
    assert text.count("fails sha256 verification — quarantined to") == 2
    assert f"=> resumed from '{out}/checkpoint-ep00001.msgpack' (epoch 1, " \
        in text
    assert os.path.exists(out + "/checkpoint.msgpack.corrupt")
    assert os.path.exists(out + "/checkpoint-ep00002.msgpack.corrupt")
    faults_seen = [(e["attempt"], e["point"]) for e in _events(out)
                   if e["type"] == "fault"]
    assert faults_seen == [(0, "checkpoint_corrupt"),
                           (0, "checkpoint_quarantine"),
                           (0, "checkpoint_quarantine")]
    assert ckpt.load_checkpoint(out)["epoch"] == 3


@pytest.mark.slow
def test_rank_exit_relaunches_and_resumes(tmp_path, straight):
    out = tmp_path / "run"
    r = _run(_launch(out, extra=KEEP, launcher=(
        "--max-restarts", "1", "--inject", "rank_exit@step=8@attempt=0")))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[tpudist.faults] rank_exit firing at step 8 (os._exit(41))" in \
        r.stdout
    assert ("[tpudist_torch.launch] job failed (exit 41: crash (exit 41)) — "
            "restart 1/1") in r.stderr
    assert f"=> resumed from '{out}/checkpoint.msgpack' (epoch 1, " in \
        r.stdout
    assert {e["attempt"] for e in _events(out)} == {0, 1}
    assert _file(out) == straight


@pytest.mark.slow
def test_two_gloo_ranks_drain_at_the_same_step(tmp_path):
    ref = tmp_path / "straight"
    r = _run(_launch(ref, n=2))
    assert r.returncode == 0, r.stderr[-3000:]
    want = _file(ref)
    shutil.rmtree(ref)
    out = tmp_path / "run"
    cmd = _launch(out, n=2, extra=KEEP + SLOW)
    code, text, err = _preempted(cmd, "Epoch[1]:\t[2/6]")
    _check_drain(out, code, text, err, world=2)
    r = _run(cmd)
    assert r.returncode == 0, r.stderr[-3000:]
    assert _file(out) == want
