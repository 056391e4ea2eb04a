"""The port's fault injection, preemption guard and data cursor against
tpudist's, on the CPU.

- ``faults``: ``parse_spec`` gives tpudist's items and errors on the
  specs of ``tests/test_faults.py``; the gates fire as tpudist's do;
  ``decode_should_fail`` fails and heals the same keys; ``classify_exit``
  names the same codes alike; the doctor's and the watchdog's points
  (``watchdog_expire``, ``nanbomb``, ``lossbomb``, ``bitflip``) arm and
  fire on their gates, and an unknown name is refused by name, by
  ``configure``, the trainer and the launcher.
- ``_PreemptionGuard`` turns SIGTERM and SIGINT into a flag, and a second
  signal reaches the handler that was there before it.
- ``ShardedSampler.set_cursor`` gives tpudist's indices at world 1 and 2,
  and across a change of world; ``DataLoader.set_cursor`` gives tpudist's
  batches and carries the meters; the loader's ``decode_fail`` point
  heals within the retry budget and skips past it, as tpudist's does,
  batch for batch.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401

pytest.importorskip("jax")

from tpudist import faults as jax_faults  # noqa: E402
from tpudist.data.loader import DataLoader as JaxLoader  # noqa: E402
from tpudist.data.sampler import ShardedSampler as JaxSampler  # noqa: E402

from tpudist_torch import __main__ as cli  # noqa: E402
from tpudist_torch import faults  # noqa: E402
from tpudist_torch.data.loader import DataLoader  # noqa: E402
from tpudist_torch.data.sampler import ShardedSampler  # noqa: E402
from tpudist_torch.trainer import (PreemptionRequested,  # noqa: E402
                                   _PreemptionGuard)

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarmed():
    """Both injectors are process-wide: every test starts and ends
    disarmed."""
    faults.configure("")
    jax_faults.configure("")
    yield
    faults.configure("")
    jax_faults.configure("")


# -- the spec grammar ----------------------------------------------------------

GOOD_SPECS = [
    "rank_exit@step=7@rank=1@attempt=0;decode_fail:p=0.25,fails=1;"
    "slow_peer:ms=500@once;checkpoint_corrupt",
    "rank_exit@step=7", "checkpoint_corrupt", "decode_fail:p=0.1",
    "init_hang:ms=30000", "slow_peer:ms=500", " ; rank_exit@once ; ",
    "rank_exit:code=3@step=0@rank=0", "",
]
BAD_SPECS = ["rank_exit@stp=7", "decode_fail:p", ":p=1", "rank_exit@step",
             "slow_peer@rank=x"]


def _fields(inj):
    return (inj.name, inj.step, inj.rank, inj.attempt, inj.once, inj.params)


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_parse_spec_gives_tpudists_items(spec):
    got = [_fields(i) for i in faults.parse_spec(spec)]
    assert got == [_fields(i) for i in jax_faults.parse_spec(spec)]
    assert faults.check_spec(spec) is not None


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_spec_gives_tpudists_errors(spec):
    with pytest.raises(ValueError) as want:
        jax_faults.parse_spec(spec)
    with pytest.raises(ValueError) as got:
        faults.parse_spec(spec)
    assert str(got.value) == str(want.value)


def test_gates_fire_as_tpudists(monkeypatch):
    def fired(mod, spec, point, step=None, env=()):
        for k, v in env:
            monkeypatch.setenv(k, v)
        inj = mod.configure(spec)
        return [inj.should_fire(point, step=step) is not None
                for _ in range(2)]

    for spec, point, step, env in (
            ("rank_exit@step=7", "rank_exit", 6, ()),
            ("rank_exit@step=7", "rank_exit", 7, ()),
            ("slow_peer@once", "slow_peer", None, ()),
            ("init_hang@attempt=0", "init_hang", None,
             ((faults.ENV_ATTEMPT, "1"),)),
            ("init_hang@attempt=0", "init_hang", None,
             ((faults.ENV_ATTEMPT, "0"),)),
            ("rank_exit@rank=1@step=0", "rank_exit", 0,
             ((faults.ENV_RANK, "2"),)),
            ("rank_exit@rank=1@step=0", "rank_exit", 0,
             ((faults.ENV_RANK, "1"),))):
        assert fired(faults, spec, point, step, env) == \
            fired(jax_faults, spec, point, step, env), spec


@pytest.mark.parametrize("p,fails", [(0.5, 0), (0.1, 1), (1.0, 2),
                                     (0.25, 3)])
def test_decode_should_fail_fails_tpudists_keys(p, fails):
    spec = f"decode_fail:p={p},fails={fails}"
    faults.configure(spec)
    jax_faults.configure(spec)
    for _ in range(fails + 1):           # heals after ``fails`` failures
        got = [k for k in range(500) if faults.decode_should_fail(k)]
        want = [k for k in range(500) if jax_faults.decode_should_fail(k)]
        assert got == want
    if fails:
        assert got == []                 # every key has healed
    else:
        assert got                       # a key that fails never heals


@pytest.mark.parametrize("code", [0, 1, 75, 76, 117, 130, -9, 137])
def test_classify_exit_agrees(code):
    assert faults.classify_exit(code) == jax_faults.classify_exit(code)


def test_exit_codes_are_tpudists():
    assert faults.PREEMPTED_EXIT_CODE == jax_faults.PREEMPTED_EXIT_CODE
    assert faults.SDC_EXIT_CODE == jax_faults.SDC_EXIT_CODE


def test_observer_sees_a_firing():
    seen = []
    faults.set_observer(lambda point, step, info: seen.append((point, step)))
    try:
        faults.configure("slow_peer:ms=0@step=3")
        faults.maybe_slow_peer(2)
        faults.maybe_slow_peer(3)
    finally:
        faults.set_observer(None)
    assert seen == [("slow_peer", 3)]


@pytest.mark.parametrize("point", ["bitflip", "lossbomb", "nanbomb",
                                   "watchdog_expire"])
def test_the_doctor_and_watchdog_points_are_armed(point):
    faults.configure(f"rank_exit@step=1;{point}@step=5")
    assert faults.armed(point) and point in faults.POINTS
    assert faults.should_fire(point, step=4) is None
    assert faults.should_fire(point, step=5) is not None


def test_unknown_point_is_refused_naming_the_points():
    with pytest.raises(ValueError, match="rank_exti \\(no such fault point; "
                                         "the port's are rank_exit, "):
        faults.configure("rank_exti@step=1")


def test_trainer_and_launcher_refuse_an_unknown_point(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="bitflp \\(no such fault point"):
        cli.main(["--device", "cpu", "--synthetic", "--num-classes", "4",
                  "--image-size", "32", "-b", "4", "--inject",
                  "bitflp@step=1", "--outpath", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()
    monkeypatch.setenv(faults.ENV_SPEC, "nanbom@step=1")
    with pytest.raises(ValueError, match="nanbom \\(no such fault point"):
        faults.configure()
    r = subprocess.run(
        [sys.executable, "-m", "tpudist_torch.launch", "-n", "1",
         "--inject", "watchdog_expir", "--", sys.executable, "-c", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert r.returncode == 2
    assert "watchdog_expir (no such fault point" in r.stderr


# -- the preemption guard ------------------------------------------------------

@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGINT])
def test_preemption_guard_flags_the_signal(sig):
    seen = []
    prev = signal.signal(sig, lambda s, f: seen.append(s))
    try:
        guard = _PreemptionGuard().install()
        guard.check()                                   # nothing yet
        os.kill(os.getpid(), sig)
        with pytest.raises(PreemptionRequested, match=sig.name):
            guard.check()
        assert seen == []
        # A second signal: the guard steps aside and re-raises it to the
        # handler that was there before.
        os.kill(os.getpid(), sig)
        assert seen == [sig]
        guard.uninstall()
    finally:
        signal.signal(sig, prev)


# -- the data cursor -----------------------------------------------------------

@pytest.mark.parametrize("n,consumed,shuffle,pad", [
    (50, 0, True, True), (50, 16, True, True), (50, 17, True, False),
    (50, 50, True, True), (37, 12, False, True), (64, 64 - 5, True, True)])
@pytest.mark.parametrize("world", [1, 2, 3])
def test_sampler_cursor_gives_tpudists_indices(n, consumed, shuffle, pad,
                                               world):
    for rank in range(world):
        mine = ShardedSampler(n, world, rank, shuffle=shuffle, seed=3,
                              pad=pad)
        ref = JaxSampler(n, world, rank, shuffle=shuffle, seed=3, pad=pad)
        for s in (mine, ref):
            s.set_epoch(2)
            s.set_cursor(consumed)
        assert np.array_equal(mine.indices(), ref.indices())
        assert len(mine) == len(ref) == len(mine.indices())
        for s in (mine, ref):
            s.set_epoch(3)                   # clears the cursor
        assert mine.cursor == 0
        assert np.array_equal(mine.indices(), ref.indices())
        assert len(mine) == len(ref)


@pytest.mark.parametrize("before,after", [(2, 1), (1, 2), (2, 4)])
def test_cursor_continues_the_global_order_across_a_world_change(before,
                                                                after):
    """Positions consumed at one world are neither replayed nor dropped
    at another: the continuation's ranks together see exactly the rest."""
    n, batch, steps = 96, 8, 5
    consumed = steps * batch
    seen = []
    for rank in range(before):
        s = ShardedSampler(n, before, rank, seed=1)
        s.set_epoch(4)
        seen += list(s.indices()[:steps * batch // before])
    rest = []
    for rank in range(after):
        s = ShardedSampler(n, after, rank, seed=1)
        ref = JaxSampler(n, after, rank, seed=1)
        for x in (s, ref):
            x.set_epoch(4)
            x.set_cursor(consumed)
        assert np.array_equal(s.indices(), ref.indices())
        rest += list(s.indices())
    assert sorted(seen + rest) == list(range(n))


class _Squares:
    """8x8 images of their index; ``bad`` indices fail to read."""

    def __init__(self, n=48, bad=()):
        self.n, self.bad = n, set(bad)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i in self.bad:
            raise IOError(f"unreadable sample {i}")
        return np.full((8, 8, 3), i, np.float32), i % 5


def _loaders(ds, world=2, rank=1, **kw):
    kw = dict(batch_size=4, num_workers=3, retries=2, retry_backoff=0.0,
              **kw)
    return (DataLoader(ds, sampler=ShardedSampler(len(ds), world, rank,
                                                  seed=7), **kw),
            JaxLoader(ds, sampler=JaxSampler(len(ds), world, rank, seed=7),
                      **kw))


def _epoch(loader):
    return [(x.copy(), y.astype(np.int64)) for x, y in loader]


def _same(got, want):
    assert len(got) == len(want) > 0
    for (a, la), (b, lb) in zip(got, want):
        assert np.array_equal(a, b) and np.array_equal(la, lb)


def test_loader_cursor_gives_tpudists_batches_and_carries_the_meters():
    mine, ref = _loaders(_Squares(bad={5}), skip_budget=4)
    for loader in (mine, ref):
        loader.set_epoch(1)
        loader.set_cursor(16, samples_skipped=3, samples_retried=2)
    _same(_epoch(mine), _epoch(ref))
    assert len(mine) == len(ref) == (48 - 16) // 2 // 4
    # The carried counts plus this attempt's own skip (if sample 5 is in
    # the rest of the epoch), as tpudist counts them.
    assert (mine.samples_skipped, mine.samples_retried) == \
        (ref.samples_skipped, ref.samples_retried)
    assert mine.samples_skipped >= 3 and mine.samples_retried == 2
    for loader in (mine, ref):
        loader.set_epoch(2)                     # the next epoch starts at 0
    _same(_epoch(mine), _epoch(ref))
    assert mine.samples_retried == ref.samples_retried == 0
    assert mine.samples_skipped == ref.samples_skipped


@pytest.mark.parametrize("spec,retries,budget", [
    ("decode_fail:p=0.3,fails=1", 2, 0),     # heals on the first retry
    ("decode_fail:p=0.3,fails=2", 2, 0),     # heals on the last retry
    ("decode_fail:p=0.1", 2, 20),            # never heals: skipped
    ("decode_fail:p=0.2,fails=3", 2, 20)])   # outlasts the retries
def test_decode_fail_heals_and_skips_as_tpudists(spec, retries, budget):
    got = {}
    for name, mod in (("port", faults), ("tpudist", jax_faults)):
        mod.configure(spec)
    mine, ref = _loaders(_Squares(), world=1, rank=0, skip_budget=budget)
    for loader in (mine, ref):
        loader.retries = retries
        loader.set_epoch(0)
    _same(_epoch(mine), _epoch(ref))
    got = (mine.samples_skipped, mine.samples_retried)
    assert got == (ref.samples_skipped, ref.samples_retried)
    if "fails=1" in spec or "fails=2" in spec:
        assert got[0] == 0 and got[1] > 0
    else:
        assert got[0] > 0


def test_decode_fail_past_the_budget_raises_as_tpudists():
    for mod in (faults, jax_faults):
        mod.configure("decode_fail:p=0.3")
    mine, ref = _loaders(_Squares(), world=1, rank=0, skip_budget=1)
    for loader in (mine, ref):
        loader.set_epoch(0)
        with pytest.raises(RuntimeError, match="corruption budget exceeded"):
            _epoch(loader)
