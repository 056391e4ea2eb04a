"""The measurement dispatch of the port (``ops/dispatch``,
``ops/attention_dispatch``, ``ops/norm_dispatch``) against tpudist's, on
the CPU.

- Decisions: ``dispatch.decide`` and tpudist's, given the same injected
  timings (ties among them) on an accelerator platform, pick the same
  winner from the same source with the same margin, and a tie keeps the
  plain side; the second call reads the cache.
- The cache: one file per client and card that tpudist's ``load_cache``
  reads; a kernel-revision bump, a torn file and a corrupt one each
  measure again; a cache dir that cannot be written keeps the verdict in
  process for ``lookup``; ``clear_cache`` removes it; ``auto`` on the CPU
  is the plain side without a measurement.
- ``measure_ms`` on a stand-in card: it reads the device's time of a
  host-paced call, not the host's, and raises for a call that waits on
  the card.
- Keys: ``shape_key`` and ``norm_key`` are tpudist's strings.
- Recorded workloads: the trainer's recording forward at batch 16 and
  ``--accum-steps 2`` records what ``tpudist.ops.norm_dispatch`` records
  over tpudist's resnet18 at microbatch 8, and moves no running statistic.
- The trainer on an accelerator platform (the CPU standing in for it):
  each BN site runs what its workload's verdict says, once a microbatch,
  the second run reads every verdict from the cache, and a probe that
  raises fails the run naming the workload and the kernels; a ViT's
  attention likewise.
- One verdict for the gang: two gloo ranks with opposite timings adopt
  rank 0's; a probe that raises on rank 0 raises on rank 1.

Run as a script (``--worker``), this file is one rank of the gang test.
"""

import json
import os
import subprocess
import sys

import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

from tpudist_torch import __main__ as cli
from tpudist_torch import config as port_config
from tpudist_torch.ops import attention_dispatch, dispatch, norm_dispatch
from tpudist_torch.ops import flash_attention as fa
from tpudist_torch.ops import fused_norm as fn

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("cand", "base")
KIND = "Test Card 80GB"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _mode_reset():
    yield
    norm_dispatch.set_mode(None)


def _never():
    raise AssertionError("measured where it must not")


def _decide(mod, cache_dir, platform, timings=None, rev=1, **kw):
    calls = []

    def pair():
        calls.append(1)
        return timings

    out = mod.decide("client", "b8_t197", mode=kw.pop("mode", "auto"),
                     names=NAMES, kernel_rev=lambda: rev, measure_pair=pair,
                     cache_dir=str(cache_dir), platform=platform,
                     device_kind=KIND, **kw)
    return out, len(calls)


# -- decisions and the cache --------------------------------------------------

@pytest.mark.parametrize("timings", [(1.0, 2.0), (2.0, 1.0), (1.5, 1.5),
                                     (0.0, 0.0), (0.10001, 0.1),
                                     (0.25, 0.2500001)])
def test_decisions_equal_tpudists(tmp_path, timings):
    jax_dispatch = pytest.importorskip("tpudist.ops.dispatch")
    mine, n = _decide(dispatch, tmp_path / "port", "cuda", timings)
    theirs, m = _decide(jax_dispatch, tmp_path / "jax", "tpu", timings)
    assert n == m == 1
    for k in ("kernel", "source", "margin", "cand_ms", "base_ms",
              "cache_hit"):
        assert mine[k] == theirs[k], k
    assert mine["kernel"] == ("cand" if timings[0] < timings[1] else "base")
    again, n = _decide(dispatch, tmp_path / "port", "cuda", _never)
    jagain, _ = _decide(jax_dispatch, tmp_path / "jax", "tpu", _never)
    assert n == 0 and again["source"] == jagain["source"] == "cache"
    assert again["kernel"] == mine["kernel"] and again["cache_hit"]
    # tpudist reads the port's file: one format.
    entry = jax_dispatch.load_cache(mine["cache_path"])["entries"]["b8_t197"]
    assert entry["kernel"] == mine["kernel"] and entry["kernel_rev"] == 1


def test_forced_ineligible_and_off_card_need_no_measurement(tmp_path):
    for mode, kernel in (("on", "cand"), ("off", "base")):
        out, n = _decide(dispatch, tmp_path, "cuda", _never, mode=mode)
        assert (out["kernel"], out["source"], n) == (kernel, "forced", 0)
    out, n = _decide(dispatch, tmp_path, "cuda", _never,
                     eligibility=(False, "why"))
    assert (out["kernel"], out["source"], out["reason"], n) == \
        ("base", "ineligible", "why", 0)
    out, n = _decide(dispatch, tmp_path, "cpu", _never)
    assert (out["kernel"], out["source"], n) == ("base", "platform", 0)
    assert not os.listdir(tmp_path)
    with pytest.raises(ValueError, match="mode"):
        _decide(dispatch, tmp_path, "cuda", _never, mode="maybe")


def test_kernel_rev_bump_and_a_torn_or_corrupt_file_measure_again(tmp_path):
    out, n = _decide(dispatch, tmp_path, "cuda", (1.0, 2.0))
    path = out["cache_path"]
    assert path == dispatch.cache_path("client", KIND, str(tmp_path))
    assert os.path.basename(path) == "client.Test-Card-80GB.json"
    out, n = _decide(dispatch, tmp_path, "cuda", (3.0, 2.0), rev=2)
    assert (n, out["source"], out["kernel"]) == (1, "measured", "base")
    for damage in ('{"version": 1, "entries": {"b8', "[1, 2, 3]",
                   '{"version": 7, "entries": {}}'):
        with open(path, "w") as f:
            f.write(damage)
        out, n = _decide(dispatch, tmp_path, "cuda", (1.0, 2.0), rev=2)
        assert (n, out["source"], out["kernel"]) == (1, "measured", "cand")
    assert dispatch.load_cache(path)["entries"]["b8_t197"]["kernel"] == "cand"
    out, n = _decide(dispatch, tmp_path, "cuda", _never, rev=2)
    assert (n, out["source"]) == (0, "cache")
    assert dispatch.clear_cache("client", cache_dir=str(tmp_path)) == 1
    out, n = _decide(dispatch, tmp_path, "cuda", (1.0, 2.0), rev=2)
    assert n == 1


def test_unwritable_cache_dir_keeps_the_verdict_in_process(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    cache_dir = blocker / "cache"          # cannot be made
    look = dict(candidate="cand", kernel_rev=lambda: 1,
                cache_dir=str(cache_dir), platform="cuda", device_kind=KIND)
    assert not dispatch.lookup("client", "b8_t197", **look)
    out, n = _decide(dispatch, cache_dir, "cuda", (1.0, 2.0))
    assert (n, out["kernel"], out["cache_path"]) == (1, "cand", None)
    assert dispatch.lookup("client", "b8_t197", **look)
    assert not dispatch.lookup("client", "b8_t197",
                               **dict(look, kernel_rev=lambda: 2))
    assert not dispatch.lookup("client", "b8_t197",
                               **dict(look, platform="cpu"))
    dispatch.clear_cache("client", KIND, str(cache_dir))
    assert not dispatch.lookup("client", "b8_t197", **look)


def test_the_clients_on_the_cpu_take_the_plain_side_unmeasured(tmp_path):
    dec = attention_dispatch.decide(8, 197, 12, 64, torch.bfloat16,
                                    cache_dir=str(tmp_path),
                                    measure_pair=_never, platform="cpu")
    assert (dec["kernel"], dec["source"]) == ("plain", "platform")
    dec = norm_dispatch.decide(2048, 64, torch.bfloat16, residual=False,
                               cache_dir=str(tmp_path), measure_pair=_never,
                               platform="cpu")
    assert (dec["kernel"], dec["source"]) == ("plain", "platform")
    dec = norm_dispatch.decide(4, 64, torch.bfloat16, residual=False,
                               mode="on", measure_pair=_never)
    assert (dec["kernel"], dec["source"]) == ("plain", "ineligible")
    dec = attention_dispatch.decide(8, 197, 12, 96, torch.bfloat16,
                                    measure_pair=_never, platform="cuda")
    assert dec["source"] == "ineligible" and "head dims" in dec["reason"]
    assert not os.listdir(tmp_path)


# -- keys ---------------------------------------------------------------------

class _Card:
    """A stand-in card for ``measure_ms``: a host clock that a call
    advances by ``host_ms``, a device that runs each call's ``device_ms``
    (and a spin's cycles at 2 GHz) in order once the host has queued it,
    and CUDA-like events on the two clocks."""

    def __init__(self, host_ms, device_ms, waits=False):
        self.host = self.dev = 0.0
        self.host_ms, self.device_ms, self.waits = host_ms, device_ms, waits

    def _run(self, seconds):
        self.dev = max(self.dev, self.host) + seconds

    def call(self):
        self.host += self.host_ms / 1e3
        self._run(self.device_ms / 1e3)
        if self.waits:
            self.synchronize()

    def synchronize(self):
        self.host = max(self.host, self.dev)

    def event(self, enable_timing=False):
        card = self

        class Event:
            def record(self):
                card._run(0.0)
                self.t = card.dev

            def query(self):
                return card.host >= self.t

            def synchronize(self):
                card.host = max(card.host, self.t)

            def elapsed_time(self, other):
                return (other.t - self.t) * 1e3
        return Event()


@pytest.mark.parametrize("host_ms,device_ms,waits", [
    (1.0, 0.1, False), (0.05, 2.0, False), (1.0, 0.1, True)],
    ids=["host_paced", "device_paced", "waits_on_the_card"])
def test_measure_ms_times_the_card_not_the_host(monkeypatch, host_ms,
                                                 device_ms, waits):
    """A call the host needs 1 ms to queue and the card 0.1 ms to run
    reads 0.1 ms, not the host's 1 ms; a device-paced call reads its
    device time; a call that waits on the card raises instead of timing
    the host."""
    card = _Card(host_ms, device_ms, waits)
    monkeypatch.setattr(dispatch.time, "perf_counter", lambda: card.host)
    monkeypatch.setattr(torch.cuda, "synchronize", card.synchronize)
    monkeypatch.setattr(torch.cuda, "_sleep",
                        lambda cycles: card._run(cycles / 2e9))
    monkeypatch.setattr(torch.cuda, "Event", card.event)
    if waits:
        with pytest.raises(RuntimeError, match="waits on the card"):
            dispatch.measure_ms(card.call, ())
        return
    assert dispatch.measure_ms(card.call, ()) == pytest.approx(device_ms)


def test_keys_are_tpudists_strings():
    jnp = pytest.importorskip("jax.numpy")
    from tpudist.ops import attention_dispatch as jax_attention
    from tpudist.ops import norm_dispatch as jax_norm
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                     (torch.float32, jnp.float32),
                     (torch.float16, jnp.float16)):
        for args in ((128, 197, 12, 64, True, False),
                     (8, 50, 16, 80, False, True)):
            b, t, h, d, train, causal = args
            assert attention_dispatch.shape_key(b, t, h, d, tdt, train,
                                                causal) == \
                jax_attention.shape_key(b, t, h, d, jdt, train, causal)
        for rows, ch, res in ((1605632, 64, False), (6272, 512, True)):
            assert norm_dispatch.norm_key(rows, ch, tdt, res) == \
                jax_norm.norm_key(rows, ch, jdt, res)
    assert attention_dispatch.shape_key(128, 197, 12, 64, torch.bfloat16,
                                        True, False) == \
        "b128_t197_h12_d64_bfloat16_train_full"
    for seq, hd, ok in ((197, 64, True), (197, 128, False), (8, 64, False)):
        assert attention_dispatch.flash_eligible(seq=seq, head_dim=hd)[0] \
            is ok
        assert jax_attention.flash_eligible(seq=seq, head_dim=hd)[0] is \
            (ok or hd == 128)          # tpudist's kernel tiles up to 256
    for rows, ch in ((8, 64), (7, 64), (64, 8193), (0, 3)):
        assert norm_dispatch.fused_eligible(rows=rows, channels=ch) == \
            jax_norm.fused_eligible(rows=rows, channels=ch)


# -- the trainer --------------------------------------------------------------

ARGS = ["--device", "cpu", "--synthetic", "-a", "resnet18", "--num-classes",
        "8", "--image-size", "32", "-b", "16", "--accum-steps", "2",
        "--synthetic-size", "32", "--epochs", "1", "-p", "1", "--seed", "0",
        "--keep-checkpoints", "0", "--telemetry"]


def _trainer(tmp_path, *extra):
    from tpudist_torch.trainer import Trainer
    cfg = port_config.from_args(ARGS + list(extra) + [
        "--outpath", str(tmp_path / "run"), "--overwrite", "delete"])
    return Trainer(cfg)


def test_recorded_workloads_equal_tpudists_at_the_microbatch(tmp_path):
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from tpudist.models import resnet as jax_resnet
    from tpudist.ops import norm_dispatch as jax_norm
    tr = _trainer(tmp_path, "--fused-bn", "on")
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    mine = tr._record_fused_norm_requests()
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    jm = jax_resnet.resnet18(dtype=jnp.bfloat16, num_classes=8)
    variables = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    jax_norm.set_mode("on")
    try:
        with jax_norm.record_requests() as theirs:
            jax.eval_shape(lambda v, im: jm.apply(
                v, im, train=True, mutable=["batch_stats"]), variables,
                jax.ShapeDtypeStruct((8, 32, 32, 3), jnp.float32))
    finally:
        jax_norm.set_mode(None)
    strip = lambda reqs: {r[:4] for r in reqs}  # noqa: E731
    assert strip(mine) == strip(theirs)
    assert len(mine) == 9 and {r[0] for r in mine} >= {8 * 16 * 16}
    assert norm_dispatch.combined_key(mine) == jax_norm.combined_key(theirs)
    sites = [m.dispatch_key for m in tr.model.modules()
             if getattr(m, "dispatch_key", None)]
    assert len(sites) == 17 and set(sites) == {r[2] for r in mine}


@pytest.fixture
def card_standin(monkeypatch, tmp_path):
    """The CPU as the measured platform, a named card, a fresh cache."""
    monkeypatch.setattr(dispatch, "ACCELERATOR", "cpu")
    monkeypatch.setattr(dispatch, "card_kind", lambda device=None: KIND)
    monkeypatch.setenv(dispatch.ENV_CACHE_DIR, str(tmp_path / "cache"))


def test_auto_sets_each_site_from_its_verdict_and_the_cache_holds(
        tmp_path, card_standin, monkeypatch, capsys):
    measured = []

    def timings(rows, channels, dtype, residual, device=None):
        measured.append((rows, channels, residual))
        # The kernel wins the plain-variant workloads and loses the rest.
        return (1.0, 2.0) if not residual else (2.0, 1.0)

    monkeypatch.setattr(norm_dispatch, "measure_fused_norm", timings)
    calls = {"fwd": 0, "fwd_res": 0}
    real = fn.bn_act_fwd

    def counted(x2, r2, a, b):
        calls["fwd" if r2 is None else "fwd_res"] += 1
        return real(x2, r2, a, b)

    monkeypatch.setattr(fn, "bn_act_fwd", counted)
    tr = _trainer(tmp_path)
    assert len(measured) == 9
    agg = tr.fused_norm_decision
    assert (agg["kernel"], agg["source"], agg["n_sites"], agg["n_fused"]) \
        == ("mixed", "measured", 9, 5)
    for m in tr.model.modules():
        if getattr(m, "dispatch_key", None):
            assert m.fused is m.dispatch_key.endswith("_plain")
    x = torch.randn(16, 32, 32, 3)
    tr.train_step(x, torch.randint(0, 8, (16,)), 0.1)
    # 9 plain-variant sites, 2 microbatches; no residual site fused.
    assert calls == {"fwd": 18, "fwd_res": 0}
    text = capsys.readouterr().out
    assert ("=> fused-norm dispatch: mixed epilogue (mode auto, measured; "
            "5/9 BN workloads fused)") in text
    assert ("=>   m2048_c64_bfloat16_plain (1 site): cuda 1.0000 ms vs "
            "plain 2.0000 ms, margin 50.0% → cuda (measured)") in text
    events = [json.loads(ln) for ln in open(tmp_path / "run" /
                                              "events.0.jsonl")]
    ev = next(e for e in events if e["type"] == "fused_norm_dispatch")
    assert (ev["kernel"], ev["n_fused"]) == ("mixed", 5)

    measured.clear()
    tr = _trainer(tmp_path)
    assert not measured
    assert tr.fused_norm_decision["source"] == "cache"
    assert "(mode auto, cache; 5/9 BN workloads fused)" in \
        capsys.readouterr().out


def test_a_probe_that_fails_fails_the_run_naming_the_workload(
        tmp_path, card_standin, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("CUDA error 98: invalid device function")

    monkeypatch.setattr(norm_dispatch, "measure_fused_norm", broken)
    with pytest.raises(RuntimeError, match=r"fused-norm dispatch probe "
                       r"failed at m\d+_c\d+_bfloat16_(plain|res) \(kernels "
                       r"bn_act_fwd.*invalid device function"):
        cli.main(ARGS + ["--outpath", str(tmp_path / "a")])
    monkeypatch.setattr(attention_dispatch, "measure_attention", broken)
    vit = ["--device", "cpu", "--synthetic", "-a", "vit_b_16",
           "--image-size", "128", "--num-classes", "10", "-b", "2",
           "--synthetic-size", "4", "--epochs", "1"]
    with pytest.raises(RuntimeError, match=r"attention dispatch probe failed "
                       r"at b2_t65_h12_d64_bfloat16_train_full \(kernels "
                       r"flash_fwd, flash_bwd_dq, flash_bwd_dkv\)"):
        cli.main(vit + ["--outpath", str(tmp_path / "b")])


def test_vit_auto_routes_attention_by_its_verdict(tmp_path, card_standin,
                                                  monkeypatch, capsys):
    monkeypatch.setattr(attention_dispatch, "measure_attention",
                        lambda *a, **k: (1.0, 3.0))
    fa.reset_counts()
    calls = []
    real = fa.flash_attention_fwd
    monkeypatch.setattr(fa, "flash_attention_fwd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    from tpudist_torch.trainer import Trainer
    cfg = port_config.from_args([
        "--device", "cpu", "--synthetic", "-a", "vit_b_16", "--image-size",
        "128", "--num-classes", "10", "-b", "2", "--synthetic-size", "4",
        "--epochs", "1", "--model-ema-decay", "0.5", "--outpath",
        str(tmp_path / "v")])
    tr = Trainer(cfg)
    for model in (tr.model, tr.ema):
        assert model.encoder_layer_0.self_attention.flash
    tr.train_step(torch.randn(2, 128, 128, 3), torch.tensor([1, 2]), 1e-3)
    assert len(calls) == 12
    assert ("=> attention dispatch: flash attention (mode auto, measured; "
            "b2_t65_h12_d64_bfloat16_train_full: flash 1.0000 ms vs plain "
            "3.0000 ms, margin 66.7%)") in capsys.readouterr().out


def test_serve_resolves_auto_at_the_largest_bucket(tmp_path, card_standin,
                                                   monkeypatch):
    from tpudist_torch.serve.export import load_serve_state
    seen = []
    monkeypatch.setattr(attention_dispatch, "measure_attention",
                        lambda *a, **k: seen.append(a) or (2.0, 1.0))
    logs = []
    model = load_serve_state("vit_b_16", image_size=64, max_batch=4,
                             device="cpu", log=logs.append)
    assert seen == [(4, 17, 12, 64, torch.bfloat16, False, False,
                     torch.device("cpu"))]
    assert not model.encoder_layer_11.self_attention.flash
    assert logs[0].startswith("=> serve attention dispatch: plain attention "
                              "(mode auto, measured; b4_t17_h12_d64_"
                              "bfloat16_eval_full: flash 2.0000 ms")


# -- one verdict for the gang -------------------------------------------------

def _worker(workdir: str) -> None:
    from tpudist_torch import dist as dist_lib
    dist_lib.initialize_runtime(device="cpu")
    rank, _ = dist_lib.data_rank_world()
    timings = (1.0, 2.0) if rank == 0 else (2.0, 1.0)
    cache = os.path.join(workdir, f"cache{rank}")
    dec = dispatch.shared_decision(
        lambda: dispatch.decide("client", "k", mode="auto", names=NAMES,
                                kernel_rev=lambda: 1,
                                measure_pair=lambda: timings,
                                cache_dir=cache, platform="cuda",
                                device_kind=KIND), what="test dispatch")
    failed = None

    def broken():
        raise RuntimeError("probe broke on rank 0")
    try:
        dispatch.shared_decision(broken if rank == 0 else _never,
                                 what="test dispatch")
    except RuntimeError as e:
        failed = str(e)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump({"kernel": dec["kernel"], "source": dec["source"],
                   "shared": dec.get("shared_from_primary", 0),
                   "failed": failed,
                   "cached": os.path.exists(cache)}, f)
    dist_lib.shutdown()


def test_two_gloo_ranks_adopt_rank_0s_verdict(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "tpudist_torch.launch", "-n", "2", "--",
         sys.executable, os.path.join(REPO, "tests", "test_torch_dispatch.py"),
         "--worker", str(tmp_path)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    ranks = [json.load(open(tmp_path / f"rank{i}.json")) for i in (0, 1)]
    assert [(d["kernel"], d["source"], d["shared"]) for d in ranks] == \
        [("cand", "measured", 0), ("cand", "measured", 1)]
    assert ranks[0]["cached"] and not ranks[1]["cached"]   # rank 1 measured
    assert "probe broke on rank 0" in ranks[0]["failed"]   # nothing
    assert ranks[1]["failed"].startswith("rank 0's test dispatch probe "
                                         "failed: RuntimeError('probe broke")


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2])
