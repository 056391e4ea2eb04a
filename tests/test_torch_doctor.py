"""The port's doctor (``tpudist_torch/doctor/``, the guarded step, the
replay windows, the verdicts and the fault points) against tpudist's, on
the CPU.

- ``LossMonitor`` and ``Doctor.on_metrics`` see the same drained series
  on both sides (seeded numpy losses with planted spikes, NaN runs and
  float16 scaler overflows) and make the same decisions: the same spikes
  with the same evidence, the same ``RollbackRequested`` (step, reason,
  info), the same windows and counters, the same ``doctor`` events.
- ``divergent_ranks`` votes as tpudist's; the digest exchange through the
  run dir and the eviction run with two port ranks in one process (and a
  third rank's published digest): equal states digest alike, one flipped
  bit changes the digest, the minority rank evicts itself after
  ``--doctor-sdc-windows`` probes and the primary stamps the verdicts.
- The guarded step against tpudist's ``make_train_step(guard=True)`` on a
  one-device mesh, from the same flax init: the tiny resnet18 under SGD
  with an EMA, the tiny ViT under AdamW, and the tiny resnet18 in float16
  at a scale that overflows. A good step, a NaN batch, a good step:
  ``notfinite`` equals tpudist's at every step, ``gnorm`` agrees within
  1e-4 of tpudist's (relative) where finite, the state after the NaN
  step equals the state before it bit for bit (parameters, BN buffers,
  the optimizer's state, the EMA), and the step after it lands within
  ``tests/test_torch_train.py``'s loss bound of tpudist's. In float16
  the overflow is the scaler's: ``scaler_skip`` 1, ``notfinite`` 0.
- The sampler's replay minus a window equals tpudist's position for
  position (windows in sequence, with the cursor, at world 1 and 2), and
  the loader's batches equal tpudist's.
- ``lossbomb`` and ``bitflip`` corrupt, for resnet18 and the tiny ViT, the
  parameter whose carried-over counterpart tpudist's corrupt, by the same
  bits.
- Verdict stamping and the ``require_verified`` walk on port-written
  checkpoints, read back by tpudist's ``read_verdict``.
"""

import functools
import math

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from jax.sharding import Mesh  # noqa: E402

from tpudist import checkpoint as jax_ckpt  # noqa: E402
from tpudist import config as jax_config  # noqa: E402
from tpudist import faults as jax_faults  # noqa: E402
from tpudist import train as jax_train  # noqa: E402
from tpudist.data.loader import DataLoader as JaxLoader  # noqa: E402
from tpudist.data.sampler import ShardedSampler as JaxSampler  # noqa: E402
from tpudist.data.synthetic import SyntheticDataset as JaxSynthetic  # noqa: E402
from tpudist.doctor import Doctor as JaxDoctor  # noqa: E402
from tpudist.doctor import LossMonitor as JaxMonitor  # noqa: E402
from tpudist.doctor import probes as jax_probes  # noqa: E402
from tpudist.doctor.policy import RollbackRequested as JaxRollback  # noqa: E402
from tpudist.models import resnet as jax_resnet  # noqa: E402
from tpudist.models.vit import VisionTransformer as JaxViT  # noqa: E402
from tpudist.ops import norm_dispatch  # noqa: E402

from tpudist_torch import checkpoint as ckpt  # noqa: E402
from tpudist_torch import config as port_config  # noqa: E402
from tpudist_torch import faults  # noqa: E402
from tpudist_torch import train as port_train  # noqa: E402
from tpudist_torch.compat.jax_params import state_dict_from_jax  # noqa: E402
from tpudist_torch.data.loader import DataLoader  # noqa: E402
from tpudist_torch.data.sampler import ShardedSampler  # noqa: E402
from tpudist_torch.data.synthetic import SyntheticDataset  # noqa: E402
from tpudist_torch.doctor import Doctor, LossMonitor, RollbackRequested  # noqa: E402
from tpudist_torch.doctor import probes  # noqa: E402
from tpudist_torch.models import create_model  # noqa: E402
from tpudist_torch.models.vit import VisionTransformer  # noqa: E402

pytestmark = pytest.mark.torch_port

R18 = dict(num_classes=10, width=16)
VIT = dict(patch_size=8, hidden_dim=64, num_layers=2, num_heads=4,
           mlp_dim=128, num_classes=10)
BATCH = 8


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _quiet():
    """The injectors are process-wide, the JAX epilogue plain."""
    faults.configure("")
    jax_faults.configure("")
    norm_dispatch.set_mode("off")
    yield
    faults.configure("")
    jax_faults.configure("")
    norm_dispatch.set_mode(None)


# -- the EWMA monitor and the policy on the same series ----------------------

def _series(seed: int, n: int = 60) -> list:
    """A falling loss with noise, spikes, NaN steps and scaler overflows
    (a spike planted at step 20, a NaN run at 40-45):
    ``(notfinite, scaler_skip, loss)`` a step."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        loss = 2.5 * math.exp(-i / 30) + 0.05 * rng.standard_normal()
        notfinite, skip = 0.0, 0.0
        r = rng.random()
        if r < 0.06:
            loss *= 40.0                       # a spike
        elif r < 0.12:
            notfinite, loss = 1.0, float("nan")
        elif r < 0.2:
            skip = 1.0
        if i == 20:
            notfinite, skip, loss = 0.0, 0.0, 60.0    # a planted spike
        if 40 <= i < 46:
            notfinite, loss = 1.0, float("nan")        # a planted NaN run
        out.append((notfinite, skip, loss))
    return out


@pytest.mark.parametrize("seed,sigma,min_steps", [(0, 6.0, 8), (1, 3.0, 2),
                                                  (2, 6.0, 1), (3, 2.0, 4)])
def test_monitor_matches_tpudists_on_the_same_series(seed, sigma, min_steps):
    ours, theirs = LossMonitor(sigma, min_steps), JaxMonitor(sigma, min_steps)
    for notfinite, _, loss in _series(seed):
        assert ours.observe(loss) == theirs.observe(loss)
        assert (ours.mean, ours.var, ours.n) == (theirs.mean, theirs.var,
                                                 theirs.n)
    ours.reset()
    theirs.reset()
    assert (ours.mean, ours.var, ours.n) == (theirs.mean, theirs.var,
                                             theirs.n)


class _Events:
    def __init__(self):
        self.got = []

    def emit(self, etype, **fields):
        self.got.append((etype, fields))


def _pair(tmp_path, **kw):
    fields = dict(doctor=True, **kw)
    tel_a, tel_b = _Events(), _Events()
    ours = Doctor(port_config.Config(**fields), str(tmp_path / "a"), rank=0,
                  world=1, telemetry=tel_a)
    theirs = JaxDoctor(jax_config.Config(**fields), str(tmp_path / "b"),
                       rank=0, world=1, telemetry=tel_b)
    return ours, theirs, tel_a, tel_b


@pytest.mark.parametrize("seed,kw", [
    (0, dict(doctor_spike_min_steps=4)),
    (1, dict(doctor_max_skips=2, doctor_spike_sigma=3.0)),
    (4, dict(doctor_max_skips=1, doctor_spike_min_steps=2)),
    (5, dict(doctor_spike_sigma=100.0, doctor_max_skips=3)),
])
def test_on_metrics_decides_as_tpudist(tmp_path, seed, kw):
    ours, theirs, tel_a, tel_b = _pair(tmp_path, **kw)
    decisions = []
    for step, (notfinite, skip, loss) in enumerate(_series(seed)):
        for doc in (ours, theirs):
            doc.note_step(step, epoch=step // 16, pos_start=(step % 16) * 8,
                          pos_end=(step % 16 + 1) * 8)
            doc.on_metrics(step, {"notfinite": notfinite,
                                  "scaler_skip": skip, "loss": loss,
                                  "gnorm": 1.5})
        got = []
        for doc, cls in ((ours, RollbackRequested), (theirs, JaxRollback)):
            try:
                doc.check_response()
                got.append(None)
            except cls as rb:
                got.append((rb.step, rb.reason, rb.info, doc.windows_for(rb)))
                doc.on_rollback(rb, to_epoch=rb.step // 16,
                                windows=doc.windows_for(rb))
        assert got[0] == got[1], step
        decisions.append(got[0])
    assert ours.summary() == theirs.summary()
    assert tel_a.got == tel_b.got
    assert any(decisions), "the series must provoke a decision"


@pytest.mark.parametrize("digests", [
    {0: "a", 1: "a", 2: "a"}, {0: "a", 1: "b", 2: "a"},
    {0: "a", 1: "b", 2: "a", 3: "b"}, {0: "a", 1: "b"}, {0: "a"},
    {0: "x", 1: "y", 2: "z"}, {0: "a", 1: "a", 2: "b", 3: "c", 4: "a"}])
def test_divergent_ranks_votes_as_tpudist(digests):
    assert probes.divergent_ranks(digests) == \
        jax_probes.divergent_ranks(digests)


def _resnet(seed=0):
    m = create_model("resnet18", **R18)
    m.reset_parameters(torch.Generator().manual_seed(seed))
    return m


def test_digest_exchange_and_eviction_with_two_ranks_in_one_process(
        tmp_path):
    out = str(tmp_path)
    cfg = port_config.Config(doctor=True, doctor_probe_freq=1,
                             doctor_sdc_windows=2)
    models = [_resnet(), _resnet()]
    opts = [port_train.make_optimizer(m, cfg) for m in models]
    leaves = [probes.state_leaves(m, o) for m, o in zip(models, opts)]
    digest = probes.replicated_digest(leaves[0])
    assert probes.replicated_digest(leaves[1]) == digest
    # A live file for the verdicts.
    ckpt.save_checkpoint(ckpt.state_to_dict(
        models[0], opts[0], arch="resnet18", epoch=0, best_acc1=0.0,
        step=0), False, out)
    live = f"{out}/{ckpt.CKPT_NAME}"
    tel = _Events()
    docs = [Doctor(cfg, out, rank=r, world=3, telemetry=tel, primary=r == 0)
            for r in (0, 1)]
    # Probe 1: all agree (rank 2 publishes the same digest).
    probes.write_digest(out, 2, 1, digest)
    probes.write_digest(out, 1, 1, digest)
    assert docs[0].probe(1, leaves[0]) is None
    assert docs[1].probe(1, leaves[1]) is None
    assert jax_ckpt.read_verdict(live)["verdict"] == "good"
    # Rank 1's state takes one flipped bit.
    faults.configure("bitflip@step=2@rank=1")
    import os
    os.environ[faults.ENV_RANK] = "1"
    try:
        assert faults.maybe_bitflip(2, models[1]) == "bn1.bias"
    finally:
        del os.environ[faults.ENV_RANK]
    flipped = probes.replicated_digest(leaves[1])
    assert flipped != digest
    verdicts = []
    for step in (2, 3):
        probes.write_digest(out, 2, step, digest)
        probes.write_digest(out, 1, step, flipped)
        verdicts.append((docs[0].probe(step, leaves[0]),
                         docs[1].probe(step, leaves[1])))
    assert verdicts == [(None, None), (None, "evict")]
    assert docs[0].divergences == docs[1].divergences == 2
    probes_ev = [f for e, f in tel.got if e == "sdc_probe"]
    assert [p["divergent_ranks"] for p in probes_ev] == ["", "", "1", "1",
                                                         "1", "1"]
    assert ("doctor", {"action": "evict", "step": 3, "divergent_rank": 1,
                       "windows": 2}) in tel.got
    # Nothing written while the ranks disagree is trusted: the live file
    # kept its good verdict (stamped before), a new save goes suspect.
    ckpt.save_checkpoint(ckpt.state_to_dict(
        models[0], opts[0], arch="resnet18", epoch=1, best_acc1=0.0,
        step=3), False, out)
    probes.write_digest(out, 2, 4, digest)
    probes.write_digest(out, 1, 4, flipped)
    docs[0].probe(4, leaves[0])
    assert jax_ckpt.read_verdict(live)["verdict"] == "suspect"


# -- the guarded step against tpudist's --------------------------------------

def _batches(k, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, BATCH).astype(np.int32)) for _ in range(k)]


CASES = {
    "resnet18_sgd": dict(arch="resnet18", optimizer="sgd", lr=0.005,
                         use_amp=False, model_ema_decay=0.5),
    "vit_adamw": dict(arch="vit_b_16", optimizer="adamw", lr=1e-3,
                      weight_decay=0.05, use_amp=False, flash="off"),
    "resnet18_f16": dict(arch="resnet18", optimizer="sgd", lr=0.005,
                         use_amp=True, amp_dtype="float16"),
}


def _fields(case):
    return dict(num_classes=10, image_size=32, batch_size=BATCH, seed=0,
                doctor=True, **CASES[case])


@functools.lru_cache(maxsize=None)
def _jax_side(case):
    f = _fields(case)
    jcfg = jax_config.Config(**dict(f, fused_bn="off"))
    dtype = jax_train.compute_dtype(jcfg)
    jm = (JaxViT(**VIT) if f["arch"].startswith("vit")
          else jax_resnet.resnet18(dtype=dtype, **R18))
    state = jax_train.create_train_state(jax.random.PRNGKey(0), jm, jcfg,
                                         input_shape=(1, 32, 32, 3))
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    return (jax.device_get(state),
            jax_train.make_train_step(mesh, jm, jcfg, guard=True))


def _port_side(case, host_state):
    f = _fields(case)
    pcfg = port_config.Config(**f)
    dtype = port_train.compute_dtype(pcfg)
    if f["arch"].startswith("vit"):
        build = lambda: VisionTransformer(*VIT.values(), image_size=32)  # noqa: E731
    else:
        build = lambda: create_model("resnet18", dtype=dtype,  # noqa: E731
                                     fused_bn=True, **R18)
    pm = build()
    pm.load_state_dict(state_dict_from_jax(
        f["arch"], host_state.params, host_state.batch_stats), strict=True)
    ema = (port_train.make_ema(pm, build) if pcfg.model_ema_decay else None)
    opt = port_train.make_optimizer(pm, pcfg)
    scaler = port_train.make_scaler(pcfg)
    step = port_train.make_train_step(pm, opt, pcfg, ema=ema, scaler=scaler,
                                      guard=True)
    return pm, opt, ema, scaler, step


def _snapshot(pm, opt, ema):
    sd = {k: v.clone() for k, v in pm.state_dict().items()}
    opt_state = {(i, k): v.clone() for i, p in enumerate(pm.parameters())
                 for k, v in opt.state.get(p, {}).items()
                 if torch.is_tensor(v)}
    esd = ({} if ema is None
           else {k: v.clone() for k, v in ema.state_dict().items()})
    return sd, opt_state, esd


def _assert_bit_equal(a, b):
    for part_a, part_b in zip(a, b):
        assert set(part_a) == set(part_b)
        for k in part_a:
            assert torch.equal(part_a[k], part_b[k]), k


@pytest.mark.parametrize("case", ["resnet18_sgd", "vit_adamw"])
def test_guarded_step_skips_as_tpudist_and_restores_every_bit(case):
    host_state, jstep = _jax_side(case)
    state = jax.tree_util.tree_map(jnp.asarray, host_state)
    pm, opt, ema, _, pstep = _port_side(case, host_state)
    lr = 0.005 if case.endswith("sgd") else 1e-3
    (x0, y0), (x1, y1), (x2, y2) = _batches(3)
    x1 = x1 * np.float32("nan")
    flags, norms, losses = [], [], []
    for i, (x, y) in enumerate(((x0, y0), (x1, y1), (x2, y2))):
        if i == 1:
            before = _snapshot(pm, opt, ema)
        state, jm = jstep(state, jnp.asarray(x), jnp.asarray(y),
                          jnp.asarray(lr, jnp.float32))
        pm_out = pstep(torch.from_numpy(x), torch.from_numpy(y), lr)
        if i == 1:
            _assert_bit_equal(before, _snapshot(pm, opt, ema))
        flags.append((float(pm_out["notfinite"]), float(jm["notfinite"])))
        norms.append((float(pm_out["gnorm"]), float(jm["gnorm"])))
        losses.append((float(pm_out["loss"]), float(jm["loss"])))
    assert flags == [(0.0, 0.0), (1.0, 1.0), (0.0, 0.0)]
    for i in (0, 2):
        got, want = norms[i]
        assert abs(got - want) <= 1e-4 * want, (i, got, want)
        assert abs(losses[i][0] - losses[i][1]) <= 1e-4, (i, losses[i])
    assert not math.isfinite(norms[1][0]) and not math.isfinite(norms[1][1])


def test_guarded_float16_overflow_is_the_scalers_skip():
    from flax.training import dynamic_scale as ds_lib
    host_state, jstep = _jax_side("resnet18_f16")
    state = jax.tree_util.tree_map(jnp.asarray, host_state).replace(
        dynamic_scale=ds_lib.DynamicScale(scale=2.0 ** 30))
    pm, opt, ema, scaler, pstep = _port_side("resnet18_f16", host_state)
    scaler.scale = 2.0 ** 30
    (x, y), = _batches(1)
    before = _snapshot(pm, opt, ema)
    state, jm = jstep(state, jnp.asarray(x), jnp.asarray(y),
                      jnp.asarray(0.005, jnp.float32))
    got = pstep(torch.from_numpy(x), torch.from_numpy(y), 0.005)
    assert (float(got["notfinite"]), got["scaler_skip"]) == \
        (float(jm["notfinite"]), float(jm["scaler_skip"])) == (0.0, 1.0)
    assert scaler.scale == float(state.dynamic_scale.scale) < 2.0 ** 30
    after = _snapshot(pm, opt, ema)
    for k, v in before[0].items():
        if "running" not in k and not k.endswith((".mean", ".var")):
            assert torch.equal(v, after[0][k]), k


# -- the replay windows --------------------------------------------------------

@pytest.mark.parametrize("world,windows,cursor", [
    (1, [(8, 16)], 0), (1, [(8, 16), (0, 4)], 0), (2, [(16, 24)], 0),
    (2, [(8, 16)], 8), (1, [(40, 48)], 3), (2, [(0, 1), (5, 9)], 2)])
def test_sampler_replays_tpudists_order_minus_the_windows(world, windows,
                                                          cursor):
    for rank in range(world):
        ours, theirs = (S(48, world, rank, seed=3)
                        for S in (ShardedSampler, JaxSampler))
        for s in (ours, theirs):
            s.set_epoch(4)
            s.set_skip_windows(windows)
            s.set_cursor(cursor)
        np.testing.assert_array_equal(ours.indices(), theirs.indices())
        assert len(ours) == len(theirs)
        for s in (ours, theirs):
            s.set_epoch(4)              # clears the windows
        np.testing.assert_array_equal(ours.indices(), theirs.indices())
        assert len(ours.indices()) == 24 if world == 2 else 48


def test_loader_replays_tpudists_batches_minus_a_window():
    loaders = []
    for L, S, D in ((DataLoader, ShardedSampler, SyntheticDataset),
                    (JaxLoader, JaxSampler, JaxSynthetic)):
        ds = D(48, 8, 4, seed=0)
        loaders.append(L(ds, batch_size=8, sampler=S(48, 1, 0, seed=0),
                         num_workers=2, drop_last=True, seed=0))
    got = []
    for loader in loaders:
        loader.set_epoch(2)
        loader.set_skip_windows([(16, 24)])
        got.append([(np.asarray(i).copy(), np.asarray(lab).copy())
                    for i, lab in loader])
    assert len(got[0]) == len(got[1]) == 5
    for (a, la), (b, lb) in zip(*got):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)


# -- lossbomb and bitflip hit the counterpart leaf ----------------------------

class _State:
    def __init__(self, params):
        self.params = params

    def replace(self, params):
        return _State(params)


@functools.lru_cache(maxsize=None)
def _init_params(arch):
    jm = (JaxViT(**VIT) if arch.startswith("vit")
          else jax_resnet.resnet18(**R18))
    variables = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)),
                        train=False)
    return jax.device_get(variables["params"]), jax.device_get(
        variables.get("batch_stats", {}))


def _port_from(arch, params, stats):
    pm = (VisionTransformer(*VIT.values(), image_size=32)
          if arch.startswith("vit") else create_model("resnet18", **R18))
    pm.load_state_dict(state_dict_from_jax(arch, params, stats), strict=True)
    return pm


@pytest.mark.parametrize("arch", ["resnet18", "vit_b_16"])
@pytest.mark.parametrize("point,spec,want", [
    ("lossbomb", "lossbomb:factor=100@step=5", {"resnet18": "fc.weight",
                                                "vit_b_16": "head.weight"}),
    ("bitflip", "bitflip@step=5", {"resnet18": "bn1.bias",
                                   "vit_b_16": "class_token"}),
    ("bitflip", "bitflip:bit=30@step=5", {"resnet18": "bn1.bias",
                                          "vit_b_16": "class_token"})])
def test_fault_points_hit_the_counterpart_leaf(arch, point, spec, want):
    params, stats = _init_params(arch)
    jax_faults.configure(spec)
    hit = getattr(jax_faults, f"maybe_{point}")(5, _State(params)).params
    pm = _port_from(arch, params, stats)
    faults.configure(spec)
    assert getattr(faults, f"maybe_{point}")(4, pm) is None
    assert getattr(faults, f"maybe_{point}")(5, pm) == want[arch]
    expect = _port_from(arch, jax.device_get(hit), stats).state_dict()
    got = pm.state_dict()
    changed = [k for k in got if not torch.equal(
        got[k], _port_from(arch, params, stats).state_dict()[k])]
    assert changed == [want[arch]]
    for k in got:
        assert torch.equal(got[k].view(torch.int32),
                           expect[k].view(torch.int32)), k


# -- verdicts and the verified walk --------------------------------------------

def _save(out, epoch, keep=3):
    m = _resnet(epoch)
    opt = port_train.make_optimizer(m, port_config.Config())
    return ckpt.save_checkpoint(ckpt.state_to_dict(
        m, opt, arch="resnet18", epoch=epoch, best_acc1=0.0, step=epoch),
        False, out, keep=keep)


def test_verdicts_stamp_and_the_walk_lands_on_verified_good(tmp_path):
    out = str(tmp_path)
    _save(out, 0)
    _save(out, 1)
    live = f"{out}/{ckpt.CKPT_NAME}"
    # The stamps are tpudist's: its reader reads them.
    assert ckpt.stamp_outpath_verdicts(out, ckpt.VERDICT_GOOD, 10) == [
        live, f"{out}/checkpoint-ep00002.msgpack",
        f"{out}/checkpoint-ep00001.msgpack"]
    assert jax_ckpt.read_verdict(live)["verdict"] == "good"
    assert jax_ckpt.read_verdict(live)["step"] == 10
    assert ckpt.stamp_outpath_verdicts(out, ckpt.VERDICT_SUSPECT, 20) == []
    # Epoch 2's save rewrites the live file: its verdict is stale, and a
    # suspect probe stamps the new bytes.
    _save(out, 2)
    assert ckpt.read_verdict(live) is None
    assert ckpt.stamp_outpath_verdicts(out, ckpt.VERDICT_SUSPECT, 30) == [
        live, f"{out}/checkpoint-ep00003.msgpack"]
    said = []
    tree, path = ckpt.load_checkpoint_with_fallback(out, log=said.append,
                                                    require_verified=True)
    assert path == f"{out}/checkpoint-ep00002.msgpack"
    assert int(tree["epoch"]) == 2
    assert any("probe-verified good" in m for m in said)
    # tpudist's walk lands on the same file.
    assert jax_ckpt.load_checkpoint_with_fallback(
        out, require_verified=True)[1] == path
    # With no verified candidate, the newest intact one (said so).
    for p in (f"{out}/checkpoint-ep00002.msgpack",
              f"{out}/checkpoint-ep00001.msgpack"):
        ckpt.stamp_verdict(p, ckpt.VERDICT_SUSPECT, 40)
    said.clear()
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint_with_fallback(out, log=said.append,
                                           require_verified=True)
    assert any("no probe-verified-good" in m for m in said)


# -- through the launcher (slow) -------------------------------------------------

def _gang(tmp_path, n, extra):
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "gang"
    return subprocess.run(
        [sys.executable, "-m", "tpudist_torch.launch", "-n", str(n), "--",
         sys.executable, "-m", "tpudist_torch", "--distributed", "--device",
         "cpu", "--synthetic", "-a", "resnet18", "--num-classes", "4",
         "--image-size", "32", "-b", str(4 * n), "--synthetic-size",
         str(16 * n), "--epochs", "1", "-p", "1", "--seed", "0", "--lr",
         "0.01", "--telemetry", "--outpath", str(out), *extra],
        cwd=repo, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1"))


@pytest.mark.slow
def test_a_bitflipped_rank_evicts_itself_with_76(tmp_path):
    r = _gang(tmp_path, 3, ["--doctor", "--doctor-probe-freq", "1",
                            "--inject", "bitflip@step=1@rank=1"])
    assert r.returncode == faults.SDC_EXIT_CODE == 76, r.stderr[-3000:]
    assert "self-quarantining (exit 76" in r.stdout + r.stderr
    assert "exit 76: sdc (doctor probe" in r.stderr


@pytest.mark.slow
def test_the_replica_check_names_the_flipped_leaf(tmp_path):
    r = _gang(tmp_path, 2, ["--replica-check-freq", "1", "--inject",
                            "bitflip@step=1@rank=1"])
    assert r.returncode != 0
    assert ("AssertionError: replica divergence on 1 state leaves: "
            "params/bn1.bias (Δ=") in r.stderr, r.stderr[-3000:]
