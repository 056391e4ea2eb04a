"""float16 training (``--use_amp --amp-dtype float16``) against tpudist.

- The port's ``DynamicScale`` against flax's (``flax 0.12.3``) over a
  scripted run of finite and non-finite gradients, from the default scale,
  from near f32's largest and near its smallest normal: the scale and
  ``fin_steps`` are equal after every step. At the default
  ``growth_interval`` both grow on the 2,001st finite step in a row, not
  on the 2,000th (``torch.amp.GradScaler``'s). ``unscale_and_check``
  gives flax's ``g / scale`` and finite flag bit for bit, its fused pass
  included.
- A tiny resnet18 (``width=16``, 32 px, 10 classes, batch 16) starts from
  the same weights (flax init through the bridge) in both packages and
  takes five float16 SGD steps on the same numpy batches from a scale of
  131,072, which this model overflows three times before it lands at
  16,384: tpudist's
  jitted step on a one-device mesh with its plain BN epilogue, the port's
  eager step with its fused ``Function``s (the kernels' plain bodies on
  the CPU), with ``--accum-steps`` 1 and 2. The scale and ``fin_steps``
  are equal after every step, and so is whether the step landed (seed 2
  of the batches gives that trajectory in both packages, with the port on
  1, 2 and 4 threads and either epilogue and tpudist with either: an
  overflow within float16's rounding noise of the limit would not, and
  about a third of the seeds tried have one). After
  the first step (skipped in both) the parameters and the momentum are
  bit-equal to the start in both, the running statistics within 1e-3 of
  tpudist's and the loss within 5e-3 (read 1.2e-3); over five steps the
  losses agree within 2e-2 (read 5.6e-3) and, after two landed steps,
  every parameter and running statistic lies within 1.5 of its largest
  change (read 0.58): float16's 11-bit activations round apart in the two
  frameworks, and a tiny net's gradients carry that. That chained bound
  cannot tell a step that moved no weight (it reads 1), so each landed
  step is also taken alone from tpudist's state before it (restored
  through tpudist's checkpoint): every parameter and momentum buffer
  within 0.6 of its change in the step in the 2-norm (read at most
  0.224), all of them together within 0.35 (read 0.12), the running
  statistics within 1e-2 (read 3.3e-3).
- A microbatch of infs skips the whole step in both packages: parameters
  and momentum bit-equal to before, the scale halved, the running
  statistics and the EMA moved as tpudist moves them (non-finite in the
  same places).
- A tpudist float16 checkpoint (a skipped step behind it, so optax's
  count lags the step) restored into the port and written again is the
  same file byte for byte; the scale and ``fin_steps`` come back exactly.
  Resuming across dtypes does what tpudist does: a float16 run refuses a
  checkpoint without a ``dynamic_scale`` (flax's restore raises) and a
  run without loss scaling refuses a float16 checkpoint when it trains
  (tpudist's step raises on it), and drops the scale when it evaluates.
"""

import functools

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from flax.training.dynamic_scale import DynamicScale as FlaxScale  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec  # noqa: E402

from tpudist import checkpoint as jax_ckpt  # noqa: E402
from tpudist import config as jax_config  # noqa: E402
from tpudist import train as jax_train  # noqa: E402
from tpudist.models import resnet as jax_resnet  # noqa: E402
from tpudist.ops import norm_dispatch  # noqa: E402
from tpudist_torch import checkpoint as ckpt  # noqa: E402
from tpudist_torch import config as port_config  # noqa: E402
from tpudist_torch import train as port_train  # noqa: E402
from tpudist_torch.compat.jax_params import (  # noqa: E402
    resnet_state_dict_from_jax)
from tpudist_torch.dynamic_scale import (  # noqa: E402
    F32_MAX, DynamicScale, unscale_and_check)
from tpudist_torch.models import create_model  # noqa: E402

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tiny shapes gain nothing from more threads, and the suite runs
    several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _plain_jax_epilogue():
    norm_dispatch.set_mode("off")
    yield
    norm_dispatch.set_mode(None)


TINY = dict(num_classes=10, width=16)
BATCH = 16
LR = 0.005
STEPS = 5
START = 131072.0                 # the scale the five steps start from
SEED = 2                         # of the five steps' batches
FIELDS = dict(arch="resnet18", num_classes=10, image_size=32,
              batch_size=BATCH, lr=LR, seed=0, use_amp=True,
              amp_dtype="float16")
# The first step's loss, the five steps' losses and every leaf against its
# largest change after them: read on the CPU at 1.2e-3, 5.6e-3 and 0.58.
FIRST_LOSS_TOL, LOSS_TOL, STATE_TOL = 5e-3, 2e-2, 1.5
# Each landed step taken from tpudist's state before it: (each leaf, all
# leaves together) against their change in that step.
# Read on the CPU (2 threads) over steps 4 and 5 at --accum-steps 1 and 2,
# in the 2-norm: parameters 0.224 / 0.112, momentum 0.196 / 0.12, running
# statistics 3.3e-3 / 1.1e-3. A step that leaves the weights and momentum
# where they were, or moves them twice as far, reads 1.
STEP_TOL = {"params": (0.6, 0.35), "momentum": (0.6, 0.35),
            "stats": (1e-2, 3e-3)}


# -- the scale's rule ------------------------------------------------------------

FLAGS = [True] * 5 + [False] + [True] * 4 + [False, False] + [True] * 9


def _flax_steps(scale, flags, growth_interval):
    """flax's DynamicScale through its own ``value_and_grad`` on a
    function whose gradient is finite or not as ``flags`` say: the
    (scale, fin_steps, finite) after each step."""
    p = jnp.ones(2, jnp.float32)

    @jax.jit
    def step(ds, c):
        ds, finite, _, _ = ds.value_and_grad(lambda w: jnp.sum(w * c))(p)
        return ds, finite

    ds = FlaxScale(growth_interval=growth_interval,
                   fin_steps=jnp.asarray(0), scale=jnp.float32(scale))
    out = []
    for ok in flags:
        ds, finite = step(ds, jnp.asarray([1.0, 1.0 if ok else np.inf],
                                          jnp.float32))
        out.append((float(ds.scale), int(ds.fin_steps), bool(finite)))
    return out


@pytest.mark.parametrize("start", [65536.0, 3.0e38, 2.0 ** -125])
def test_dynamic_scale_follows_flax_rule(start):
    ours = DynamicScale(growth_interval=3, scale=start)
    got = []
    for ok in FLAGS:
        ours.update(ok)
        got.append((ours.scale, ours.fin_steps, ok))
    assert got == _flax_steps(start, FLAGS, 3)
    if start == 65536.0:
        # Three finite steps counted, the fourth grows.
        assert [s for s, _, _ in got[:5]] == [65536.0] * 3 + [131072.0] * 2


def test_scale_grows_on_the_2001st_finite_step():
    flags = [True] * 2001
    theirs = _flax_steps(65536.0, flags, 2000)
    ours = DynamicScale()
    for i in range(2001):
        ours.update(True)
        assert (ours.scale, ours.fin_steps) == theirs[i][:2], i
    assert theirs[1999][0] == 65536.0 and theirs[1999][1] == 2000
    assert theirs[2000] == (131072.0, 0, True)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("scale", [65536.0, 2.0 ** -3, F32_MAX / 2])
def test_unscale_and_check_is_flaxs_divide_then_check(scale, accum):
    """``unscale_and_check`` against flax's ``g / scale`` (then tpudist's
    ``/ accum``) and its finite check of the quotient: bit-equal
    gradients and the same flag, for finite gradients, for finite ones
    whose quotient overflows (a scale below 1) and for a NaN; at a power
    of two of at least 1 (one fused pass), below 1 and at a scale growth
    capped at f32's max (no power of two)."""
    rng = np.random.default_rng(0)
    base = [rng.standard_normal(n).astype(np.float32) * 1e3 for n in (7, 33)]
    for poison in (None, 3.0e38, np.nan):
        grads = [g.copy() for g in base]
        if poison is not None:
            grads[1][5] = poison
        with np.errstate(over="ignore"):
            want = [g / np.float32(scale) for g in grads]
        finite = all(np.isfinite(w).all() for w in want)
        want = [w / np.float32(accum) for w in want]
        got = [torch.from_numpy(g) for g in grads]
        assert unscale_and_check(got, scale, accum) is finite, poison
        for a, w in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), w)


# -- steps against tpudist ---------------------------------------------------------

def _batches(k, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, BATCH).astype(np.int32)) for _ in range(k)]


@functools.lru_cache(maxsize=None)
def _jax_init():
    """tpudist's initial variables of the tiny resnet18 (one jitted
    init), on the host. The parameters are f32 whatever the compute
    dtype, so one init serves every run."""
    jm = jax_resnet.resnet18(dtype=jnp.float32, **TINY)
    v = jax.jit(lambda r, x: jm.init(r, x, train=False))(
        jax.random.PRNGKey(0), jnp.ones((1, 32, 32, 3), jnp.float32))
    return jax.device_get(v)


def _jax_state(cfg, scale=START, ema=False):
    """``create_train_state``'s TrainState (tpudist/train.py) around
    ``_jax_init``'s variables, float16's DynamicScale at ``scale``, on
    the one-device mesh (replicated, as the step returns it)."""
    v = _jax_init()
    tx = jax_train.make_optimizer(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, v["batch_stats"])
    ds = FlaxScale(fin_steps=jnp.asarray(0), scale=jnp.float32(scale))
    state = jax_train.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=tx.init(params), dynamic_scale=ds,
        ema_params=({"params": params, "batch_stats": stats} if ema
                    else None))
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    return mesh, jax.device_put(state, NamedSharding(mesh, PartitionSpec()))


def _port(accum, ema_decay=0.0):
    pcfg = port_config.Config(**FIELDS, fused_bn="on", accum_steps=accum,
                              model_ema_decay=ema_decay)
    v = _jax_init()
    pm = create_model("resnet18", dtype=torch.float16, fused_bn=True, **TINY)
    pm.load_state_dict(resnet_state_dict_from_jax(v["params"],
                                                  v["batch_stats"]))
    opt = port_train.make_optimizer(pm, pcfg)
    ema = None
    if ema_decay:
        ema = port_train.make_ema(pm, lambda: create_model(
            "resnet18", dtype=torch.float16, fused_bn=True, **TINY))
    scaler = port_train.make_scaler(pcfg)
    step = port_train.make_train_step(pm, opt, pcfg, ema=ema, scaler=scaler)
    return pm, opt, ema, scaler, step


def _bridge(tree):
    return resnet_state_dict_from_jax(tree["params"], tree["batch_stats"])


def _momentum(pm, opt):
    return {n: opt.state.get(p, {}).get("momentum_buffer")
            for n, p in pm.named_parameters()}


@functools.lru_cache(maxsize=None)
def _trajectories(accum):
    """Five float16 steps from START in both packages: per step the
    (scale, fin_steps, landed, loss) of each, and after each step tpudist's
    variables and momentum, the port's state dict and momentum, and
    tpudist's whole TrainState on the host."""
    jcfg = jax_config.Config(**FIELDS, fused_bn="off", accum_steps=accum)
    mesh, state = _jax_state(jcfg)
    jstep = jax_train.make_train_step(
        mesh, jax_resnet.resnet18(dtype=jnp.float16, **TINY), jcfg)
    pm, opt, _, scaler, pstep = _port(accum)
    scaler.scale = START
    rows, states = [], []
    for x, y in _batches(STEPS, seed=SEED):
        scale = float(state.dynamic_scale.scale)
        state, jmet = jstep(state, jnp.asarray(x), jnp.asarray(y),
                            jnp.asarray(LR, jnp.float32))
        pmet = pstep(torch.from_numpy(x), torch.from_numpy(y), LR)
        ds = state.dynamic_scale
        # flax's rule: a landed step counts up or grows the scale.
        landed = int(ds.fin_steps) > 0 or float(ds.scale) > scale
        rows.append({"jax": (float(ds.scale), int(ds.fin_steps), landed,
                             float(jmet["loss"])),
                     "port": (scaler.scale, scaler.fin_steps,
                              pmet["finite"], float(pmet["loss"]))})
        states.append((jax.device_get({"params": state.params,
                                       "batch_stats": state.batch_stats,
                                       "trace": state.opt_state.inner_state[
                                           1].trace}),
                       {k: v.detach().float().clone()
                        for k, v in pm.state_dict().items()},
                       {k: None if v is None else v.clone()
                        for k, v in _momentum(pm, opt).items()},
                       jax.device_get(state)))
    return rows, states


@pytest.mark.parametrize("accum", [1, 2])
def test_first_step_overflows_in_both_and_changes_no_weight(accum):
    rows, states = _trajectories(accum)
    first = rows[0]
    assert first["jax"][:3] == first["port"][:3] == (65536.0, 0, False)
    assert abs(first["jax"][3] - first["port"][3]) <= FIRST_LOSS_TOL
    init = _bridge(_jax_init())
    jax_after, port_after, momentum, _ = states[0]
    for k, v in init.items():
        if k.endswith((".mean", ".var")):           # the running statistics
            assert torch.allclose(port_after[k], _bridge(jax_after)[k],
                                  atol=1e-3), k
        else:
            assert torch.equal(port_after[k], v.float()), k
    # No optimizer step: no momentum buffer in the port, optax's zeros.
    assert all(m is None for m in momentum.values())
    assert all(not np.any(t) for t in jax.tree_util.tree_leaves(
        jax_after["trace"]))


@pytest.mark.parametrize("accum", [1, 2])
def test_five_steps_keep_tpudists_scale_trajectory(accum):
    rows, states = _trajectories(accum)
    for i, row in enumerate(rows):
        assert row["jax"][:3] == row["port"][:3], (i, rows)
        assert abs(row["jax"][3] - row["port"][3]) <= LOSS_TOL, (i, rows)
    assert [r["port"][2] for r in rows] == [False] * 3 + [True] * 2
    init = _bridge(_jax_init())
    want = _bridge(states[-1][0])
    got = states[-1][1]
    for k, w in want.items():
        update = float((w.float() - init[k].float()).abs().max())
        err = float((got[k] - w.float()).abs().max())
        assert err <= max(STATE_TOL * update, 1e-6), (k, err, update)


def _port_at(tmp_path, state, accum):
    """The port restored from tpudist's TrainState ``state`` (its
    parameters, statistics, momentum, scale and fin_steps) through
    tpudist's checkpoint file."""
    out = tmp_path / f"at{int(state.step)}"
    out.mkdir()
    jax_ckpt.save_checkpoint(jax_ckpt.state_to_dict(
        state, "resnet18", 0, 0.0,
        topology=ckpt.topology_tag(1, BATCH, BATCH)), False, str(out))
    pm, opt, _, scaler, step = _port(accum)
    ckpt.restore(ckpt.load_checkpoint(str(out)), pm, opt, arch="resnet18",
                 scaler=scaler)
    return pm, opt, scaler, step


def _leaf_shares(got, want, before):
    """Each leaf's difference from tpudist's after one step, as a share of
    that leaf's change in tpudist's step, both in the 2-norm over the
    leaf's entries (a leaf the step left unchanged: its difference over
    1e-6), and the same share over all the leaves together (``"all"``)."""
    diff = {k: float((got[k].float() - w.float()).norm())
            for k, w in want.items()}
    moved = {k: float((w.float() - before[k].float()).norm())
             for k, w in want.items()}
    shares = {k: diff[k] / max(moved[k], 1e-6) for k in want}
    shares["all"] = (sum(d * d for d in diff.values()) ** 0.5
                     / sum(m * m for m in moved.values()) ** 0.5)
    return shares


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("k", [3, 4])       # steps 4 and 5, the landed ones
def test_each_landed_step_matches_tpudists_from_its_state(tmp_path, accum, k):
    """One landed float16 step at a time from a shared state: the port
    restored from tpudist's state before step ``k + 1`` takes that step
    on its batch; its scale and fin_steps equal tpudist's after it, and
    every parameter, running statistic and momentum buffer lies within
    STEP_TOL of its change in tpudist's step (2-norms). A step that leaves
    the weights as they were, or moves them twice as far (the gradients
    not divided by the microbatch count), reads 1."""
    rows, states = _trajectories(accum)
    pm, opt, scaler, pstep = _port_at(tmp_path, states[k - 1][3], accum)
    assert (scaler.scale, scaler.fin_steps) == rows[k - 1]["jax"][:2]
    x, y = _batches(STEPS, seed=SEED)[k]
    assert pstep(torch.from_numpy(x), torch.from_numpy(y), LR)["finite"]
    assert (scaler.scale, scaler.fin_steps) == rows[k]["jax"][:2]
    assert rows[k]["jax"][2]
    before, after = states[k - 1][0], states[k][0]
    sd = pm.state_dict()
    stats = [n for n in sd if n.endswith((".mean", ".var"))]
    params = [n for n in sd if n not in stats]
    want, was = _bridge(after), _bridge(before)
    momentum = _momentum(pm, opt)
    trace = [_bridge(dict(t, params=t["trace"])) for t in (after, before)]
    shares = {
        "params": _leaf_shares(sd, {n: want[n] for n in params}, was),
        "stats": _leaf_shares(sd, {n: want[n] for n in stats}, was),
        "momentum": _leaf_shares(momentum, {n: trace[0][n] for n in momentum},
                                 trace[1])}
    for part, (leaf_tol, all_tol) in STEP_TOL.items():
        worst = {n: v for n, v in shares[part].items()
                 if v > (all_tol if n == "all" else leaf_tol)}
        assert not worst, (part, worst)


def test_a_poisoned_microbatch_skips_the_step_in_both():
    """From a scale the first batch lands at (1,024), then a batch whose
    first microbatch is all inf: in both packages the parameters and the
    momentum keep their bits, the scale halves and fin_steps restarts;
    the running statistics and the EMA move (tpudist has no rollback
    without the doctor) and are non-finite where tpudist's are."""
    jcfg = jax_config.Config(**FIELDS, fused_bn="off", accum_steps=2,
                             model_ema_decay=0.9)
    mesh, state = _jax_state(jcfg, scale=1024.0, ema=True)
    jstep = jax_train.make_train_step(
        mesh, jax_resnet.resnet18(dtype=jnp.float16, **TINY), jcfg)
    pm, opt, ema, scaler, pstep = _port(2, ema_decay=0.9)
    scaler.scale = 1024.0
    (x, y), (bad, y2) = _batches(2, seed=3)
    bad[: BATCH // 2] = np.inf
    state, _ = jstep(state, jnp.asarray(x), jnp.asarray(y),
                     jnp.asarray(LR, jnp.float32))
    assert pstep(torch.from_numpy(x), torch.from_numpy(y), LR)["finite"]
    assert int(state.dynamic_scale.fin_steps) == scaler.fin_steps == 1
    j_before = jax.device_get((state.params, state.opt_state))
    p_before = {k: v.clone() for k, v in pm.state_dict().items()}
    m_before = {k: v.clone() for k, v in _momentum(pm, opt).items()}

    state, jmet = jstep(state, jnp.asarray(bad), jnp.asarray(y2),
                        jnp.asarray(LR, jnp.float32))
    pmet = pstep(torch.from_numpy(bad), torch.from_numpy(y2), LR)
    assert pmet["finite"] is False
    assert (float(state.dynamic_scale.scale), int(
        state.dynamic_scale.fin_steps)) == (scaler.scale, scaler.fin_steps) \
        == (512.0, 0)
    j_after = jax.device_get((state.params, state.opt_state))
    for a, b in zip(jax.tree_util.tree_leaves(j_before),
                    jax.tree_util.tree_leaves(j_after)):
        np.testing.assert_array_equal(a, b)
    after = pm.state_dict()
    for k, v in p_before.items():
        if not k.endswith((".mean", ".var")):       # the running statistics
            assert torch.equal(after[k], v), k
    for k, v in _momentum(pm, opt).items():
        assert torch.equal(v, m_before[k]), k
    # The statistics and the EMA moved, as tpudist's did.
    want = _bridge(jax.device_get({"params": state.params,
                                   "batch_stats": state.batch_stats}))
    want_ema = _bridge(jax.device_get(state.ema_params))
    for got, ref in ((pm.state_dict(), want), (ema.state_dict(), want_ema)):
        for k, w in ref.items():
            g, w = got[k].float(), w.float()
            assert torch.equal(torch.isfinite(g), torch.isfinite(w)), k
            fin = torch.isfinite(w)
            assert torch.allclose(g[fin], w[fin], atol=1e-2, rtol=1e-2), k
    assert not torch.isfinite(pm.bn1.mean).all()


# -- checkpoints -------------------------------------------------------------------

def _tpudist_file(tmp_path):
    """tpudist's float16 checkpoint after the first four steps of
    ``_trajectories(1)`` (three skipped: count 1, step 4), written by
    tpudist: its bytes and its directory."""
    state = _trajectories(1)[1][3][3]
    tree = jax_ckpt.state_to_dict(
        state, "resnet18", 0, 12.5,
        topology=ckpt.topology_tag(1, BATCH, BATCH))
    out = tmp_path / "jax"
    out.mkdir()
    jax_ckpt.save_checkpoint(tree, False, str(out))
    return (out / ckpt.CKPT_NAME).read_bytes(), str(out)


def test_float16_checkpoint_is_flaxs_file_and_restores_the_scale(tmp_path):
    data, src = _tpudist_file(tmp_path)
    tree = ckpt.load_checkpoint(src)
    assert int(np.asarray(tree["state"]["step"])) == 4
    assert ckpt.optimizer_count(tree) == 1
    pm, opt, _, scaler, _ = _port(1)
    step = ckpt.restore(tree, pm, opt, arch="resnet18", scaler=scaler)
    assert step == 4
    assert (scaler.scale, scaler.fin_steps) == (16384.0, 1)
    mine = ckpt.state_to_dict(
        pm, opt, arch="resnet18", epoch=0, best_acc1=12.5, step=step,
        topology=ckpt.topology_tag(1, BATCH, BATCH), scaler=scaler,
        opt_steps=ckpt.optimizer_count(tree))
    out = tmp_path / "port"
    out.mkdir()
    ckpt.save_checkpoint(mine, False, str(out))
    assert (out / ckpt.CKPT_NAME).read_bytes() == data


def test_resuming_across_dtypes_does_what_tpudist_does(tmp_path):
    _, src = _tpudist_file(tmp_path)
    fp16_tree = ckpt.load_checkpoint(src)
    bf16_tree = ckpt.load_checkpoint(src)
    bf16_tree["state"]["dynamic_scale"] = None
    # tpudist: a float16 template cannot take a file without a scale, and
    # a bf16 template takes a float16 file's scale as a dict its step
    # then fails on.
    jcfg = jax_config.Config(**FIELDS, fused_bn="off")
    _, fp16_state = _jax_state(jcfg)
    with pytest.raises(AttributeError):
        jax_ckpt.restore_train_state(fp16_state, bf16_tree)
    bcfg = jax_config.Config(**dict(FIELDS, amp_dtype="bfloat16"),
                             fused_bn="off")
    mesh, bf16_state = _jax_state(bcfg)
    restored = jax_ckpt.restore_train_state(
        bf16_state.replace(dynamic_scale=None), fp16_tree)
    assert isinstance(restored.dynamic_scale, dict)
    jstep = jax_train.make_train_step(
        mesh, jax_resnet.resnet18(dtype=jnp.bfloat16, **TINY), bcfg)
    x, y = _batches(1)[0]
    with pytest.raises(AttributeError):
        jstep(restored, jnp.asarray(x), jnp.asarray(y),
              jnp.asarray(LR, jnp.float32))
    # The port refuses both by name, and an eval-only run drops the scale.
    pm, opt, _, scaler, _ = _port(1)
    with pytest.raises(ValueError, match="has no dynamic_scale"):
        ckpt.restore(bf16_tree, pm, opt, arch="resnet18", scaler=scaler)
    with pytest.raises(ValueError, match="carries a dynamic_scale"):
        ckpt.restore(fp16_tree, pm, opt, arch="resnet18")
    logged = []
    ckpt.restore(fp16_tree, pm, opt, arch="resnet18", train=False,
                 log=logged.append)
    assert any("an eval-only run drops it" in m for m in logged)
