"""The port's train step against tpudist's ``make_train_step``.

A tiny resnet18 (``width=16``, 32 px, 10 classes, batch 16) starts from the
same weights (flax init through the bridge) on both sides and takes the
same SGD steps on the same numpy batches: tpudist's jitted step on a
one-device mesh with its plain BN epilogue, the port's eager step with its
fused ``Function``s (the kernels' plain bodies on the CPU) and with
``--fused-bn off``. At f32 the per-step loss agrees within 1e-5 after one
step and 1e-4 over five, and every parameter and running statistic lies
within 1e-3 of its largest update (or 1e-6 absolute). A bf16 step is
finite and within 2e-2 of tpudist's loss. ``lr_for_epoch`` equals
tpudist's on every epoch of the default schedule and of others.

The port's first SGD update, read back as a gradient, is also held against
``jax.jit(jax.value_and_grad(tpudist.train._loss_fn))`` at batches 16, 24
and 32. At 24 and 32 the two f32 gradients differ by about a tenth of a
leaf's largest entry: a pre-activation lies within f32 rounding of a ReLU
kink, and the two forwards land on either side of it. There the float64
central difference of the loss sides with tpudist at 24 and with the port
at 32, and the port's float64 backward equals that difference.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from jax.sharding import Mesh  # noqa: E402

from tpudist import config as jax_config  # noqa: E402
from tpudist import train as jax_train  # noqa: E402
from tpudist.models import resnet as jax_resnet  # noqa: E402
from tpudist.ops import norm_dispatch  # noqa: E402
from tpudist_torch import config as port_config  # noqa: E402
from tpudist_torch import train as port_train  # noqa: E402
from tpudist_torch.compat.jax_params import (  # noqa: E402
    resnet_state_dict_from_jax)
from tpudist_torch.models import create_model  # noqa: E402
from tpudist_torch.ops.mixup import mixed_ce  # noqa: E402

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tiny shapes gain nothing from more threads, and the suite runs
    several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

TINY = dict(num_classes=10, width=16)
BATCH = 16
FIELDS = dict(arch="resnet18", num_classes=10, image_size=32,
              batch_size=BATCH, lr=0.005, seed=0)


@pytest.fixture(autouse=True)
def _plain_jax_epilogue():
    norm_dispatch.set_mode("off")
    yield
    norm_dispatch.set_mode(None)


def _batches(k, seed=0, batch=BATCH):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, batch).astype(np.int32)) for _ in range(k)]


@functools.lru_cache(maxsize=None)
def _jax_side(use_amp):
    """tpudist's initial state (on the host) and jitted step, built once
    per precision: the step compiles on its first call."""
    dtype_j = jnp.bfloat16 if use_amp else jnp.float32
    jcfg = jax_config.Config(**FIELDS, use_amp=use_amp, fused_bn="off")
    jm = jax_resnet.resnet18(dtype=dtype_j, **TINY)
    state = jax_train.create_train_state(jax.random.PRNGKey(0), jm, jcfg,
                                         input_shape=(1, 32, 32, 3))
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    return jax.device_get(state), jax_train.make_train_step(mesh, jm, jcfg)


def _run_both(n_steps, use_amp=False, fused=True):
    host_state, jstep = _jax_side(use_amp)
    state = jax.tree_util.tree_map(jnp.asarray, host_state)   # donated below
    init = {"params": host_state.params,
            "batch_stats": host_state.batch_stats}

    pcfg = port_config.Config(**FIELDS, use_amp=use_amp,
                              fused_bn="on" if fused else "off")
    pm = create_model("resnet18", dtype=port_train.compute_dtype(pcfg),
                      fused_bn=fused, **TINY)
    pm.load_state_dict(resnet_state_dict_from_jax(
        init["params"], init["batch_stats"]), strict=True)
    pstep = port_train.make_train_step(
        pm, port_train.make_optimizer(pm, pcfg), pcfg)

    losses = []
    lr = port_train.lr_for_epoch(pcfg, 0)
    for x, y in _batches(n_steps):
        state, jmet = jstep(state, jnp.asarray(x), jnp.asarray(y),
                            jnp.asarray(lr, jnp.float32))
        pmet = pstep(torch.from_numpy(x), torch.from_numpy(y), lr)
        losses.append((float(pmet["loss"]), float(jmet["loss"]),
                       float(pmet["acc1"]), float(jmet["acc1"])))
    final = jax.device_get({"params": state.params,
                            "batch_stats": state.batch_stats})
    bridge = lambda v: resnet_state_dict_from_jax(  # noqa: E731
        v["params"], v["batch_stats"])
    return losses, pm, bridge(init), bridge(final)


@pytest.mark.parametrize("n_steps,tol,fused", [(1, 1e-5, True),
                                               (5, 1e-4, True),
                                               (5, 1e-4, False)])
def test_sgd_steps_match_tpudist(n_steps, tol, fused):
    losses, pm, init, want = _run_both(n_steps, fused=fused)
    for i, (got, ref, acc, acc_ref) in enumerate(losses):
        assert abs(got - ref) <= tol, (i, got, ref)
        assert acc == acc_ref, i
    got = pm.state_dict()
    assert set(got) == set(want)
    for k in want:
        update = float((want[k] - init[k]).abs().max())
        err = float((got[k] - want[k]).abs().max())
        assert err <= max(1e-3 * update, 1e-6), (k, err, update)


def _port_model(host_state, dtype):
    pm = create_model("resnet18", dtype=dtype, fused_bn=True, **TINY)
    pm.load_state_dict(resnet_state_dict_from_jax(
        host_state.params, host_state.batch_stats), strict=True)
    return pm.to(dtype)


@pytest.mark.parametrize("batch", [16, 24, 32])
def test_first_sgd_update_against_jax_grad_and_float64(batch, monkeypatch):
    host_state, _ = _jax_side(False)
    (x, y), = _batches(1, batch=batch)
    jm = jax_resnet.resnet18(dtype=jnp.float32, **TINY)
    (jloss, _), jgrad = jax.jit(jax.value_and_grad(
        lambda p: jax_train._loss_fn(jm, jax.random.PRNGKey(0), p,
                                     host_state.batch_stats, jnp.asarray(x),
                                     jnp.asarray(y)), has_aux=True))(
        host_state.params)
    want = resnet_state_dict_from_jax(jax.device_get(jgrad),
                                      host_state.batch_stats)

    pcfg = port_config.Config(**dict(FIELDS, batch_size=batch))
    lr = FIELDS["lr"]
    pm = _port_model(host_state, torch.float32)
    p0 = {k: v.detach().clone() for k, v in pm.named_parameters()}
    pstep = port_train.make_train_step(
        pm, port_train.make_optimizer(pm, pcfg), pcfg)
    loss = pstep(torch.from_numpy(x), torch.from_numpy(y), lr)["loss"]
    assert abs(float(loss) - float(jloss)) <= 1e-5
    got = {k: (p0[k] - v.detach()) / lr - pcfg.weight_decay * p0[k]
           for k, v in pm.named_parameters()}
    gap, k = max((float((got[k] - want[k]).abs().max()
                        / want[k].abs().max()), k) for k in got)
    e = np.unravel_index(int((got[k] - want[k]).abs().argmax()),
                         tuple(got[k].shape))
    scale = float(want[k].abs().max())

    # The same loss in float64 at the widest gap: the port's backward and a
    # central difference (h = 1e-8, well inside the kink's distance).
    monkeypatch.setattr(torch.Tensor, "float", lambda t: t.double())
    pm64 = _port_model(host_state, torch.float64)
    x64, y64 = torch.from_numpy(x).double(), torch.from_numpy(y).long()
    f64_loss = lambda: mixed_ce(pm64.train()(x64), y64, None,  # noqa: E731
                                None, 0.0)
    f64_loss().backward()
    w = dict(pm64.named_parameters())[k]
    ends = []
    with torch.no_grad():
        for h in (1e-8, -1e-8):
            w[e] += h
            ends.append(float(f64_loss()))
            w[e] -= h
    fd = (ends[0] - ends[1]) / 2e-8
    assert abs(float(w.grad[e]) - fd) <= 1e-5 * scale, (k, e)
    sides = {"port": abs(float(got[k][e]) - fd),
             "tpudist": abs(float(want[k][e]) - fd)}
    assert min(sides.values()) <= 1e-3 * scale, (k, e, gap, sides)
    if batch == 16:
        assert gap <= 1e-3, (k, gap)


def test_bf16_step_is_finite_and_near_tpudist():
    losses, pm, _, _ = _run_both(1, use_amp=True)
    got, ref = losses[0][:2]
    assert np.isfinite(got) and abs(got - ref) <= 2e-2, (got, ref)
    assert pm.layer1_0.conv1.weight.dtype == torch.float32   # master weights


@pytest.mark.parametrize("fields", [
    {}, dict(lr_scheduler="cosine", epochs=7, warmup_epochs=2),
    dict(step=[1], gamma=0.5, warmup_epochs=3)])
def test_lr_for_epoch_matches_tpudist(fields):
    jcfg = jax_config.Config(**fields)
    pcfg = port_config.Config(**fields)
    for epoch in range(pcfg.epochs + 1):
        assert port_train.lr_for_epoch(pcfg, epoch) == pytest.approx(
            jax_train.lr_for_epoch(jcfg, epoch), rel=1e-12, abs=0), epoch
