"""Gradient accumulation and in-step mixup/cutmix in the port, against
tpudist on the CPU.

- Mixing: the port's ``apply_mix``, fed the draws a JAX key gives as
  ``tpudist/ops/mixup.py::mix_batch`` derives them (the permutation,
  mixup's lam, cutmix's lam and centre, the choice), against
  ``mix_batch``'s own output for mixup, cutmix and both: y1 and y2 equal,
  cutmix images bit-equal, mixup images and lam within 1e-6 (the port
  rounds the blend once, as XLA's fused multiply-add does).
- The port's own draws: one (seed, step, rank) always draws the same, the
  step and the rank change it, the box stays inside the image, and the
  Beta sampler has Beta(a, a)'s mean and variance.
- Accumulation: the tiny resnet18 (width 16, 32 px, the flax init through
  the weight bridge, f32) takes 1 and 5 SGD steps at ``--accum-steps`` 2
  and 4, with and without mixing (the port's draws taken from the key
  tpudist's step folds, so both mix alike), against tpudist's jitted
  ``make_train_step`` on one device with its plain epilogue: the port's
  fused ``Function``s (the kernels' plain bodies on the CPU) over five
  steps; its plain epilogue takes each of the five from the fused run's
  state and is held to the fused step and to tpudist's first. Every
  microbatch holds 8 images. The bounds are ``tests/test_torch_train.py``'s: the loss within
  1e-5 after one step and 1e-4 over five, acc1 equal, every parameter and
  running statistic within 1e-3 of its largest update (or 1e-6
  absolute). The tiny ViT takes one AdamW step at
  ``--accum-steps 2`` through the flash ``Function`` (its plain bodies),
  held as ``tests/test_torch_vit_train.py`` holds it.
- ``--accum-steps`` < 1 and a per-rank batch it does not divide are
  refused before the run directory is made.
"""

import copy
import functools

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from jax.sharding import Mesh  # noqa: E402

from tpudist import config as jax_config  # noqa: E402
from tpudist import train as jax_train  # noqa: E402
from tpudist.models import resnet as jax_resnet  # noqa: E402
from tpudist.ops import mixup as jax_mixup  # noqa: E402
from tpudist.ops import norm_dispatch as jax_norm_dispatch  # noqa: E402
from tpudist_torch import __main__ as cli  # noqa: E402
from tpudist_torch import config as port_config  # noqa: E402
from tpudist_torch import train as port_train  # noqa: E402
from tpudist_torch.compat.jax_params import (  # noqa: E402
    resnet_state_dict_from_jax, vit_state_dict_from_jax)
from tpudist_torch.models import create_model  # noqa: E402
from tpudist_torch.ops import mixup  # noqa: E402

import test_torch_vit_train as vit_case  # noqa: E402

pytestmark = pytest.mark.torch_port

TINY = dict(num_classes=10, width=16)
MICRO = 8
FIELDS = dict(arch="resnet18", num_classes=10, image_size=32, lr=0.005,
              seed=0, use_amp=False)
MIX = dict(mixup_alpha=0.2, cutmix_alpha=1.0)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _plain_jax_epilogue():
    jax_norm_dispatch.set_mode("off")
    yield
    jax_norm_dispatch.set_mode(None)


def jax_draw(key, n, h, w, mixup_alpha, cutmix_alpha) -> mixup.MixDraw:
    """The draws ``mix_batch`` takes from ``key``, as the port's
    ``MixDraw``."""
    k_perm, k_lam, k_box, k_choice = jax.random.split(key, 4)
    perm = np.asarray(jax.random.permutation(k_perm, n))
    lam = float(jax.random.beta(k_lam, mixup_alpha or 1.0,
                                mixup_alpha or 1.0))
    lam0 = float(jax.random.beta(k_box, cutmix_alpha or 1.0,
                                 cutmix_alpha or 1.0))
    ky, kx = jax.random.split(k_lam)
    cy = int(jax.random.randint(ky, (), 0, h))
    cx = int(jax.random.randint(kx, (), 0, w))
    if mixup_alpha > 0 and cutmix_alpha > 0:
        use_mixup = bool(jax.random.bernoulli(k_choice, 0.5))
    else:
        use_mixup = mixup_alpha > 0
    return mixup.MixDraw(torch.from_numpy(perm.astype(np.int64)), use_mixup,
                         lam, mixup.cutmix_box(lam0, cy, cx, h, w))


def _step_key(seed: int, step: int):
    """The key tpudist's step hands ``mix_batch`` at ``step`` on shard 0."""
    rng = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                step), 0)
    return jax.random.split(rng)[0]


# -- mixing -------------------------------------------------------------------

@pytest.mark.parametrize("alphas", [(0.2, 0.0), (0.0, 1.0), (0.2, 1.0)],
                         ids=["mixup", "cutmix", "both"])
def test_apply_mix_equals_mix_batch(alphas):
    rng = np.random.default_rng(0)
    kinds = set()
    for seed in range(12):
        images = rng.standard_normal((8, 12, 10, 3)).astype(np.float32)
        labels = rng.integers(0, 10, 8).astype(np.int32)
        key = jax.random.PRNGKey(seed)
        want = jax_mixup.mix_batch(key, jnp.asarray(images),
                                   jnp.asarray(labels), *alphas)
        draw = jax_draw(key, 8, 12, 10, *alphas)
        kinds.add(draw.mixup)
        got = mixup.apply_mix(torch.from_numpy(images),
                              torch.from_numpy(labels), draw)
        wi, w1, w2, wl = (np.asarray(v) for v in want)
        gi = got[0].numpy()
        np.testing.assert_array_equal(got[1].numpy(), w1)
        np.testing.assert_array_equal(got[2].numpy(), w2)
        assert abs(got[3] - float(wl)) <= 1e-6
        if draw.mixup:
            np.testing.assert_allclose(gi, wi, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(gi, wi)
            assert 0.0 < got[3] <= 1.0
    assert kinds == ({True, False} if all(alphas) else {alphas[0] > 0})


def test_port_draws_are_seeded_by_seed_step_and_rank():
    def draw(seed, step, rank):
        return mixup.draw_mix(mixup.step_generator(seed, step, rank), 16, 32,
                              24, *MIX.values())
    a, b = draw(0, 3, 0), draw(0, 3, 0)
    assert torch.equal(a.perm, b.perm) and (a.mixup, a.lam, a.box) == \
        (b.mixup, b.lam, b.box)
    for other in (draw(0, 4, 0), draw(0, 3, 1), draw(1, 3, 0)):
        assert not torch.equal(a.perm, other.perm)
    assert sorted(a.perm.tolist()) == list(range(16))
    seen = set()
    for step in range(40):
        d = draw(0, step, 0)
        y0, y1, x0, x1 = d.box
        assert 0 <= y0 <= y1 <= 32 and 0 <= x0 <= x1 <= 24
        seen.add(d.mixup)
    assert seen == {True, False}


@pytest.mark.parametrize("alpha", [0.2, 1.0])
def test_beta_draws_have_beta_moments(alpha):
    g = torch.Generator().manual_seed(0)
    x = np.array([mixup._beta(g, alpha) for _ in range(4000)])
    assert np.all((x >= 0) & (x <= 1))
    var = 1.0 / (4.0 * (2.0 * alpha + 1.0))
    assert abs(x.mean() - 0.5) <= 4 * np.sqrt(var / len(x))
    assert abs(x.var() - var) <= 0.1 * var


# -- accumulation against tpudist's step --------------------------------------

def _batches(k, batch, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, batch).astype(np.int32)) for _ in range(k)]


@functools.lru_cache(maxsize=None)
def _jax_side(accum, mixing):
    jcfg = jax_config.Config(**FIELDS, batch_size=MICRO * accum,
                             accum_steps=accum, fused_bn="off",
                             **(MIX if mixing else {}))
    jm = jax_resnet.resnet18(dtype=jnp.float32, **TINY)
    state = jax_train.create_train_state(jax.random.PRNGKey(0), jm, jcfg,
                                         input_shape=(1, 32, 32, 3))
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    return jax.device_get(state), jax_train.make_train_step(mesh, jm, jcfg)


def _port_step(host_state, accum, mixing, fused, draws):
    pcfg = port_config.Config(**FIELDS, batch_size=MICRO * accum,
                              accum_steps=accum,
                              fused_bn="on" if fused else "off",
                              **(MIX if mixing else {}))
    pm = create_model("resnet18", dtype=torch.float32, fused_bn=fused, **TINY)
    pm.load_state_dict(resnet_state_dict_from_jax(
        host_state.params, host_state.batch_stats), strict=True)

    def draw_fn(step, n, h, w):
        draws.append(step)
        return jax_draw(_step_key(0, step), n, h, w, *MIX.values())

    opt = port_train.make_optimizer(pm, pcfg)
    return pm, opt, port_train.make_train_step(
        pm, opt, pcfg, draw_fn=draw_fn if mixing else None)


def _held(got: dict, want: dict, init: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        update = float((want[k] - init[k]).abs().max())
        err = float((got[k] - want[k]).abs().max())
        assert err <= max(1e-3 * update, 1e-6), (k, err, update)


@pytest.mark.parametrize("mixing", [False, True], ids=["plain", "mixed"])
@pytest.mark.parametrize("accum", [2, 4])
def test_accumulated_sgd_steps_match_tpudist(accum, mixing):
    """Five steps of tpudist's against the port's fused ``Function``s (as
    in ``tests/test_torch_train.py``): the first step's loss within 1e-5
    and every leaf within 1e-3 of the step's update; every later loss
    within 1e-4 and every leaf after the fifth within 1e-3 of the five
    steps' update; acc1 equal throughout. The port's plain epilogue takes
    each of the five steps too, from the fused run's state before it, and
    is held to tpudist's first step and to the fused run's every step by
    the one-step bounds. It is not chained over five steps on its own:
    over five steps the f32 runs of these cases part at ReLU kinks by
    rounding alone (the same five steps in f64 leave them, tpudist's
    too, by more than the bound in one case or another), and only
    tpudist and the fused ``Function`` round alike."""
    host_state, jstep = _jax_side(accum, mixing)
    state = jax.tree_util.tree_map(jnp.asarray, host_state)
    bridge = lambda v: resnet_state_dict_from_jax(  # noqa: E731
        v.params, v.batch_stats)
    init = bridge(host_state)
    draws = {True: [], False: []}
    runs = {fused: _port_step(host_state, accum, mixing, fused, draws[fused])
            for fused in (True, False)}
    (fm, fopt, fstep), (pm, popt, pstep) = runs[True], runs[False]
    lr = port_train.lr_for_epoch(port_config.Config(**FIELDS), 0)
    for i, (x, y) in enumerate(_batches(5, MICRO * accum)):
        state, jmet = jstep(state, jnp.asarray(x), jnp.asarray(y),
                            jnp.asarray(lr, jnp.float32))
        before = copy.deepcopy(fm.state_dict())
        pm.load_state_dict(before)
        popt.load_state_dict(copy.deepcopy(fopt.state_dict()))
        fmet = fstep(torch.from_numpy(x), torch.from_numpy(y), lr)
        pmet = pstep(torch.from_numpy(x), torch.from_numpy(y), lr)
        for name, met in (("fused", fmet), ("plain", pmet)):
            assert abs(float(met["loss"]) - float(jmet["loss"])) <= \
                (1e-5 if i == 0 else 1e-4), (name, i, float(met["loss"]),
                                             float(jmet["loss"]))
            assert float(met["acc1"]) == pytest.approx(
                float(jmet["acc1"]), abs=1e-6), (name, i)
        assert abs(float(pmet["loss"]) - float(fmet["loss"])) <= 1e-5, i
        _held(pm.state_dict(), fm.state_dict(), before)
        if i == 0:
            for m in (fm, pm):
                _held(m.state_dict(), bridge(jax.device_get(state)), init)
    _held(fm.state_dict(), bridge(jax.device_get(state)), init)
    assert draws == ({True: list(range(5)), False: list(range(5))}
                     if mixing else {True: [], False: []})


def test_accumulated_adamw_vit_step_through_flash_matches_tpudist():
    fields = dict(vit_case._fields("adamw"), accum_steps=2)
    jm, host_state, _ = vit_case._jax_side("adamw")
    jstep = jax_train.make_train_step(
        Mesh(np.array(jax.devices()[:1]), ("data",)), jm,
        jax_config.Config(**fields))
    pcfg = port_config.Config(**fields)
    pm = vit_case._port_model(host_state.params)
    pstep = port_train.make_train_step(
        pm, port_train.make_optimizer(pm, pcfg), pcfg)
    (x, y), = vit_case._batches(1)
    lr = port_train.lr_for_epoch(pcfg, 0)
    state, jmet = jstep(jax.tree_util.tree_map(jnp.asarray, host_state),
                        jnp.asarray(x), jnp.asarray(y),
                        jnp.asarray(lr, jnp.float32))
    pmet = pstep(torch.from_numpy(x), torch.from_numpy(y), lr)
    assert abs(float(pmet["loss"]) - float(jmet["loss"])) <= 1e-5
    init = vit_state_dict_from_jax(host_state.params)
    want = vit_state_dict_from_jax(jax.device_get(state.params))
    got = pm.state_dict()
    on_kink = vit_case._adamw_kink()
    for k in want:
        held = ~on_kink.get(k, torch.zeros_like(want[k], dtype=torch.bool))
        update = float((want[k] - init[k]).abs().max())
        err = float((got[k] - want[k])[held].abs().max())
        assert err <= max(1e-3 * update, 1e-6), (k, err, update)
        assert torch.all((got[k] - init[k])[~held].abs() <= update), k


@pytest.mark.parametrize("flags,said", [
    (["--accum-steps", "0"], "--accum-steps must be >= 1"),
    (["--accum-steps", "3"], "batch 16 (as seen by this step: per rank) is "
                             "not divisible by accum_steps=3"),
])
def test_bad_accum_steps_are_refused_before_the_run_dir(tmp_path, flags,
                                                        said):
    argv = ["--device", "cpu", "--synthetic", "-a", "resnet18",
            "--num-classes", "8", "--image-size", "32", "-b", "16",
            "--outpath", str(tmp_path / "o")]
    with pytest.raises(ValueError, match=said.replace("(", r"\(")
                       .replace(")", r"\)")):
        cli.main(argv + flags)
    assert not (tmp_path / "o").exists()
