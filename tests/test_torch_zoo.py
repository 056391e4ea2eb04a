"""The port's BatchNorm+ReLU conv families against tpudist's, on the CPU:
vgg (+bn), densenet, googlenet, inception_v3, mobilenet and regnet.

This file holds what every family shares, and the helpers the family
files (``test_torch_vgg.py``, ``test_torch_densenet.py``,
``test_torch_inception.py``, ``test_torch_mobilenet.py``,
``test_torch_regnet.py``) import:

- the 31 archs' parameter counts on the meta device equal tpudist's
  (``tests/test_zoo.py``'s torchvision counts);
- the port's parameter and buffer names map 1:1, with their shapes, onto
  tpudist's flax tree (``jax.eval_shape`` of its init), and the port's
  count of fused BN+ReLU sites in a train-mode forward equals tpudist's
  count of ``act="relu"`` BatchNorm calls (densenet121 121, inception_v3
  96 with its aux head);
- ``max_pool_ceil``, ``adaptive_avg_pool`` and ``BasicConv2d`` equal
  tpudist's (f32, 1e-5);
- every BatchNorm input of every family is a channels_last tensor, so
  the fused epilogue reads its rows without a copy;
- the dropout layer keeps a share 1 − p within 5 binomial standard
  deviations, scales by 1/(1 − p) exactly, keeps the compute dtype, and
  its train-step masks are seeded by (seed, optimizer step, rank,
  microbatch): a resumed step draws the straight run's mask, ranks and
  microbatches draw apart;
- each family's fresh init follows flax's distributions (the draws are
  the port's own);
- vit_moe and vit_pipe (and an unknown arch) are refused by name, and
  ``--flash on`` for every conv family.
"""

import functools
import math

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tpudist.models import create_model as jax_create  # noqa: E402
from tpudist.models import layers as jax_layers  # noqa: E402
from tpudist.ops import norm_dispatch  # noqa: E402
from tpudist_torch import __main__ as cli  # noqa: E402
from tpudist_torch import config as port_config  # noqa: E402
from tpudist_torch import train as port_train  # noqa: E402
from tpudist_torch.compat.jax_params import (  # noqa: E402
    bn_net_state_dict_from_jax, jax_tree)
from tpudist_torch.models import create_model, model_names  # noqa: E402
from tpudist_torch.models import layers  # noqa: E402
from tpudist_torch.models.layers import BatchNorm, split_aux  # noqa: E402
from tpudist_torch.ops import fused_norm as fn  # noqa: E402
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


@pytest.fixture(autouse=True)
def _plain_jax_epilogue():
    norm_dispatch.set_mode("off")
    yield
    norm_dispatch.set_mode(None)


# torchvision's published counts, which tests/test_zoo.py holds tpudist's
# models to (num_classes=1000).
GOLDEN = {
    "vgg11": 132_863_336, "vgg13": 133_047_848, "vgg16": 138_357_544,
    "vgg19": 143_667_240, "vgg11_bn": 132_868_840, "vgg13_bn": 133_053_736,
    "vgg16_bn": 138_365_992, "vgg19_bn": 143_678_248,
    "densenet121": 7_978_856, "densenet169": 14_149_480,
    "densenet201": 20_013_928, "densenet161": 28_681_000,
    "googlenet": 6_624_904, "inception_v3": 27_161_264,
    "mobilenet_v2": 3_504_872, "mobilenet_v3_large": 5_483_032,
    "mobilenet_v3_small": 2_542_856,
    "regnet_y_400mf": 4_344_144, "regnet_y_800mf": 6_432_512,
    "regnet_y_1_6gf": 11_202_430, "regnet_y_3_2gf": 19_436_338,
    "regnet_y_8gf": 39_381_472, "regnet_y_16gf": 83_590_140,
    "regnet_y_32gf": 145_046_770, "regnet_x_400mf": 5_495_976,
    "regnet_x_800mf": 7_259_656, "regnet_x_1_6gf": 9_190_136,
    "regnet_x_3_2gf": 15_296_552, "regnet_x_8gf": 39_572_648,
    "regnet_x_16gf": 54_278_536, "regnet_x_32gf": 107_811_560,
}
ZOO = sorted(GOLDEN)
# The input a full-size model takes: inception_v3's aux head needs 299 px.
SIZE = {"inception_v3": 299}
# tpudist's fused-site counts of the models chip_smoke.py trains on the card.
SITES = {"vgg16_bn": 13, "densenet121": 121, "googlenet": 57,
         "inception_v3": 96, "mobilenet_v3_large": 11, "regnet_y_400mf": 33,
         "mobilenet_v2": 0, "vgg16": 0}
TOL = 1e-4
# Each gradient is also held relative to its own size: ‖got − want‖₂ within
# REL of ‖want‖₂, so a zero or doubled gradient reads 1. The families read
# at most 2e-4 (googlenet whole, inception's aux head alone) and
# mobilenet_v2 4.5e-3 (relu6's two kinks); REL sits about 3x above the
# first. A leaf whose gradient is under GRAD_FLOOR of the largest leaf's
# is 0 but for rounding (a conv bias ahead of a batch-statistics
# BatchNorm, as vgg's; a projection BatchNorm's bias that the next
# BatchNorm normalises away, as mobilenet's; read 1e-10 to 6e-7 of the
# largest) and is held by the absolute bound alone.
REL = 6e-4
GRAD_FLOOR = 1e-5


# -- the helpers the family files share ---------------------------------------

def close(got, want, tol=TOL, what=""):
    """Within ``tol·(1 + max|want|)``: a gradient is a sum over the batch,
    so its f32 noise scales with the tensor's largest entry."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * (1 + float(np.abs(want).max())), (what, err)


def close_grads(got: dict, want: dict, tol=TOL, rel=REL):
    """Every gradient leaf of ``got`` within ``tol`` (``close``) of
    ``want``'s, and within ``rel`` of its own L2 norm where that is at
    least ``GRAD_FLOOR`` of the largest leaf's."""
    want = {k: np.asarray(w, np.float64) for k, w in want.items()}
    top = max(float(np.linalg.norm(w)) for w in want.values())
    for k, w in want.items():
        g = np.asarray(got[k], np.float64)
        close(g, w, tol, k)
        size = float(np.linalg.norm(w))
        if size >= GRAD_FLOOR * top:
            err = float(np.linalg.norm(g - w))
            assert err <= rel * size, (k, err / size)


def flat_shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_shapes(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = tuple(v.shape)
    return out


@functools.lru_cache(maxsize=None)
def jax_tree_and_sites(arch: str):
    """tpudist's ``(params, batch_stats)`` shapes of ``arch`` (an abstract
    init at a small input: no parameter shape depends on it) and its count
    of ``act="relu"`` BatchNorm calls, the sites its dispatch asks."""
    calls = {"relu": 0}
    real = jax_layers.BatchNorm.__call__

    def counting(self, x, *a, **k):
        calls["relu"] += k.get("act") == "relu"
        return real(self, x, *a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_layers.BatchNorm, "__call__", counting)
    try:
        m = jax_create(arch, num_classes=1000)
        size = 75 if arch == "inception_v3" else 32
        v = jax.eval_shape(lambda r, x: m.init(r, x, train=False),
                           jax.random.PRNGKey(0), jnp.ones((1, size, size, 3)))
    finally:
        mp.undo()
    return (flat_shapes(v["params"]), flat_shapes(v.get("batch_stats", {})),
            calls["relu"])


def port_trees(arch: str):
    """The port's model of ``arch`` on the meta device, as the flax tree
    its names map to: ``(params, batch_stats)`` shapes."""
    m = create_model(arch, device="meta")
    return (flat_shapes(jax_tree(m.named_parameters())),
            flat_shapes(jax_tree([(n, b) for n, b in m.named_buffers()
                                  if b.is_floating_point()])))


def port_sites(arch: str, size: int | None = None, n: int = 2,
               eligible: bool = False) -> int:
    """The BN+ReLU sites of a train-mode forward of ``n`` images at
    ``size`` px (the full size by default), on the meta device with the
    plain epilogue; with ``eligible``, only those whose ``(rows, C)`` the
    dispatch may fuse (``norm_dispatch.fused_eligible``: 8 rows or more,
    as tpudist)."""
    from tpudist_torch.ops.norm_dispatch import fused_eligible
    m = create_model(arch, device="meta", fused_bn=False)
    count = [0]

    def hook(mod, args, kwargs):
        if kwargs.get("act") != "relu":
            return
        x = args[0]
        rows = x.shape[0] * x.shape[2] * x.shape[3]
        count[0] += (not eligible
                     or fused_eligible(rows=rows, channels=x.shape[1])[0])

    for mod in m.modules():
        if isinstance(mod, BatchNorm):
            mod.register_forward_pre_hook(hook, with_kwargs=True)
    s = size or SIZE.get(arch, 224)
    m.train()(torch.zeros((n, s, s, 3), device="meta"))
    return count[0]


def check_tree_and_sites(arch: str):
    want_p, want_s, want_sites = jax_tree_and_sites(arch)
    got_p, got_s = port_trees(arch)
    assert got_p == want_p
    assert got_s == want_s
    assert port_sites(arch) == want_sites
    if arch in SITES:
        assert want_sites == SITES[arch]


def jax_init(jm, size: int, seed: int = 0):
    return jax.device_get(jax.jit(lambda k: jm.init(
        k, jnp.ones((1, size, size, 3)), train=False))(
            jax.random.PRNGKey(seed)))


def random_variables(jm, size: int, seed: int = 0) -> dict:
    """tpudist's variable tree of ``jm`` (shapes from an abstract init at
    ``size`` px) filled with seeded normal draws: weights for the interop
    checks, which need values but no training."""
    v = jax.eval_shape(lambda r, x: jm.init(r, x, train=False),
                       jax.random.PRNGKey(0), jnp.ones((1, size, size, 3)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        {"params": v["params"], "batch_stats": v["batch_stats"]})


def batch(n: int, size: int, seed: int = 0, classes: int = 10):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, size, size, 3)).astype(np.float32),
            rng.integers(0, classes, n).astype(np.int32))


def port_from(pm, variables):
    pm.load_state_dict(bn_net_state_dict_from_jax(
        variables["params"], variables.get("batch_stats", {})), strict=True)
    return pm


def jax_train_mode(jm, variables, x, y):
    """tpudist's train-mode loss (``_loss_fn``: the aux heads weighted
    in), its logits, aux logits, updated statistics and gradients."""
    from tpudist import train as jax_train

    def loss_fn(params):
        return jax_train._loss_fn(jm, jax.random.PRNGKey(0), params,
                                  variables.get("batch_stats", {}),
                                  jnp.asarray(x), jnp.asarray(y))

    (loss, (logits, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    _, mut = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats", "intermediates"],
        rngs={"dropout": jax.random.PRNGKey(0)}))(variables, jnp.asarray(x))
    aux = jax.tree_util.tree_leaves(mut.get("intermediates", {}))
    return jax.device_get((loss, logits, aux, stats, grads))


def port_train_mode(pm, x, y, relayouts=0):
    """The port's train-mode loss (``train.forward_loss``), logits and aux
    logits, after its backward (which copies ``relayouts`` incoming
    gradients into rows: see ``assert_channels_last_at_every_bn``)."""
    seen = {}
    handle = pm.register_forward_hook(
        lambda m, a, out: seen.setdefault("out", out))
    pm.train()
    fn.reset_counts()
    try:
        loss, logits = port_train.forward_loss(
            pm, torch.from_numpy(x), torch.from_numpy(y), None, None, 0.0,
            float(getattr(pm, "aux_loss_weight", 0.0)))
    finally:
        handle.remove()
    loss.backward()
    assert sum(fn.LAUNCHES.values()) == 0         # CPU: the plain bodies
    assert fn.RELAYOUTS == relayouts
    _, aux = split_aux(seen["out"])
    return (float(loss.detach()), logits.detach().numpy(),
            [a.detach().numpy() for a in aux])


def check_train_mode(jm, variables, pm, x, y, tol=TOL, relayouts=0,
                     grad_tol=TOL, grad_rel=REL):
    """Train-mode loss, logits, aux logits and running statistics of the
    port within ``tol`` of tpudist's, every gradient within ``grad_tol``
    (of ``1 + max|ref|``) and ``grad_rel`` of its norm (``close_grads``)."""
    want_loss, want_logits, want_aux, want_stats, want_grads = \
        jax_train_mode(jm, variables, x, y)
    got_loss, got_logits, got_aux = port_train_mode(pm, x, y, relayouts)
    assert abs(got_loss - float(want_loss)) <= tol * (1 + abs(want_loss))
    close(got_logits, want_logits, tol, "logits")
    assert len(got_aux) == len(want_aux)
    for i, (g, w) in enumerate(zip(got_aux, want_aux)):
        close(g, w, tol, f"aux {i}")
    want = bn_net_state_dict_from_jax(want_grads, want_stats)
    sd = pm.state_dict()
    stats = [k for k in sd if k.endswith((".mean", ".var"))]
    assert len(stats) == sum(k.endswith((".mean", ".var")) for k in want)
    for k in stats:
        close(sd[k].numpy(), want[k].numpy(), tol, k)
    params = dict(pm.named_parameters())
    assert len(params) == len(want) - len(stats)
    close_grads({k: p.grad.numpy() for k, p in params.items()},
                {k: want[k].numpy() for k in params}, grad_tol, grad_rel)


def assert_channels_last_at_every_bn(pm, x, relayouts=0):
    """Every BatchNorm of a train-mode forward gets a channels_last input,
    so the fused epilogue's rows need no copy; in the backward,
    ``relayouts`` incoming gradients are copied into rows: those of the
    branch outputs a ``torch.cat`` joins along the channels, whose
    gradients are channel slices of the concatenation's."""
    seen = []

    def hook(mod, args, kwargs):
        t = args[0]
        seen.append(t.is_contiguous(memory_format=torch.channels_last))

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in pm.modules() if isinstance(m, BatchNorm)]
    try:
        fn.reset_counts()
        logits, aux = split_aux(pm.train()(torch.from_numpy(x)))
        (logits.float().sum() + sum(a.float().sum() for a in aux)).backward()
    finally:
        for h in handles:
            h.remove()
    assert seen and all(seen), seen
    assert fn.RELAYOUTS == relayouts


def train_tiny(arch: str, tmp_path, size: int = 32, batch: int = 2):
    """The trainer (``--fused-bn on``, ``--device cpu``) builds ``arch``
    at 4 classes and ``size`` px and trains one step of ``batch`` images,
    then validates: the step runs the fused epilogue's forward and
    backward at every site of the model (the kernels' plain bodies), the
    loss is finite and the validation launches none."""
    from tpudist_torch.data import build_train_val_loaders
    from tpudist_torch.trainer import Trainer
    argv = ["--device", "cpu", "--synthetic", "-a", arch, "--num-classes",
            "4", "--image-size", str(size), "--val-resize", str(size), "-b",
            str(batch), "--epochs", "1", "--synthetic-size", str(batch),
            "--fused-bn", "on", "-p", "1", "--seed", "0", "--outpath",
            str(tmp_path / "o")]
    cfg = port_config.from_args(argv)
    port_config.refuse_unsupported(cfg)
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = fn.bn_act_fwd, fn.bn_act_bwd

    def fwd(*a, **k):
        calls["fwd"] += 1
        return real_fwd(*a, **k)

    def bwd(*a, **k):
        calls["bwd"] += 1
        return real_bwd(*a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(fn, "bn_act_fwd", fwd)
    mp.setattr(fn, "bn_act_bwd", bwd)
    try:
        tr = Trainer(cfg)
        train, val = build_train_val_loaders(cfg, 0, 1)
        loss, _ = tr.train_epoch(train, 0, cfg.lr)
        sites = port_sites(arch, size, batch, eligible=True)
        assert calls == {"fwd": sites, "bwd": sites}, (calls, sites)
        tr.validate(val, 0)
        assert calls == {"fwd": sites, "bwd": sites}
    finally:
        mp.undo()
    assert np.isfinite(loss)
    return tr


# -- registry, counts, names and sites ----------------------------------------

def test_registry_holds_the_31_archs_and_the_earlier_14():
    names = set(model_names())
    assert set(ZOO) <= names and len(ZOO) == 31
    # ... and the 33 of the rest of the one-card zoo
    # (tests/test_torch_zoo_rest.py).
    assert len(names) == 45 + 33


@pytest.mark.parametrize("arch", ZOO)
def test_param_count_on_meta_equals_tpudists(arch):
    m = create_model(arch, device="meta")
    assert sum(p.numel() for p in m.parameters()) == GOLDEN[arch]


@pytest.mark.parametrize("arch", [a for a in ZOO if a.startswith("vgg")])
def test_names_map_onto_tpudists_tree_and_sites_match(arch):
    check_tree_and_sites(arch)


# -- layers --------------------------------------------------------------------

@pytest.mark.parametrize("size,window,stride,pad", [
    (7, 3, 2, 0), (8, 3, 2, 0), (14, 3, 2, 0), (15, 3, 2, 0), (9, 2, 2, 0),
    (13, 3, 1, 1), (6, 3, 2, 1), (5, 2, 2, 1), (112, 3, 2, 0)])
def test_max_pool_ceil_equals_tpudists(size, window, stride, pad):
    x = np.random.default_rng(size).standard_normal(
        (2, size, size + 1, 5)).astype(np.float32)
    want = np.asarray(jax_layers.max_pool_ceil(jnp.asarray(x), window, stride,
                                               padding=pad))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)          # channels_last
    got = layers.max_pool_ceil(xt, window, stride, pad)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("size,out", [(7, 7), (14, 7), (1, 7), (5, 7),
                                      (10, 4), (17, 4), (3, 4), (9, 4)])
def test_adaptive_avg_pool_equals_tpudists(size, out):
    x = np.random.default_rng(size).standard_normal(
        (2, size, size, 6)).astype(np.float32)
    want = np.asarray(jax_layers.adaptive_avg_pool(jnp.asarray(x),
                                                   (out, out)))
    got = layers.adaptive_avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2),
                                   (out, out))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kernel,padding,stride", [
    ((1, 7), (0, 3), 1), ((3, 1), (1, 0), 1), (3, 0, 2), (5, 2, 1)])
def test_basic_conv2d_equals_tpudists(kernel, padding, stride):
    jm = jax_layers.BasicConv2d(12, kernel, stride, padding,
                                dtype=jnp.float32)
    x, _ = batch(3, 9, seed=4)
    x = x[..., :3]
    v = jax.device_get(jax.jit(lambda k: jm.init(
        k, jnp.ones((1, 9, 9, 3)), train=False))(jax.random.PRNGKey(1)))

    def loss(params):
        y, mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                          jnp.asarray(x), True, mutable=["batch_stats"])
        return jnp.sum(y * y), (y, mut["batch_stats"])

    (_, (y, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    pm = layers.BasicConv2d(3, 12, kernel, stride, padding=padding,
                            dtype=torch.float32)
    port_from(pm, v)
    got = pm.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    (got * got).sum().backward()
    close(got.permute(0, 2, 3, 1).detach().numpy(), y, 1e-5, "y")
    want = bn_net_state_dict_from_jax(jax.device_get(grads),
                                      jax.device_get(stats))
    close(pm.bn.var.numpy(), want["bn.var"].numpy(), 1e-5, "var")
    assert pm.bn.epsilon == 1e-3
    for k, p in pm.named_parameters():
        close(p.grad.numpy(), want[k].numpy(), 1e-5, k)


# The fused sites whose output a torch.cat joins straight away: googlenet's
# four branch ends in each of its 9 Inception blocks.
RELAYOUTS = {"googlenet": 36}


@pytest.mark.parametrize("arch", ["vgg11_bn", "densenet121", "googlenet",
                                  "mobilenet_v3_small", "regnet_y_400mf"])
def test_every_bn_input_is_channels_last(arch):
    pm = create_model(arch, num_classes=4, dtype=torch.float32)
    pm.reset_parameters(torch.Generator().manual_seed(0))
    x, _ = batch(2, 32, seed=5)
    assert_channels_last_at_every_bn(pm, x, RELAYOUTS.get(arch, 0))


# -- dropout -------------------------------------------------------------------

@pytest.mark.parametrize("rate,dtype", [(0.5, torch.float32),
                                        (0.2, torch.bfloat16),
                                        (0.7, torch.float32)])
def test_dropout_keeps_its_share_and_scales_exactly(rate, dtype):
    x = (torch.rand(400, 500, generator=torch.Generator().manual_seed(0))
         + 0.5).to(dtype)
    d = layers.Dropout(rate)
    with layers.dropout_seed(3):
        y = d.train()(x)
    assert y.dtype == dtype
    kept = y != 0
    n, keep = x.numel(), 1.0 - rate
    share = float(kept.float().mean())
    assert abs(share - keep) <= 5 * math.sqrt(keep * rate / n), share
    assert torch.equal(y[kept], x[kept] / keep)
    with layers.dropout_seed(3):
        assert torch.equal(d(x), y)                     # seeded: the same
    with layers.dropout_seed(4):
        assert not torch.equal(d(x) != 0, kept)
    assert torch.equal(d.eval()(x), x)
    assert torch.equal(layers.Dropout(0.0).train()(x), x)


class _Dropped(torch.nn.Module):
    """A linear layer behind a dropout, recording each train mask."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(16, 4)
        self.drop = layers.Dropout(0.5)
        self.masks = []

    def forward(self, x):
        y = self.drop(x)
        if self.training:
            self.masks.append((y != 0).clone())
        return self.fc(y)


def _masks(steps, first_step=0, accum=1, rank=0, monkeypatch=None):
    if monkeypatch is not None:
        monkeypatch.setattr(port_train.dist_lib, "data_rank_world",
                            lambda: (rank, 2))
    torch.manual_seed(0)
    m = _Dropped()
    cfg = port_config.Config(seed=5, batch_size=8, accum_steps=accum, lr=0.1)
    step = port_train.make_train_step(
        m, port_train.make_optimizer(m, cfg), cfg, first_step=first_step)
    x = torch.ones(8, 16)
    y = torch.zeros(8, dtype=torch.long)
    for _ in range(steps):
        step(x, y, 0.1)
    return m.masks


def test_dropout_masks_are_seeded_by_step_rank_and_microbatch(monkeypatch):
    straight = _masks(3)
    resumed = _masks(1, first_step=2)
    assert torch.equal(resumed[0], straight[2])         # a resume redraws
    assert not torch.equal(straight[0], straight[1])
    rank1 = _masks(3, rank=1, monkeypatch=monkeypatch)
    assert not any(torch.equal(a, b) for a, b in zip(straight, rank1))
    monkeypatch.undo()
    accum = _masks(1, accum=2)
    assert len(accum) == 2 and accum[0].shape == (4, 16)
    assert not torch.equal(accum[0], accum[1])
    seed = port_train.dropout_step_seed(5, 0, 0, 1)
    g = torch.Generator().manual_seed(seed)
    assert torch.equal(accum[1], torch.rand((4, 16), generator=g) < 0.5)


# -- init ----------------------------------------------------------------------

def _std(t):
    return float(t.detach().float().std())


def test_fresh_init_follows_the_flax_distributions():
    g = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    trunc = 0.87962566103423978        # std of a unit normal cut at ±2

    inc = create_model("inception_v3", num_classes=10)
    inc.reset_parameters(g(0))
    w = inc.Mixed_6b.branch7x7_2.conv.weight
    assert abs(_std(w) - 0.1 * trunc) < 0.05 * 0.1
    assert float(w.abs().max()) <= 0.2
    assert float(inc.fc.weight.abs().max()) <= 0.2
    assert abs(_std(inc.fc.weight) - 0.1 * trunc) < 0.1 * 0.1
    assert float(inc.AuxLogits.fc.weight.abs().max()) <= 0.002
    assert float(inc.fc.bias.abs().max()) <= 1 / math.sqrt(2048)
    assert inc.Mixed_5b.branch1x1.bn.epsilon == 1e-3

    gn = create_model("googlenet", num_classes=10, aux_logits=True)
    gn.reset_parameters(g(1))
    w = gn.inception4a.branch2_1.conv.weight
    assert abs(_std(w) - 0.01 * trunc) < 0.05 * 0.01
    assert float(w.abs().max()) <= 0.02
    assert float(gn.aux1.fc1.weight.abs().max()) <= 0.02
    assert float(gn.fc.weight.abs().max()) <= 0.02

    for arch, fc in (("vgg11_bn", "classifier_0"),
                     ("mobilenet_v3_small", "classifier_3"),
                     ("mobilenet_v2", "classifier_1"),
                     ("regnet_y_400mf", "fc")):
        m = create_model(arch, num_classes=10)
        m.reset_parameters(g(2))
        lin = getattr(m, fc)
        assert abs(_std(lin.weight) - 0.01) < 0.05 * 0.01, arch
        assert float(lin.weight.abs().max()) > 2.5 * 0.01, arch  # untruncated
        assert torch.all(lin.bias == 0), arch
        bns = [b for b in m.modules() if isinstance(b, BatchNorm)]
        assert all(torch.all(b.scale == 1) and torch.all(b.var == 1)
                   for b in bns), arch
    rg = create_model("regnet_y_400mf", num_classes=10)
    rg.reset_parameters(g(3))
    w = rg.block2_0.f_b.conv.weight                  # grouped 3x3
    std = math.sqrt(2.0 / (3 * 3 * w.shape[0]))       # fan_out, untruncated
    assert abs(_std(w) - std) < 0.05 * std
    assert torch.all(rg.block2_0.f_se.fc1.bias == 0)
    v3 = create_model("mobilenet_v3_small", num_classes=10)
    assert v3.features_1.dw.bn.epsilon == 1e-3
    assert v3.features_1.dw.bn.momentum == 0.01
    dn = create_model("densenet121", num_classes=10)
    dn.reset_parameters(g(4))
    assert float(dn.classifier.weight.abs().max()) <= 1 / math.sqrt(1024)
    vg = create_model("vgg11", num_classes=10)
    vg.reset_parameters(g(5))
    assert torch.all(vg.features_0.bias == 0)


def test_fresh_init_is_the_seeds_and_device_free():
    a = create_model("googlenet", num_classes=10)
    b = create_model("googlenet", num_classes=10)
    a.reset_parameters(torch.Generator().manual_seed(7))
    b.reset_parameters(torch.Generator().manual_seed(7))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


# -- the CLI's gate --------------------------------------------------------------

TINY = ["--device", "cpu", "--synthetic", "--num-classes", "4",
        "--image-size", "32", "-b", "2", "--epochs", "1"]


@pytest.mark.parametrize("arch", [
    "vit_moe_b_16", "vit_moe_s_16", "vit_pipe_b_16", "vit_pipe_s_16",
    "resnet9000"])
def test_other_families_are_refused_by_name(tmp_path, arch):
    """Since the rest of the one-card zoo is ported, the families left
    are vit_moe and vit_pipe (they need the expert and pipe mesh axes);
    an arch that no registry holds is refused by name too."""
    with pytest.raises(ValueError, match=f"-a {arch} \\("):
        cli.main(TINY + ["-a", arch, "--outpath", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


@pytest.mark.parametrize("arch", ["vgg16_bn", "densenet121", "googlenet",
                                  "inception_v3", "mobilenet_v2",
                                  "regnet_x_400mf"])
def test_flash_on_is_refused_for_the_conv_families(tmp_path, arch):
    cfg = port_config.Config(arch=arch)
    port_config.refuse_unsupported(cfg)
    with pytest.raises(ValueError, match="--flash on"):
        cli.main(TINY + ["-a", arch, "--flash", "on", "--outpath",
                         str(tmp_path / "o")])


def test_mixed_loss_is_tpudists_mixed_ce():
    """``forward_loss`` adds the aux heads with the main logits' mix labels
    and lam (the CE itself is held in ``test_torch_accum_mixup.py``)."""
    class Two(torch.nn.Module):
        aux_loss_weight = 0.4

        def forward(self, x):
            return layers.AuxOutputs(x * 2, (x, x * 3))

    x = torch.randn(4, 5, generator=torch.Generator().manual_seed(0))
    y, y2 = torch.tensor([0, 1, 2, 3]), torch.tensor([4, 3, 2, 1])
    loss, logits = port_train.forward_loss(Two(), x, y, y2, 0.3, 0.1, 0.4)
    want = mixed_ce(x * 2, y, y2, 0.3, 0.1)
    for a in (x, x * 3):
        want = want + 0.4 * mixed_ce(a, y, y2, 0.3, 0.1)
    assert torch.equal(logits, x * 2)
    assert torch.equal(loss, want)
