"""The port's ResNet against tpudist's, through the weight bridge.

A tiny resnet18 (``width=16``, 32 px images, 10 classes, batch 4) is
initialised in flax, carried across with ``resnet_state_dict_from_jax``
and run on the same numpy images by both packages in f32. tpudist runs its
plain BatchNorm epilogue (``tests/test_fused_norm.py`` already pins its
fused path to that one); the port runs both its fused ``Function``s (the
kernels' plain bodies on the CPU) and its plain epilogue. Train-mode
logits, the updated running statistics and every parameter gradient agree
within 1e-4 (rtol and atol): the two frameworks order the f32 sums of
convolutions and reductions differently, and nothing else differs. A
gradient is a sum over the whole batch, so its noise scales with the
tensor's largest entry: gradients agree within ``1e-4·(1 + max|ref|)``,
the scaling ``tests/test_fused_norm.py`` uses for its gradients.
"""

from functools import partial

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tpudist.models import resnet as jax_resnet  # noqa: E402
from tpudist.ops import cross_entropy_loss as jax_ce  # noqa: E402
from tpudist.ops import norm_dispatch  # noqa: E402
from tpudist_torch.compat.jax_params import (  # noqa: E402
    resnet_state_dict_from_jax)
from tpudist_torch.models import create_model  # noqa: E402
from tpudist_torch.models.resnet import Bottleneck, ResNet  # noqa: E402
from tpudist_torch.ops import fused_norm as fn  # noqa: E402
from tpudist_torch.ops.loss import cross_entropy_loss  # noqa: E402

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tiny shapes gain nothing from more threads, and the suite runs
    several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

TOL = dict(rtol=1e-4, atol=1e-4)
TINY = dict(num_classes=10, width=16)


@pytest.fixture(autouse=True)
def _plain_jax_epilogue():
    norm_dispatch.set_mode("off")
    yield
    norm_dispatch.set_mode(None)


def _close(got, want, tol=1e-4, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= tol * (1 + float(np.abs(want).max())), (what, err)


def _batch(n=4, size=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, size, size, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _pair(arch="resnet18", fused=True, s2d=False, seed=0):
    jm = getattr(jax_resnet, arch)(dtype=jnp.float32, s2d_stem=s2d, **TINY)
    variables = jax.device_get(jax.jit(lambda k: jm.init(
        k, jnp.ones((1, 32, 32, 3)), train=False))(jax.random.PRNGKey(seed)))
    pm = create_model(arch, dtype=torch.float32, fused_bn=fused,
                      s2d_stem=s2d, **TINY)
    pm.load_state_dict(resnet_state_dict_from_jax(
        variables["params"], variables["batch_stats"]), strict=True)
    return jm, variables, pm


def _jax_train(jm, variables, x, y):
    def loss_fn(params):
        logits, mut = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jax_ce(logits, jnp.asarray(y)), (logits, mut["batch_stats"])
    (_, (logits, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    return jax.device_get((logits, stats, grads))


def _port_train(pm, x, y):
    pm.train()
    logits = pm(torch.from_numpy(x))
    cross_entropy_loss(logits, torch.from_numpy(y)).backward()
    return logits.detach().numpy()


@pytest.mark.parametrize("fused,s2d", [(True, False), (False, False),
                                       (True, True)])
def test_train_step_logits_stats_and_grads_match_jax(fused, s2d):
    jm, variables, pm = _pair(fused=fused, s2d=s2d)
    x, y = _batch()
    want_logits, want_stats, want_grads = _jax_train(jm, variables, x, y)
    fn.reset_counts()
    got_logits = _port_train(pm, x, y)
    assert sum(fn.LAUNCHES.values()) == 0         # CPU: the plain bodies
    assert fn.RELAYOUTS == 0                      # channels_last throughout
    np.testing.assert_allclose(got_logits, np.asarray(want_logits), **TOL)

    want = resnet_state_dict_from_jax(want_grads, want_stats)
    sd = pm.state_dict()
    for k in [k for k in sd if k.endswith((".mean", ".var"))]:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), **TOL,
                                   err_msg=k)
    params = dict(pm.named_parameters())
    assert len(params) == len(want) - sum(
        k.endswith((".mean", ".var")) for k in want)
    for k, p in params.items():
        _close(p.grad.numpy(), want[k].numpy(), what=k)


def test_eval_logits_match_jax():
    jm, variables, pm = _pair()
    x, _ = _batch(seed=1)
    # Non-trivial running statistics: one train-mode pass on both sides.
    _, stats = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    variables = {"params": variables["params"],
                 "batch_stats": jax.device_get(stats["batch_stats"])}
    pm.load_state_dict(resnet_state_dict_from_jax(
        variables["params"], variables["batch_stats"]), strict=True)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    fn.reset_counts()
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_bottleneck_matches_jax():
    """The Bottleneck block, grouped (ResNeXt-style groups and base width),
    in a one-block-a-stage trunk: resnet50's depth adds nothing to check
    but compile time."""
    kw = dict(num_classes=10, width=16)
    jm = jax_resnet.ResNet(
        stage_sizes=[1, 1, 1, 1], dtype=jnp.float32,
        block=partial(jax_resnet.Bottleneck, groups=2, base_width=32), **kw)
    variables = jax.device_get(jax.jit(lambda k: jm.init(
        k, jnp.ones((1, 32, 32, 3)), train=False))(jax.random.PRNGKey(0)))
    pm = ResNet([1, 1, 1, 1], Bottleneck, dtype=torch.float32, groups=2,
                base_width=32, **kw)
    pm.load_state_dict(resnet_state_dict_from_jax(
        variables["params"], variables["batch_stats"]), strict=True)
    assert pm.layer2_0.conv2.groups == 2
    x, y = _batch(seed=2)
    want_logits, _, want_grads = _jax_train(jm, variables, x, y)
    got = _port_train(pm, x, y)
    np.testing.assert_allclose(got, np.asarray(want_logits), **TOL)
    want = resnet_state_dict_from_jax(want_grads, {})
    for k, p in pm.named_parameters():
        _close(p.grad.numpy(), want[k].numpy(), what=k)


def test_s2d_stem_equals_the_direct_conv():
    _, _, direct = _pair(s2d=False)
    _, _, s2d = _pair(s2d=True)
    x, _ = _batch(seed=3)
    with torch.no_grad():
        a = direct.conv1(torch.from_numpy(x))
        b = s2d.conv1(torch.from_numpy(x))
    assert b.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,n_params", [
    ("resnet18", 11_689_512), ("resnet50", 25_557_032),
    ("resnext50_32x4d", 25_028_904), ("wide_resnet50_2", 68_883_240)])
def test_param_count_on_meta_equals_torchvision(arch, n_params):
    m = create_model(arch, device="meta")
    assert sum(p.numel() for p in m.parameters()) == n_params


def test_resnet18_has_17_fused_sites():
    m = create_model("resnet18", device="meta")
    bn = [k for k in m.state_dict() if k.endswith(".var")]
    assert len(bn) == 20                   # 17 fused sites + 3 downsample


def test_fresh_init_follows_the_flax_distributions():
    def build(seed):
        m = create_model("resnet18", **TINY)
        m.reset_parameters(torch.Generator().manual_seed(seed))
        return m

    a, b, c = build(0), build(0), build(1)
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w = a.layer2_0.conv1.weight                       # (32, 16, 3, 3)
    assert not torch.equal(w, c.layer2_0.conv1.weight)
    std = (2.0 / (3 * 3 * 32)) ** 0.5                 # fan_out, untruncated
    assert abs(w.std().item() - std) < 0.1 * std
    assert w.abs().max().item() > 2.5 * std
    bound = 1 / 128 ** 0.5
    assert a.fc.weight.abs().max().item() <= bound
    assert a.fc.bias.abs().max().item() <= bound
    assert a.fc.bias.abs().max().item() > 0.5 * bound
    assert torch.all(a.bn1.scale == 1) and torch.all(a.bn1.var == 1)
    assert torch.all(a.layer1_0.bn2.bias == 0)
