"""The port's mnasnet and shufflenet_v2 against tpudist's, on the CPU.

- mnasnet0_5 and shufflenet_v2_x0_5 at full width (each the smallest of
  its family), 64 px (so that the last stages normalise 16 rows: at 32
  px their 1x1 maps normalise 4, which carries the two frameworks' f32
  noise past 1e-4), 10 classes, batch 4, mnasnet's dropout live with
  tpudist's keep masks: the train-mode loss, logits, updated running
  statistics (mnasnet's momentum 1 − 0.9997) within 1e-4, and every
  gradient within a bound per model set at about 3x its reading (the
  comment above the test says which and why; mnasnet's eval-mode
  gradients within 1e-4 and 6e-4 of a leaf's L2 norm).
  Every BatchNorm is plain, its ReLU outside it, as tpudist's: no fused
  ``Function`` runs.
- ``channel_shuffle`` equals tpudist's (on the NHWC view).
- torchvision's ``.pth.tar``: the port's file is tpudist's for the same
  weights (mnasnet's flat ``layers.N``, shufflenet's ``stageS.J.branchB``),
  and tpudist's loads into the port.
"""

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tpudist.models import mnasnet as jax_mnasnet  # noqa: E402
from tpudist.models import shufflenet as jax_shufflenet  # noqa: E402
from tpudist_torch.compat.jax_params import (  # noqa: E402
    bn_net_state_dict_from_jax)
from tpudist_torch.models import create_model  # noqa: E402
from tpudist_torch.models.shufflenet import channel_shuffle  # noqa: E402

import test_torch_zoo as zoo  # noqa: E402
import test_torch_zoo_rest as rest  # noqa: E402

pytestmark = pytest.mark.torch_port

_two_torch_threads = zoo._two_torch_threads


# Train mode at init, batch 4: mnasnet0_5's backward amplifies f32
# rounding (a ReLU after a BatchNorm over few rows flips where a
# pre-activation sits within rounding of 0, and the BatchNorm backward
# spreads it over the channel; chip_numerics.py shows the same between
# the card and the CPU for mnasnet1_0). The port's read up to 3.2 %
# (stack2_2.expand) from tpudist's, so its gradients are held at 0.1 of
# ``1 + max|ref|`` and of their L2 norm (a zeroed or doubled gradient
# reads 1), and in eval mode (the running statistics: no amplification)
# within the plain bounds below. shufflenet_v2_x0_5's
# read up to 1.03e-4 of ``1 + max|ref|`` (stage2_0.b2_dw), and one
# near-zero BatchNorm scale's (stage2_0.b2_conv1_bn, L2 norm 1.5e-3) 7.8e-4
# of its norm, so its bounds are 3e-4 and 2.5e-3.
@pytest.mark.parametrize("arch,draws,grad_tol,grad_rel", [
    ("mnasnet0_5", 1, 0.1, 0.1),
    ("shufflenet_v2_x0_5", 0, 3e-4, 2.5e-3)])
def test_train_mode_matches_tpudist(arch, draws, grad_tol, grad_rel):
    mod = jax_mnasnet if arch.startswith("mnasnet") else jax_shufflenet
    jm = getattr(mod, arch)(num_classes=10, dtype=jnp.float32)
    v = zoo.jax_init(jm, 64)
    pm = zoo.port_from(create_model(arch, num_classes=10,
                                     dtype=torch.float32), v)
    x, y = zoo.batch(4, 64, seed=3)
    assert rest.check_train_mode(jm, v, pm, x, y, grad_tol=grad_tol,
                                 grad_rel=grad_rel) == draws


def test_mnasnet_eval_mode_gradients_match_tpudist():
    """mnasnet0_5's gradients with the running statistics (seeded values,
    so that each BatchNorm is a fixed affine map): the forward and every
    gradient within 1e-4 of ``1 + max|ref|`` and 6e-4 of the leaf's norm."""
    jm = jax_mnasnet.mnasnet0_5(num_classes=10, dtype=jnp.float32)
    v = zoo.jax_init(jm, 64)
    rng = np.random.default_rng(4)
    stats = jax.tree_util.tree_map(
        lambda s: (rng.uniform(0.5, 1.5, s.shape) if s.ndim else s)
        .astype(np.float32), v["batch_stats"])
    v = {"params": v["params"], "batch_stats": stats}
    x, y = zoo.batch(4, 64, seed=3)

    def loss_fn(params):
        logits = jm.apply({"params": params, "batch_stats": stats},
                          jnp.asarray(x), train=False)
        return jnp.sum(logits * logits), logits

    (_, want_logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"])
    pm = zoo.port_from(create_model("mnasnet0_5", num_classes=10,
                                     dtype=torch.float32), v)
    logits = pm.eval()(torch.from_numpy(x))
    (logits * logits).sum().backward()
    zoo.close(logits.detach().numpy(), np.asarray(want_logits), zoo.TOL,
              "logits")
    want = bn_net_state_dict_from_jax(jax.device_get(grads), {})
    zoo.close_grads({k: p.grad.numpy() for k, p in pm.named_parameters()},
                    {k: t.numpy() for k, t in want.items()})


def test_mnasnet_bn_momentum_is_torchvisions():
    m = create_model("mnasnet1_0", device="meta")
    assert m.stack0_0.dw_bn.momentum == pytest.approx(1 - 0.9997)


@pytest.mark.parametrize("groups", [2, 4])
def test_channel_shuffle_equals_tpudists(groups):
    x = np.random.default_rng(0).standard_normal((2, 3, 5, 8)).astype(
        np.float32)
    want = np.asarray(jax_shufflenet.channel_shuffle(jnp.asarray(x),
                                                     groups))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)           # channels_last
    got = channel_shuffle(xt, groups)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("arch,names", [
    ("mnasnet0_5", ("layers.0.weight", "layers.8.0.layers.3.weight",
                    "layers.15.running_var", "classifier.1.weight")),
    ("shufflenet_v2_x0_5", ("conv1.0.weight", "stage2.0.branch1.2.weight",
                            "stage4.3.branch2.6.running_mean", "fc.bias"))])
def test_pth_tar_round_trip_with_tpudist(arch, names):
    rest.check_pth_round_trip(arch, names)
