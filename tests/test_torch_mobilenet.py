"""The port's MobileNetV2 and V3 against tpudist's, on the CPU.

- The names and fused sites of mobilenet_v2 and mobilenet_v3_large/small
  are ``tests/test_torch_zoo_names.py``'s.
- A short MobileNetV3 (ReLU and hardswish blocks, with and without SE
  and expansion; last channel 32; 32 px) and MobileNetV2 at width 0.25
  (64 px, so that its last stages normalise 16 rows or more: at 32 px
  their 1x1 maps normalise 4, which carries the two frameworks' f32
  noise to 3.4e-4 of the logits), 10 classes, batch 4, dropout the
  identity, initialised in flax and
  carried across by ``compat/jax_params``: train-mode loss, logits,
  updated running statistics (V3's eps 1e-3 and momentum 0.01) within
  1e-4 and every gradient within 1e-4 (V3) or 5e-3 (V2) of
  ``1 + max|ref|`` and within 6e-4 (V3) or 1.5e-2 (V2) of its own L2
  norm (``zoo.close_grads``), through the fused ``Function``s (the
  kernels' plain bodies on the CPU) and the plain epilogue. V2 passes 35
  BatchNorms through relu6, whose kinks at 0 and 6 both cut the gradient:
  a pre-activation within rounding of either lands on either side in the
  two frameworks, and its stem's gradient reads 1.9e-3 apart (4.5e-3 of
  a leaf's norm at most).
- torchvision's ``.pth.tar`` for mobilenet_v3_small: the port's file is
  tpudist's for the same weights (torchvision's nested
  ``features.i.block.j`` indices), and tpudist's loads into the port.
"""

import functools

import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tpudist.compat import torch_checkpoint as jax_tc  # noqa: E402
from tpudist.models import mobilenet as jax_mn  # noqa: E402
from tpudist_torch.compat import torch_checkpoint as tc  # noqa: E402
from tpudist_torch.models import create_model  # noqa: E402
from tpudist_torch.models import mobilenet as mn  # noqa: E402

import test_torch_zoo as zoo  # noqa: E402

pytestmark = pytest.mark.torch_port

_two_torch_threads = zoo._two_torch_threads
_plain_jax_epilogue = zoo._plain_jax_epilogue

# kernel, expanded, out, SE, activation, stride
V3_SHORT = ((3, 16, 16, True, "RE", 2), (3, 40, 24, False, "RE", 2),
            (5, 48, 24, True, "HS", 1), (3, 72, 32, False, "HS", 1))


@functools.lru_cache(maxsize=None)
def _init(kind):
    if kind == "v3":
        jm = jax_mn.MobileNetV3(cfg=V3_SHORT, last_channel=32, num_classes=10,
                                dtype=jnp.float32, dropout=0.0)
    else:
        jm = jax_mn.MobileNetV2(num_classes=10, width_mult=0.25,
                                dtype=jnp.float32, dropout=0.0)
    return jm, zoo.jax_init(jm, 32)


@pytest.mark.parametrize("kind,fused", [("v3", True), ("v3", False),
                                        ("v2", True)])
def test_train_mode_matches_tpudist(kind, fused):
    jm, v = _init(kind)
    if kind == "v3":
        pm = mn.MobileNetV3(V3_SHORT, 32, 10, dtype=torch.float32,
                            dropout=0.0, fused_bn=fused)
    else:
        pm = mn.MobileNetV2(10, width_mult=0.25, dtype=torch.float32,
                            dropout=0.0, fused_bn=fused)
    zoo.port_from(pm, v)
    x, y = zoo.batch(4, 32 if kind == "v3" else 64)
    zoo.check_train_mode(jm, v, pm, x, y,
                         grad_tol=zoo.TOL if kind == "v3" else 5e-3,
                         grad_rel=zoo.REL if kind == "v3" else 1.5e-2)


def test_pth_tar_round_trip_with_tpudist():
    jm = jax_mn.mobilenet_v3_small(num_classes=10)
    v = zoo.random_variables(jm, 32, seed=2)
    pm = zoo.port_from(create_model("mobilenet_v3_small", num_classes=10), v)
    mine = tc.export_state_dict(pm, "mobilenet_v3_small")
    theirs = jax_tc.flax_to_torch_state_dict(v["params"], v["batch_stats"],
                                             "mobilenet_v3_small")
    assert set(mine) == set(theirs)
    assert all(torch.equal(mine[k], theirs[k]) for k in theirs)
    assert {"features.1.block.1.fc1.weight", "features.4.block.0.0.weight",
            "classifier.3.weight"} <= set(mine)
    fresh = create_model("mobilenet_v3_small", num_classes=10)
    tc.load_torch_state_dict(fresh, theirs, "mobilenet_v3_small")
    for k, t in pm.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], t), k
