"""The port's alexnet and squeezenet against tpudist's, on the CPU.

- alexnet (full width, 64 px: its three 3x3/s2 pools need more than 32)
  and squeezenet1_0 (full width, 64 px), 10 classes, batch 4, their
  dropouts live (0.5) with tpudist's keep masks replayed into the port:
  the train-mode loss and logits within 1e-4 and every gradient within
  1e-4 of ``1 + max|ref|`` and 6e-4 of its own L2 norm
  (``zoo.close_grads``), weights initialised in flax and carried across
  by ``compat/jax_params``. No BatchNorm: no kernel of the port runs.
- torchvision's ``.pth.tar`` for alexnet and squeezenet1_1: the port's
  file is tpudist's for the same weights (``features.N``,
  ``classifier.N``, squeezenet's ``features.N.squeeze``), and tpudist's
  loads into the port.
"""

import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tpudist.models.alexnet import AlexNet as JaxAlexNet  # noqa: E402
from tpudist.models.squeezenet import SqueezeNet as JaxSqueezeNet  # noqa: E402
from tpudist_torch.models.alexnet import AlexNet  # noqa: E402
from tpudist_torch.models.squeezenet import SqueezeNet  # noqa: E402

import test_torch_zoo as zoo  # noqa: E402
import test_torch_zoo_rest as rest  # noqa: E402

pytestmark = pytest.mark.torch_port

_two_torch_threads = zoo._two_torch_threads


def test_alexnet_train_mode_matches_tpudist():
    jm = JaxAlexNet(num_classes=10, dtype=jnp.float32)
    v = zoo.jax_init(jm, 64)
    pm = zoo.port_from(AlexNet(10, dtype=torch.float32), v)
    x, y = zoo.batch(4, 64, seed=1)
    assert rest.check_train_mode(jm, v, pm, x, y) == 2      # two dropouts


def test_squeezenet_train_mode_matches_tpudist():
    jm = JaxSqueezeNet(version="1_0", num_classes=10, dtype=jnp.float32)
    v = zoo.jax_init(jm, 64)
    pm = zoo.port_from(SqueezeNet("1_0", 10, dtype=torch.float32), v)
    x, y = zoo.batch(4, 64, seed=2)
    assert rest.check_train_mode(jm, v, pm, x, y) == 1


@pytest.mark.parametrize("arch,names", [
    ("alexnet", ("features.0.weight", "features.10.bias",
                 "classifier.6.weight")),
    ("squeezenet1_1", ("features.3.squeeze.weight",
                       "features.12.expand3x3.bias", "classifier.1.weight"))])
def test_pth_tar_round_trip_with_tpudist(arch, names):
    rest.check_pth_round_trip(arch, names)
