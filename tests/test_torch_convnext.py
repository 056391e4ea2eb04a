"""The port's ConvNeXt against tpudist's, on the CPU.

- A short ConvNeXt (tpudist's class: stages of 8 and 16 channels, 2
  blocks each, one downsampler), 10 classes, 32 px, batch 4, stochastic
  depth at 0.5 live with tpudist's keep masks replayed into the port,
  ``layer_scale`` drawn away from its 1e-6 init (seeded, so that the
  blocks' branches weigh in the gradients): the train-mode loss and
  logits within 1e-4 and every gradient within 1e-4 of ``1 + max|ref|``
  and 6e-4 of its own L2 norm. No BatchNorm: no kernel of the port runs.
- The rates ramp over ``blocks − 1`` and ``layer_scale`` starts at 1e-6,
  of shape (C,).
- torchvision's ``.pth.tar`` for convnext_tiny: the port's file is
  tpudist's for the same weights (``layer_scale`` (C, 1, 1) in the file),
  and tpudist's loads into the port.
"""

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tpudist.models.convnext import ConvNeXt as JaxConvNeXt  # noqa: E402
from tpudist_torch.models import create_model  # noqa: E402
from tpudist_torch.models.convnext import ConvNeXt  # noqa: E402

import test_torch_zoo as zoo  # noqa: E402
import test_torch_zoo_rest as rest  # noqa: E402

pytestmark = pytest.mark.torch_port

_two_torch_threads = zoo._two_torch_threads

SHORT = ((8, 16, 2), (16, None, 2))


def test_train_mode_matches_tpudist():
    jm = JaxConvNeXt(block_setting=SHORT, stochastic_depth_prob=0.5,
                     num_classes=10, dtype=jnp.float32)
    v = zoo.jax_init(jm, 32)
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.0, a.shape).astype(np.float32)
                      if jax.tree_util.keystr(p).endswith("['layer_scale']")
                      else a), v["params"])
    v = {"params": params}
    pm = zoo.port_from(ConvNeXt(SHORT, 0.5, 10, dtype=torch.float32), v)
    x, y = zoo.batch(4, 32, seed=4)
    assert rest.check_train_mode(jm, v, pm, x, y) == 3   # blocks 2–4


def test_rates_and_layer_scale_are_tpudists():
    m = create_model("convnext_tiny")
    rates = [getattr(m, n).sd_prob for n, is_block in m.layout if is_block]
    assert rates == [0.1 * i / 17 for i in range(18)]
    ls = m.features_1_0.layer_scale
    assert ls.shape == (96,) and torch.all(ls == 1e-6)
    assert m.features_0_norm.epsilon == 1e-6


def test_pth_tar_round_trip_with_tpudist():
    rest.check_pth_round_trip("convnext_tiny", (
        "features.0.0.weight", "features.0.1.weight",
        "features.1.0.block.0.bias", "features.1.2.layer_scale",
        "features.2.0.bias", "features.6.1.weight", "classifier.2.weight"))
