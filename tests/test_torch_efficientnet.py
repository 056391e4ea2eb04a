"""The port's EfficientNet (v1, v2) against tpudist's, on the CPU.

- A short EfficientNet (tpudist's class at width 0.25 and depth 0.5: 10
  MBConv blocks, widths 8–80, SiLU, squeeze-excite, b5–b7's BatchNorm eps
  1e-3 and momentum 0.01) and a short EfficientNetV2 (its own stage
  table: FusedMBConv at expand ratio 1 and 4, MBConv; BatchNorm eps
  1e-3), 10 classes, 64 px (at 32 px the last stages normalise 4 rows,
  which carries the frameworks' f32 noise to 2e-4 of the stem's
  gradient), batch 4, stochastic depth at 0.5 and the classifier's
  dropout at 0.5 live, with tpudist's keep masks replayed into the port:
  the train-mode loss, logits and running statistics within 1e-4, every
  gradient within 1e-4 of ``1 + max|ref|`` and 6e-4 of its own L2 norm
  (``zoo.close_grads``). Every BatchNorm is plain (SiLU follows it): no
  fused ``Function`` runs.
- The stochastic-depth rates ramp with the block index (``0.2 · block /
  blocks``), and b5–b7 take eps 1e-3 and momentum 0.01, as tpudist's.
- torchvision's ``.pth.tar`` for efficientnet_b0 and efficientnet_v2_s:
  the port's file is tpudist's for the same weights (the nested
  ``features.S.I.block.J`` indices), and tpudist's loads into the port.
"""

import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tpudist.models import efficientnet as jax_eff  # noqa: E402
from tpudist_torch.models import create_model  # noqa: E402
from tpudist_torch.models import efficientnet as eff  # noqa: E402

import test_torch_zoo as zoo  # noqa: E402
import test_torch_zoo_rest as rest  # noqa: E402

pytestmark = pytest.mark.torch_port

_two_torch_threads = zoo._two_torch_threads
_plain_jax_epilogue = zoo._plain_jax_epilogue

# kind, expand ratio, kernel, stride, c_in, c_out, repeats
V2_SHORT = (("fused", 1, 3, 1, 8, 8, 2), ("fused", 4, 3, 2, 8, 16, 2),
            ("mb", 4, 3, 2, 16, 24, 2), ("mb", 6, 3, 1, 24, 32, 1))


@pytest.mark.parametrize("kind,draws", [("v1", 4), ("v2", 4)])
def test_train_mode_matches_tpudist(kind, draws):
    common = dict(num_classes=10, stochastic_depth_prob=0.5, dropout=0.5)
    if kind == "v1":
        jm = jax_eff.EfficientNet(width_mult=0.25, depth_mult=0.5,
                                  bn_epsilon=1e-3, bn_momentum=0.01,
                                  dtype=jnp.float32, **common)
        pm = eff.EfficientNet(0.25, 0.5, bn_epsilon=1e-3, bn_momentum=0.01,
                              dtype=torch.float32, **common)
    else:
        jm = jax_eff.EfficientNetV2(table=V2_SHORT, dtype=jnp.float32,
                                    **common)
        pm = eff.EfficientNetV2(V2_SHORT, dtype=torch.float32, **common)
    v = zoo.jax_init(jm, 32)
    zoo.port_from(pm, v)
    x, y = zoo.batch(4, 64, seed=3)
    # 3 residual blocks past the first (rate 0) draw, and the dropout.
    assert rest.check_train_mode(jm, v, pm, x, y) == draws


def test_rates_and_batchnorm_settings_are_tpudists():
    b0 = create_model("efficientnet_b0", device="meta")
    rates = [getattr(b0, n).sd_prob for n in b0.blocks]
    assert rates == [0.2 * i / 16 for i in range(16)]
    assert b0.features_0.bn.epsilon == 1e-5 and b0.drop.rate == 0.2
    b7 = create_model("efficientnet_b7", device="meta")
    assert (b7.features_0.bn.epsilon, b7.features_0.bn.momentum) \
        == (1e-3, 0.01) and b7.drop.rate == 0.5
    v2 = create_model("efficientnet_v2_l", device="meta")
    assert (v2.features_0.bn.epsilon, v2.features_0.bn.momentum) \
        == (1e-3, 0.1) and v2.drop.rate == 0.4
    assert v2.head_name == "features_8"


@pytest.mark.parametrize("arch,names", [
    ("efficientnet_b0", ("features.1.0.block.0.0.weight",
                         "features.2.0.block.1.1.running_var",
                         "features.2.1.block.2.fc2.bias",
                         "features.8.0.weight", "classifier.1.weight")),
    ("efficientnet_v2_s", ("features.1.1.block.0.1.weight",
                           "features.2.0.block.1.0.weight",
                           "features.4.0.block.2.fc1.weight",
                           "features.7.1.running_mean"))])
def test_pth_tar_round_trip_with_tpudist(arch, names):
    rest.check_pth_round_trip(arch, names)
