"""The port's MaxViT against tpudist's, on the CPU.

- ``_window_partition``/``_grid_partition`` and their reverses equal
  tpudist's (8x8 maps, partition 2 and 4).
- The short MaxViT that ``tests/test_maxvit.py`` trains (stem 8,
  stages of 8 and 16 channels, one layer each, head dim 8, partition 2),
  10 classes, 32 px, batch 4, stochastic depth at 0.5 live (one keep per
  image across its windows) with tpudist's keep masks replayed into the
  port: the train-mode loss, logits and running statistics (eps 1e-3,
  momentum 0.99) within 1e-4, every gradient within 1e-4 of
  ``1 + max|ref|`` and 6e-4 of its own L2 norm. Every BatchNorm is plain
  (exact GELU after it) and the relative-position attention never takes
  the flash kernels: no kernel of the port runs.
- torchvision's ``.pth.tar`` for maxvit_t: the port's file is tpudist's
  for the same weights (the ``(L, L)`` relative-position index written
  beside each bias table), and tpudist's loads into the port.
"""

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tpudist.models import maxvit as jax_maxvit  # noqa: E402
from tpudist_torch.models import create_model  # noqa: E402
from tpudist_torch.models import maxvit  # noqa: E402

import test_torch_zoo as zoo  # noqa: E402
import test_torch_zoo_rest as rest  # noqa: E402

pytestmark = pytest.mark.torch_port

_two_torch_threads = zoo._two_torch_threads
_plain_jax_epilogue = zoo._plain_jax_epilogue

SHORT = dict(stem_channels=8, block_channels=(8, 16), block_layers=(1, 1),
             head_dim=8, partition=2, stochastic_depth_prob=0.5,
             num_classes=10)


@pytest.mark.parametrize("kind", ["window", "grid"])
@pytest.mark.parametrize("p", [2, 4])
def test_partitions_equal_tpudists(kind, p):
    x = np.random.default_rng(p).standard_normal((2, 8, 8, 3)).astype(
        np.float32)
    jp, jr = (getattr(jax_maxvit, f"_{kind}_partition"),
              getattr(jax_maxvit, f"_{kind}_reverse"))
    pp, pr = (getattr(maxvit, f"_{kind}_partition"),
              getattr(maxvit, f"_{kind}_reverse"))
    want, wdims = jp(jnp.asarray(x), p)
    got, gdims = pp(torch.from_numpy(x), p)
    assert tuple(gdims) == tuple(wdims)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(pr(got, p, gdims).numpy(), x)


def test_train_mode_matches_tpudist():
    jm = jax_maxvit.MaxVit(dtype=jnp.float32, **SHORT)
    v = zoo.jax_init(jm, 32)
    pm = zoo.port_from(maxvit.MaxVit(dtype=torch.float32, **SHORT), v)
    x, y = zoo.batch(4, 32, seed=6)
    # layer 2 of 2 (rate 0.5): its MBConv and both residuals of its
    # window and grid halves.
    assert rest.check_train_mode(jm, v, pm, x, y) == 5


def test_an_indivisible_map_is_refused():
    with pytest.raises(ValueError, match="partition"):
        maxvit.MaxVit(**SHORT)(torch.zeros(1, 24, 24, 3))


def test_pth_tar_round_trip_with_tpudist():
    rest.check_pth_round_trip("maxvit_t", (
        "stem.0.0.weight", "blocks.0.layers.0.layers.MBconv.proj.1.bias",
        "blocks.2.layers.4.layers.grid_attention.attn_layer.1."
        "relative_position_index",
        "blocks.3.layers.1.layers.window_attention.mlp_layer.3.weight",
        "classifier.5.weight"))
    m = create_model("maxvit_t", device="meta")
    assert (m.stem_0_bn.epsilon, m.stem_0_bn.momentum) == (1e-3, 0.99)
