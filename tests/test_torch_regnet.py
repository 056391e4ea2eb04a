"""The port's RegNet against tpudist's, on the CPU.

- A short RegNetY and RegNetX (depth 3, w_0 16, w_a 8, w_m 2, group width
  8: stages of 16 and 32 channels, grouped 3x3s; with and without SE),
  32 px, 10 classes, batch 4, initialised in flax and carried across by
  ``compat/jax_params``: train-mode loss, logits, updated running
  statistics and every gradient within 1e-4 (of ``1 + max|ref|``, and
  within 6e-4 of its own L2 norm: ``zoo.close_grads``),
  through the fused ``Function``s (the kernels' plain bodies on the CPU)
  and the plain epilogue. ``f_c``, ``proj`` and the ``relu(x + y)`` after
  them stay unfused, as in tpudist.
- ``block_params`` equals tpudist's for all 14 variants.
- torchvision's ``.pth.tar`` for regnet_y_400mf: the port's file is
  tpudist's for the same weights (``trunk_output.blockS.blockS-I.f.a.0``),
  and tpudist's loads into the port.
- The names and sites of the 14 archs are
  ``tests/test_torch_regnet_names.py``'s; each trains a step in
  ``tests/test_torch_regnet_train.py``.
"""

import functools

import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tpudist.compat import torch_checkpoint as jax_tc  # noqa: E402
from tpudist.models import regnet as jax_rg  # noqa: E402
from tpudist_torch.compat import torch_checkpoint as tc  # noqa: E402
from tpudist_torch.models import create_model  # noqa: E402
from tpudist_torch.models import regnet as rg  # noqa: E402

import test_torch_zoo as zoo  # noqa: E402

pytestmark = pytest.mark.torch_port

_two_torch_threads = zoo._two_torch_threads
_plain_jax_epilogue = zoo._plain_jax_epilogue

SHORT = (3, 16, 8.0, 2.0, 8)


@functools.lru_cache(maxsize=None)
def _init(se):
    jm = jax_rg.RegNet(*SHORT, se_ratio=se, num_classes=10,
                       dtype=jnp.float32)
    return jm, zoo.jax_init(jm, 32)


@pytest.mark.parametrize("se,fused", [(0.25, True), (0.25, False),
                                      (0.0, True)])
def test_train_mode_matches_tpudist(se, fused):
    jm, v = _init(se)
    pm = zoo.port_from(rg.RegNet(*SHORT, se, 10, dtype=torch.float32,
                                 fused_bn=fused), v)
    assert [len(rg.block_params(*SHORT)[1])] == [2]
    x, y = zoo.batch(4, 32)
    zoo.check_train_mode(jm, v, pm, x, y)


@pytest.mark.parametrize("arch", sorted(rg._VARIANTS))
def test_block_params_equal_tpudists(arch):
    depth, w_0, w_a, w_m, gw, _ = rg._VARIANTS[arch]
    assert rg._VARIANTS[arch] == jax_rg._VARIANTS[arch]
    assert rg.block_params(depth, w_0, w_a, w_m, gw) == \
        jax_rg.block_params(depth, w_0, w_a, w_m, gw)


def test_pth_tar_round_trip_with_tpudist():
    jm = jax_rg.regnet_y_400mf(num_classes=10)
    v = zoo.random_variables(jm, 32, seed=2)
    pm = zoo.port_from(create_model("regnet_y_400mf", num_classes=10), v)
    mine = tc.export_state_dict(pm, "regnet_y_400mf")
    theirs = jax_tc.flax_to_torch_state_dict(v["params"], v["batch_stats"],
                                             "regnet_y_400mf")
    assert set(mine) == set(theirs)
    assert all(torch.equal(mine[k], theirs[k]) for k in theirs)
    assert {"stem.0.weight", "trunk_output.block1.block1-0.f.a.0.weight",
            "trunk_output.block1.block1-0.f.se.fc1.bias",
            "trunk_output.block2.block2-0.proj.1.running_mean"} <= set(mine)
    fresh = create_model("regnet_y_400mf", num_classes=10)
    tc.load_torch_state_dict(fresh, theirs, "regnet_y_400mf")
    for k, t in pm.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], t), k
