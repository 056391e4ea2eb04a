"""Every regnet arch trains a step through the trainer on the CPU
(``--device cpu --fused-bn on``, 4 classes, 32 px, batch 2): the step
runs the fused epilogue's forward and backward once at each site whose
``(rows, C)`` the dispatch may fuse (8 rows or more, as tpudist), the
loss is finite, and validation runs no fused epilogue."""

import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401

import test_torch_zoo as zoo

pytestmark = pytest.mark.torch_port

_two_torch_threads = zoo._two_torch_threads


@pytest.mark.parametrize("arch", [a for a in zoo.ZOO
                                  if a.startswith("regnet")])
def test_regnet_trains_a_step(arch, tmp_path):
    zoo.train_tiny(arch, tmp_path)
