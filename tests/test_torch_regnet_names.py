"""The 14 regnet archs' parameter and buffer names map 1:1, with their
shapes, onto tpudist's flax tree, and the fused sites of a train-mode
forward equal tpudist's ``act="relu"`` BatchNorm calls (the stem, ``f_a``
and ``f_b`` of every block: 33 in regnet_y_400mf)."""

import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401

import test_torch_zoo as zoo

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("arch", [a for a in zoo.ZOO
                                  if a.startswith("regnet")])
def test_names_map_onto_tpudists_tree_and_sites_match(arch):
    zoo.check_tree_and_sites(arch)
