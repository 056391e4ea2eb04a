"""The densenet and mobilenet archs' parameter and buffer names map 1:1,
with their shapes, onto tpudist's flax tree (an abstract init), and the
fused sites of a train-mode forward equal tpudist's ``act="relu"``
BatchNorm calls: 121 in densenet121 (norm0, both norms of its 58 dense
layers, 3 transitions, norm5); 11 in mobilenet_v3_large (its ReLU
blocks), none in mobilenet_v2 (relu6 throughout) and none where a
hardswish follows a plain BatchNorm. The vggs are
``tests/test_torch_zoo.py``'s, googlenet and inception_v3 their own
files', the regnets ``tests/test_torch_regnet_names.py``'s."""

import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401

import test_torch_zoo as zoo

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("arch", [a for a in zoo.ZOO if a.startswith(
    ("densenet", "mobilenet"))])
def test_names_map_onto_tpudists_tree_and_sites_match(arch):
    zoo.check_tree_and_sites(arch)
