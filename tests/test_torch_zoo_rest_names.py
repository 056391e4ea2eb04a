"""The parameter and buffer names of one arch of each new family map
1:1, with their shapes, onto tpudist's flax tree (an abstract init):
alexnet, squeezenet1_0/1_1, mnasnet0_5, shufflenet_v2_x0_5,
efficientnet_b0 and v2_s, convnext_tiny, swin_t, swin_v2_t and maxvit_t
(at 224 px, its canonical input). The other archs of each family build
from the same blocks and tables; their parameter counts are
``tests/test_torch_zoo_rest.py``'s."""

import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tpudist.models import create_model as jax_create  # noqa: E402

import test_torch_zoo as zoo  # noqa: E402
import test_torch_zoo_rest as rest  # noqa: E402

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("arch", [
    "alexnet", "squeezenet1_0", "squeezenet1_1", "mnasnet0_5",
    "shufflenet_v2_x0_5", "efficientnet_b0", "efficientnet_v2_s",
    "convnext_tiny", "swin_t", "swin_v2_t", "maxvit_t"])
def test_names_map_onto_tpudists_tree(arch):
    jm = jax_create(arch, num_classes=1000)
    size = rest.SIZE.get(arch, 32)
    v = jax.eval_shape(lambda r, x: jm.init(r, x, train=False),
                       jax.random.PRNGKey(0), jnp.ones((1, size, size, 3)))
    got_p, got_s = zoo.port_trees(arch)
    assert got_p == zoo.flat_shapes(v["params"])
    assert got_s == zoo.flat_shapes(v.get("batch_stats", {}))
