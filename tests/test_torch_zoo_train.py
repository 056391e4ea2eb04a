"""Every arch of the BatchNorm+ReLU conv families but regnet (vgg,
densenet, googlenet, mobilenet; inception_v3 is in
``tests/test_torch_inception.py``, at 299 px) trains a step through the
trainer on the CPU (``--device cpu --fused-bn on``, 4 classes, 32 px,
batch 2; densenet at batch 8, so that the 1x1 maps of its last block
normalise 8 rows): the step runs the fused epilogue's forward and
backward once at each site whose ``(rows, C)`` the dispatch may fuse (8
rows or more, as tpudist), the plain vggs and mobilenet_v2 at none; the
loss is finite, and validation runs no fused epilogue. The regnets are
``tests/test_torch_regnet.py``'s.
"""

import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401

import test_torch_zoo as zoo

pytestmark = pytest.mark.torch_port

_two_torch_threads = zoo._two_torch_threads

ARCHS = [a for a in zoo.ZOO if a.startswith(("vgg", "densenet", "googlenet",
                                             "mobilenet"))]


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_trains_a_step(arch, tmp_path):
    zoo.train_tiny(arch, tmp_path,
                   batch=8 if arch.startswith("densenet") else 2)
