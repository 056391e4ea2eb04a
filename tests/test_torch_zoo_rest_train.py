"""One arch of each new family trains a step through the trainer on the
CPU (``--device cpu --fused-bn on``, 4 classes, batch 2; 32 px, alexnet
64, maxvit_t 224, its canonical input): no BatchNorm asks for the fused
epilogue (the step and validation call no fused ``Function``), dropout
and stochastic depth are live in the step, and the loss is finite. The
dispatch logs the plain epilogue with its reason (no fused-eligible
site, or no BatchNorm) and records no workload, and no attention
dispatch runs (swin's and maxvit's biased attention is plain, as
tpudist's)."""

import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401

import test_torch_zoo as zoo

pytestmark = pytest.mark.torch_port

_two_torch_threads = zoo._two_torch_threads

ARCHS = {"alexnet": 64, "squeezenet1_0": 32, "mnasnet0_5": 32,
         "shufflenet_v2_x0_5": 32, "efficientnet_b0": 32,
         "efficientnet_v2_s": 32, "convnext_tiny": 32, "swin_t": 32,
         "swin_v2_t": 32, "maxvit_t": 224}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_arch_trains_a_step(arch, tmp_path):
    tr = zoo.train_tiny(arch, tmp_path, size=ARCHS[arch])
    dec = tr.fused_norm_decision
    assert dec["kernel"] == "plain" and dec["n_sites"] == 0, dec
    assert dec["source"] == ("no_sites" if tr.has_bn else "ineligible")
    assert not tr.has_attention and tr.attention_decision is None
