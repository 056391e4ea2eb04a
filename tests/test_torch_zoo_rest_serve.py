"""The rest of the one-card zoo serves on the CPU: one arch of each
family through ``load_serve_state`` (``--device cpu``, 4 classes, fresh
seed-1 weights, f32) gives logits equal, bit for bit, to the model's own
eval forward of the same images (dropout and stochastic depth idle,
BatchNorm on its running statistics), and launches no kernel; one conv
net and one attention net through ``python -m tpudist_torch.serve``
answer every request."""

import json

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

from tpudist_torch.ops import flash_attention as fa
from tpudist_torch.ops import fused_norm as fn
from tpudist_torch.serve import __main__ as serve_cli
from tpudist_torch.serve.engine import ServeEngine
from tpudist_torch.serve.export import load_serve_state

pytestmark = pytest.mark.torch_port

SERVED = {"alexnet": 64, "squeezenet1_1": 32, "mnasnet0_5": 32,
          "shufflenet_v2_x0_5": 32, "efficientnet_b0": 32,
          "efficientnet_v2_s": 32, "convnext_tiny": 32, "swin_t": 32,
          "swin_v2_t": 32, "maxvit_t": 224}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", list(SERVED))
def test_served_logits_are_the_models_eval_forward(arch):
    size = SERVED[arch]
    model = load_serve_state(arch, num_classes=4, image_size=size,
                             dtype=torch.float32, device="cpu", seed=1)
    assert not model.training
    images = np.random.default_rng(0).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    before = {**fn.LAUNCHES, **fa.LAUNCHES}
    got = ServeEngine(model, image_size=size, buckets=(2,),
                      device="cpu").infer(images)
    with torch.inference_mode():
        want = model(torch.from_numpy(images)).numpy()
    assert got.shape == (2, 4) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    assert {**fn.LAUNCHES, **fa.LAUNCHES} == before


@pytest.mark.parametrize("arch", ["efficientnet_b0", "swin_v2_t"])
def test_cli_serves_the_family(arch, tmp_path, capsys):
    rc = serve_cli.main(["--device", "cpu", "-a", arch, "--num-classes",
                         "4", "--image-size", "32", "--buckets", "1,2",
                         "--load-rate", "10", "--load-duration", "0.3",
                         "--outpath", str(tmp_path)])
    assert rc == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("SERVE_SUMMARY ")]
    summary = json.loads(line[-1].split(" ", 1)[1])
    assert summary["arch"] == arch
    assert summary["n_requests"] >= 1 and summary["n_errors"] == 0
