"""``python -m tpudist_torch.serve`` serves the six BatchNorm+ReLU conv
families on the CPU (``--device cpu``, 4 classes, tiny load): one arch
of each (vgg11_bn, densenet121, googlenet, inception_v3 at 75 px,
mobilenet_v3_small, regnet_y_400mf) answers every request, eval-mode
BatchNorm runs the plain epilogue (no fused ``Function`` is called), and
the served logits of a bucket equal the model's own eval forward of the
same images bit for bit (f32; inception_v3 without its aux head, which
eval mode never runs)."""

import json

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

from tpudist_torch.ops import fused_norm as fn
from tpudist_torch.serve import __main__ as serve_cli
from tpudist_torch.serve.engine import ServeEngine
from tpudist_torch.serve.export import load_serve_state

pytestmark = pytest.mark.torch_port

SERVED = {"vgg11_bn": 32, "densenet121": 32, "googlenet": 32,
          "inception_v3": 75, "mobilenet_v3_small": 32,
          "regnet_y_400mf": 32}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fused_calls(monkeypatch):
    calls = []
    real = fn.bn_act_fwd
    monkeypatch.setattr(fn, "bn_act_fwd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("arch", list(SERVED))
def test_cli_serves_the_family(arch, tmp_path, capsys, fused_calls):
    size = SERVED[arch]
    rc = serve_cli.main(["--device", "cpu", "-a", arch, "--num-classes",
                         "4", "--image-size", str(size), "--buckets", "1,2",
                         "--load-rate", "10", "--load-duration", "0.3",
                         "--telemetry", "--outpath", str(tmp_path)])
    assert rc == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("SERVE_SUMMARY ")]
    summary = json.loads(line[-1].split(" ", 1)[1])
    assert summary["arch"] == arch
    assert summary["n_requests"] >= 1 and summary["n_errors"] == 0
    assert not fused_calls


@pytest.mark.parametrize("arch", list(SERVED))
def test_served_logits_are_the_models_eval_forward(arch, fused_calls):
    size = SERVED[arch]
    model = load_serve_state(arch, num_classes=4, image_size=size,
                             dtype=torch.float32, device="cpu", seed=1)
    if arch == "inception_v3":
        assert model.aux_logits
    images = np.random.default_rng(0).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    got = ServeEngine(model, image_size=size, buckets=(2,),
                      device="cpu").infer(images)
    with torch.inference_mode():
        want = model(torch.from_numpy(images)).numpy()
    assert got.shape == (2, 4)
    np.testing.assert_array_equal(got, want)
    assert not fused_calls
