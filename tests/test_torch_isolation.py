"""The port stands alone and never falls back.

- Every module of ``tpudist_torch`` and ``chip_smoke`` imports with
  ``jax*``, ``flax*``, ``optax``, ``msgpack`` (absent on the card) and
  ``tpudist``/``tpudist.*`` refused by an import hook (``tpudist_torch``
  itself stays importable), among them ``faults``, ``compat/``'s
  ``torch_checkpoint`` and ``pretrained`` and the model modules of the
  rest of the zoo (a train-mode forward of swin_v2_t, maxvit_t,
  efficientnet_b0 and convnext_tiny runs there); a checkpoint round trip, an
  armed fault spec, a ``.pth.tar`` round trip and the ImageFolder
  pipeline (its native and PIL paths, with auto-augment), a dispatch
  decision and an accumulated, mixed train step run there.
- Without a CUDA card, ``resolve_device()`` and the serve CLI without
  ``--device cpu`` fail loudly instead of running on the CPU.
- ``flash_attention`` on a CPU tensor runs the plain version and counts no
  kernel launch.
"""

import os
import subprocess
import sys

import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

from tpudist_torch._device import resolve_device
from tpudist_torch.ops import flash_attention as fa
from tpudist_torch.serve import __main__ as serve_cli

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HOOK = r"""
import importlib, os, pkgutil, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root.startswith(("jax", "flax")) or root in ("optax", "tpudist",
                                                        "msgpack"):
            raise ImportError(f"the port must not import {name}")
        return None

sys.meta_path.insert(0, Refuse())
import tpudist_torch
mods = [m.name for m in pkgutil.walk_packages(tpudist_torch.__path__,
                                              "tpudist_torch.")]
for name in mods:
    importlib.import_module(name)
for name in ("tpudist_torch.faults", "tpudist_torch.compat.torch_checkpoint",
             "tpudist_torch.compat.pretrained", "tpudist_torch.ops.dispatch",
             "tpudist_torch.ops.attention_dispatch",
             "tpudist_torch.ops.norm_dispatch", "tpudist_torch.ops.mixup",
             "tpudist_torch.models.alexnet", "tpudist_torch.models.squeezenet",
             "tpudist_torch.models.mnasnet", "tpudist_torch.models.shufflenet",
             "tpudist_torch.models.efficientnet",
             "tpudist_torch.models.convnext", "tpudist_torch.models.swin",
             "tpudist_torch.models.maxvit", "tpudist_torch.obs.server",
             "tpudist_torch.obs.tsdb", "tpudist_torch.obs.dashboard",
             "tpudist_torch.utils.profiling"):
    assert name in mods, name
import chip_smoke
import tempfile
import numpy as np
from tpudist_torch import checkpoint
with tempfile.TemporaryDirectory() as d:
    checkpoint.save_checkpoint({"epoch": 1, "w": np.ones(3, np.float32)},
                               True, d, keep=1)
    assert checkpoint.load_checkpoint(d)["w"].tolist() == [1.0, 1.0, 1.0]
from tpudist_torch import faults
faults.configure("decode_fail:p=0.5,fails=1;checkpoint_corrupt@step=3")
assert faults.classify_exit(75).startswith("preempted")
faults.configure("")
from tpudist_torch.compat import torch_checkpoint
from tpudist_torch.models import create_model
with tempfile.TemporaryDirectory() as d:
    path = torch_checkpoint.save_reference_checkpoint(
        os.path.join(d, "c.pth.tar"), create_model("resnet18", width=8),
        "resnet18", 0, 1.0)
    assert torch_checkpoint.restore_from_torch(
        create_model("resnet18", width=8), path, "resnet18") == (1, 1.0)
import torch
from tpudist_torch.config import Config
from tpudist_torch.ops import dispatch, mixup
from tpudist_torch.train import make_optimizer, make_train_step
with tempfile.TemporaryDirectory() as d:
    dec = dispatch.decide("c", "k", mode="auto", names=("a", "b"),
                          kernel_rev=lambda: 1, measure_pair=lambda: (1, 2),
                          cache_dir=d, platform="cuda", device_kind="card")
    assert dec["kernel"] == "a" and dispatch.lookup(
        "c", "k", candidate="a", kernel_rev=lambda: 1, cache_dir=d,
        platform="cuda", device_kind="card")
for arch, px in (("swin_v2_t", 32), ("maxvit_t", 224),
                 ("efficientnet_b0", 32), ("convnext_tiny", 32)):
    m = create_model(arch, device="meta")
    assert m.train()(torch.zeros(1, px, px, 3, device="meta")).shape \
        == (1, 1000)
model = create_model("resnet18", width=8, num_classes=4)
model.reset_parameters(torch.Generator().manual_seed(0))
cfg = Config(num_classes=4, batch_size=4, accum_steps=2, mixup_alpha=0.2,
             cutmix_alpha=1.0).finalize(1)
step = make_train_step(model, make_optimizer(model, cfg), cfg)
m = step(torch.randn(4, 16, 16, 3), torch.tensor([0, 1, 2, 3]), 0.1)
assert torch.isfinite(m["loss"]), m
from PIL import Image
from tpudist_torch.data import build_train_val_loaders
with tempfile.TemporaryDirectory() as d:
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        for c in ("a", "b"):
            os.makedirs(os.path.join(d, split, c))
            for i in range(3):
                Image.fromarray(rng.integers(0, 256, (40, 48, 3), np.uint8)
                                ).save(os.path.join(d, split, c, f"{i}.jpg"))
    for aa in ("", "ra"):
        for use_native in (True, False):
            cfg = Config(data=d, image_size=16, val_resize=20, batch_size=2,
                         workers=2, auto_augment=aa).finalize(1)
            for loader in build_train_val_loaders(cfg, use_native=use_native):
                images, labels = next(iter(loader))
                assert images.shape == (2, 16, 16, 3), images.shape
from tpudist_torch import telemetry
from tpudist_torch.obs import dashboard, server, tsdb
from tpudist_torch.utils import profiling
with tempfile.TemporaryDirectory() as d:
    tel = telemetry.Telemetry(d, rank=0, max_mb=0.0005)
    reg = server.MetricsRegistry(rank=0)
    tel.add_sink(reg.observe)
    for s in range(8):
        tel.step(step=s, epoch=0, data_s=0.0, h2d_s=0.0, compute_s=0.01,
                 drain_s=0.0, step_s=0.02)
    tel.close()
    assert "tpudist_steps_total 8" in reg.render()
    assert os.path.exists(tel.rotated_path())
    fleet = server.FleetMetrics(d, 1)
    fleet.refresh(attempt=0)
    rec = tsdb.FleetSeriesRecorder(d)
    rec.sample(fleet, telemetry.read_heartbeats(telemetry.heartbeat_dir(d)))
    rec.close()
    assert "fleet" in dashboard.render_history_file(
        live_path=tsdb.latest_path(d))
    prof = profiling.StepProfiler("1:2", d, device="cpu")
    for s in range(3):
        prof.step(s)
        torch.ones(2).sum()
    prof.close()
    assert os.listdir(prof.logdir) == ["steps1-1.pt.trace.json"]
leaked = sorted(m for m in sys.modules
                if m.split(".")[0].startswith(("jax", "flax"))
                or m.split(".")[0] in ("optax", "tpudist", "msgpack"))
assert not leaked, leaked
print("IMPORTED", len(mods))
"""


def test_port_imports_nothing_of_jax_or_tpudist():
    r = subprocess.run([sys.executable, "-c", _HOOK], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    n = int(r.stdout.split("IMPORTED")[-1])
    assert n >= 15, r.stdout


def test_resolve_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_cli_without_device_cpu_fails_loudly(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_cli.main(["-a", "vit_b_32", "--image-size", "64",
                        "--buckets", "1"])


def test_chip_smoke_refuses_without_a_card(monkeypatch, capsys):
    import chip_smoke
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""


def test_chip_smoke_alone_in_a_directory_names_what_it_misses(tmp_path):
    """Without the checkout beside it the script prints one line naming
    the port's sources and exits non-zero, before it imports torch."""
    import shutil
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=60,
                       env={**os.environ, "PYTHONPATH": ""})
    assert r.returncode != 0 and r.stdout == ""
    lines = r.stderr.splitlines()
    assert len(lines) == 1, r.stderr
    assert "tpudist_torch/ and tpudist_torch/ops/csrc/" in lines[0]


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    q = torch.randn(1, 9, 2, 32)
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_attention_fwd(q, q, q)
    o_ref, lse_ref = fa.flash_attention_reference(q, q, q)
    assert fa.LAUNCHES == before
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    assert lse.shape == (1, 2, 9) and lse.dtype == torch.float32
