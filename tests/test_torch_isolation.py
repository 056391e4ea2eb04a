"""The port stands alone and never falls back.

- Every module of ``tpudist_torch`` and ``chip_smoke`` imports with
  ``jax*``, ``flax*``, ``optax`` and ``tpudist``/``tpudist.*`` refused by an
  import hook (``tpudist_torch`` itself stays importable).
- Without a CUDA card, ``resolve_device()`` and the serve CLI without
  ``--device cpu`` fail loudly instead of running on the CPU.
- ``flash_attention`` on a CPU tensor runs the plain version and counts no
  kernel launch.
"""

import os
import subprocess
import sys

import pytest
import torch

from tpudist_torch._device import resolve_device
from tpudist_torch.ops import flash_attention as fa
from tpudist_torch.serve import __main__ as serve_cli

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HOOK = r"""
import importlib, pkgutil, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root.startswith(("jax", "flax")) or root in ("optax", "tpudist"):
            raise ImportError(f"the port must not import {name}")
        return None

sys.meta_path.insert(0, Refuse())
import tpudist_torch
mods = [m.name for m in pkgutil.walk_packages(tpudist_torch.__path__,
                                              "tpudist_torch.")]
for name in mods:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0].startswith(("jax", "flax"))
                or m.split(".")[0] in ("optax", "tpudist"))
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


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    q = torch.randn(1, 9, 2, 32)
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_attention_fwd(q, q, q)
    o_ref, lse_ref = fa.flash_attention_reference(q, q, q)
    assert fa.LAUNCHES == before
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    assert lse.shape == (1, 2, 9) and lse.dtype == torch.float32
