"""The reference's ``.pth.tar`` files in the port, against tpudist's
``compat/``, on the CPU.

- For tiny resnet18, resnext50_32x4d, wide_resnet50_2 and ViT weights
  (flax trees carried into the port by ``compat/jax_params``), the port's
  torchvision ``state_dict`` has the keys, shapes, dtypes and values of
  tpudist's ``flax_to_torch_state_dict`` of the same trees, contiguous,
  with ``num_batches_tracked`` 0; importing tpudist's gives the port the
  same weights back.
- Files: tpudist's ``restore_from_torch`` reads the port's
  ``save_reference_checkpoint`` and the port reads tpudist's, with the
  reference's four keys and ``epoch + 1``; the head-major ViT ``in_proj``
  exported into a real ``torch.nn.MultiheadAttention`` gives the port's
  attention; channels_last weights export contiguous.
- The trainer: ``--resume ref.pth.tar`` sets the start epoch and
  best_acc1 as ``tests/test_compat.py`` holds tpudist's to;
  ``--torch_checkpoints`` writes ``checkpoint.pth.tar`` (the live weights)
  and ``model_best.pth.tar`` (the EMA copy); ``--pretrained
  --pretrained-path`` of that file evaluates to the top-1 of ``--resume``
  of the msgpack file.
- ``--pretrained`` resolves an explicit file, a directory and the
  ``$TORCH_HOME`` hub cache as tpudist does, refuses an arch outside the
  four families by name, raises naming the places it searched when there
  is no file, and raises on a head of another ``--num-classes``.
"""

import contextlib
import dataclasses
import io
import os
import shutil

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

pytest.importorskip("jax")

from tpudist.compat import pretrained as jax_pretrained  # noqa: E402
from tpudist.compat import torch_checkpoint as jax_tc  # noqa: E402

from tpudist_torch import __main__ as cli  # noqa: E402
from tpudist_torch import checkpoint as ckpt  # noqa: E402
from tpudist_torch.compat import pretrained  # noqa: E402
from tpudist_torch.compat import torch_checkpoint as tc  # noqa: E402
from tpudist_torch.compat.jax_params import (jax_tree,  # noqa: E402
                                             state_dict_from_jax)
from tpudist_torch.config import Config  # noqa: E402
from tpudist_torch.models import create_model  # noqa: E402
from tpudist_torch.models.vit import (MultiHeadAttention,  # noqa: E402
                                      VisionTransformer)
from tpudist_torch.trainer import Trainer  # noqa: E402

pytestmark = pytest.mark.torch_port

# The ViT has 12 heads, as tpudist's vit_b_16 (its compat reads the head
# count from the arch).
ARCHS = ["resnet18", "resnext50_32x4d", "wide_resnet50_2", "vit_b_16"]


@pytest.fixture(autouse=True)
def _drop_run_dirs(tmp_path):
    """Full-width resnet18 checkpoints are tens of MB each: free the disk
    as each test ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@dataclasses.dataclass
class _State:
    """The fields of tpudist's TrainState its compat layer reads."""
    params: dict
    batch_stats: dict
    ema_params: object = None

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _model(arch):
    if arch == "vit_b_16":
        return VisionTransformer(8, 96, 2, 12, 128, 10, image_size=32,
                                 flash=False)
    return create_model(arch, num_classes=10, width=16)


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else
            v.detach().numpy().copy() for k, v in tree.items()}


def _random_trees(model, seed):
    """Random flax trees shaped like ``model``'s, and the model holding
    them (through ``compat/jax_params``)."""
    rng = np.random.default_rng(seed)

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else
                rng.standard_normal(v.shape).astype(np.float32)
                for k, v in tree.items()}
    params, stats = (draw(t) for t in tc.model_trees(model))
    for v in _leaves(stats):
        np.abs(v, out=v)                                # variances > 0
    model.load_state_dict(state_dict_from_jax(
        "vit" if not stats else "resnet", params, stats), strict=True)
    return params, stats


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def _assert_state_dicts_equal(got, want, ordered=True):
    assert (list(got) == list(want)) if ordered else (sorted(got)
                                                      == sorted(want))
    for k, w in want.items():
        g = got[k]
        assert g.is_contiguous(), k
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, w), k


@pytest.mark.parametrize("arch", ARCHS)
def test_export_equals_tpudists(arch):
    model = _model(arch)
    params, stats = _random_trees(model, 0)
    got = tc.export_state_dict(model, arch)
    want = jax_tc.flax_to_torch_state_dict(params, stats, arch)
    _assert_state_dicts_equal(got, want)
    if arch != "vit_b_16":
        assert "layer1.0.bn1.weight" in got and "bn1.running_var" in got
        assert int(got["bn1.num_batches_tracked"]) == 0
        assert "layer2.0.downsample.0.weight" in got
    else:
        assert got["class_token"].shape == (1, 1, 96)
        assert got["encoder.pos_embedding"].shape == (1, 17, 96)
        assert got["encoder.layers.encoder_layer_1.self_attention."
                   "in_proj_weight"].shape == (288, 96)
        assert "heads.head.weight" in got


@pytest.mark.parametrize("arch", ARCHS)
def test_import_of_tpudists_state_dict_gives_the_weights(arch):
    src = _model(arch)
    params, stats = _random_trees(src, 1)
    sd = jax_tc.flax_to_torch_state_dict(params, stats, arch)
    dst = _model(arch)
    tc.load_torch_state_dict(dst, sd, arch)
    for (n, a), (_, b) in zip(src.state_dict().items(),
                              dst.state_dict().items()):
        assert torch.equal(a, b), n
    del sd[next(iter(sd))]
    with pytest.raises(ValueError, match="missing 1 parameters"):
        tc.load_torch_state_dict(dst, sd, arch)


@pytest.mark.parametrize("writer", ["port", "tpudist"])
@pytest.mark.parametrize("arch", ["resnet18", "vit_b_16"])
def test_files_cross_between_the_packages(tmp_path, writer, arch):
    src = _model(arch)
    params, stats = _random_trees(src, 2)
    path = str(tmp_path / "checkpoint.pth.tar")
    if writer == "port":
        tc.save_reference_checkpoint(path, src, arch, epoch=4,
                                     best_acc1=12.5)
    else:
        jax_tc.save_reference_checkpoint(path, _State(params, stats), arch,
                                         epoch=4, best_acc1=12.5)
    raw = torch.load(path, map_location="cpu", weights_only=False)
    assert sorted(raw) == ["arch", "best_acc1", "epoch", "state_dict"]
    assert (raw["arch"], raw["epoch"], raw["best_acc1"]) == (arch, 5, 12.5)
    assert not os.path.exists(path + ".tmp")
    # tpudist reads it onto its state...
    state, epoch, best = jax_tc.restore_from_torch(
        _State(_zeros(params), _zeros(stats), ema_params={}), path, arch)
    assert (epoch, best) == (5, 12.5)
    for a, b in zip(_leaves(state.params), _leaves(params)):
        assert np.array_equal(np.asarray(a), b)
    assert state.ema_params["params"] is state.params
    # ...and the port onto its model and EMA copy.
    dst, ema = _model(arch), _model(arch)
    assert tc.restore_from_torch(dst, path, arch, ema=ema) == (5, 12.5)
    for (n, a), b, c in zip(src.state_dict().items(),
                            dst.state_dict().values(),
                            ema.state_dict().values()):
        assert torch.equal(a, b) and torch.equal(a, c), n
    with pytest.raises(ValueError, match=f"checkpoint is for arch '{arch}'"):
        tc.restore_from_torch(_model(arch), path, "resnet34")


def _zeros(tree):
    return {k: _zeros(v) if isinstance(v, dict) else np.zeros_like(v)
            for k, v in tree.items()}


def test_vit_in_proj_export_drives_torch_multihead_attention():
    """The head-major ↔ qkv-major permutation keeps the function: the
    exported ``in_proj``/``out_proj`` in a real ``nn.MultiheadAttention``
    give the port's attention."""
    dim, heads = 16, 4
    torch.manual_seed(0)
    mine = MultiHeadAttention(dim, heads, flash=False)
    with torch.no_grad():
        for p in mine.parameters():
            p.normal_()
    named = {f"self_attention.{k}": v for k, v in mine.state_dict().items()}
    params = _numpy(jax_tree(named))["self_attention"]
    inv = np.argsort(tc._vit_inproj_perm(dim, heads))
    mha = torch.nn.MultiheadAttention(dim, heads, batch_first=True)
    mha.load_state_dict({
        "in_proj_weight": torch.from_numpy(
            params["in_proj"]["kernel"].T[inv].copy()),
        "in_proj_bias": torch.from_numpy(params["in_proj"]["bias"][inv]),
        "out_proj.weight": torch.from_numpy(
            params["out_proj"]["kernel"].T.copy()),
        "out_proj.bias": torch.from_numpy(params["out_proj"]["bias"])})
    x = torch.randn(2, 5, dim)
    with torch.no_grad():
        want, _ = mha(x, x, x, need_weights=False)
        got = mine(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_channels_last_weights_export_contiguous(tmp_path):
    model = create_model("resnet18", num_classes=10, width=16)
    _random_trees(model, 3)
    want = tc.export_state_dict(model, "resnet18")
    model.to(memory_format=torch.channels_last)
    assert not model.conv1.weight.is_contiguous()
    path = str(tmp_path / "cl.pth.tar")
    tc.save_reference_checkpoint(path, model, "resnet18", 0, 0.0)
    got = torch.load(path, weights_only=False)["state_dict"]
    _assert_state_dicts_equal(got, want)


# -- the trainer --------------------------------------------------------------------

CLI = ["--device", "cpu", "--synthetic", "-a", "resnet18", "--num-classes",
       "4", "--image-size", "32", "-b", "16", "--synthetic-size", "32",
       "--seed", "0", "-j", "2", "-p", "4"]


def _cli(*args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(CLI + list(args)) == 0
    return buf.getvalue()


def _full_resnet_trees(seed):
    model = create_model("resnet18", num_classes=4)
    params, stats = _random_trees(model, seed)
    return model, params, stats


def test_resume_from_a_reference_file_sets_epoch_and_best(tmp_path):
    model, params, stats = _full_resnet_trees(4)
    path = str(tmp_path / "ref.pth.tar")
    jax_tc.save_reference_checkpoint(path, _State(params, stats), "resnet18",
                                     epoch=2, best_acc1=33.0)
    cfg = Config(arch="resnet18", num_classes=4, image_size=32, batch_size=16,
                 use_amp=False, seed=1, synthetic=True, epochs=3,
                 device="cpu", outpath=str(tmp_path / "out"),
                 overwrite="delete", resume=path)
    tr = Trainer(cfg)
    assert tr.start_epoch == 3                 # the reference's epoch + 1
    assert tr.best_acc1 == 33.0 and tr.global_step == 0
    assert torch.equal(tr.model.conv1.weight, model.conv1.weight)


def test_torch_checkpoints_and_pretrained_evaluate(tmp_path):
    out = str(tmp_path / "run")
    text = _cli("--epochs", "1", "--torch_checkpoints", "--model-ema-decay",
                "0.5", "--outpath", out)
    assert "best_acc1=" in text
    tree = ckpt.load_checkpoint(out)
    files = {}
    for name in ("checkpoint.pth.tar", "model_best.pth.tar"):
        files[name] = torch.load(os.path.join(out, name),
                                 weights_only=False)
        assert sorted(files[name]) == ["arch", "best_acc1", "epoch",
                                       "state_dict"]
        assert files[name]["epoch"] == 1 == tree["epoch"]
        assert files[name]["best_acc1"] == tree["best_acc1"]
    state = tree["state"]
    for name, v in (("checkpoint.pth.tar", state),
                    ("model_best.pth.tar", state["ema_params"])):
        _assert_state_dicts_equal(
            files[name]["state_dict"],
            jax_tc.flax_to_torch_state_dict(v["params"], v["batch_stats"],
                                            "resnet18"), ordered=False)
    msg = _cli("--evaluate", "--resume", os.path.join(out, ckpt.CKPT_NAME),
               "--outpath", str(tmp_path / "e1"))
    pth = _cli("--evaluate", "--pretrained", "--pretrained-path",
               os.path.join(out, "checkpoint.pth.tar"), "--outpath",
               str(tmp_path / "e2"))
    assert (f"=> using pre-trained model 'resnet18' (from "
            f"{out}/checkpoint.pth.tar)") in pth
    top1 = [ln for t in (msg, pth) for ln in t.splitlines()
            if ln.startswith("||==> Val: Epoch[-1]")]
    assert len(top1) == 2 and top1[0] == top1[1]


@pytest.fixture
def hub(tmp_path, monkeypatch):
    """An empty ``$TORCH_HOME`` and no ``$TPUDIST_PRETRAINED_DIR``."""
    monkeypatch.delenv("TPUDIST_PRETRAINED_DIR", raising=False)
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch_home"))
    d = tmp_path / "torch_home" / "hub" / "checkpoints"
    d.mkdir(parents=True)
    return d


@pytest.mark.parametrize("where", ["file", "directory", "hub",
                                   "pretrained_dir"])
def test_pretrained_resolves_as_tpudist(tmp_path, hub, monkeypatch, where):
    _, params, stats = _full_resnet_trees(5)
    d = {"file": tmp_path, "directory": tmp_path / "w", "hub": hub,
         "pretrained_dir": tmp_path / "env"}[where]
    d.mkdir(exist_ok=True)
    path = str(d / "resnet18-deadbeef.pth")
    torch.save(jax_tc.flax_to_torch_state_dict(params, stats, "resnet18"),
               path)                               # a bare state_dict
    explicit = {"file": path, "directory": str(d)}.get(where, "")
    if where == "pretrained_dir":
        monkeypatch.setenv("TPUDIST_PRETRAINED_DIR", str(d))
    got = pretrained.resolve_pretrained_path("resnet18", explicit)
    assert got == path == jax_pretrained.resolve_pretrained_path(
        "resnet18", explicit)
    cfg = Config(arch="resnet18", num_classes=4, image_size=32,
                 batch_size=16, synthetic=True, device="cpu",
                 outpath=str(tmp_path / "out"), overwrite="delete",
                 pretrained=True, pretrained_path=explicit,
                 model_ema_decay=0.5)
    tr = Trainer(cfg)
    want = state_dict_from_jax("resnet18", params, stats)
    for n, t in tr.model.state_dict().items():
        assert torch.equal(t, want[n]), n
        assert torch.equal(tr.ema.state_dict()[n], want[n]), n


def test_pretrained_without_a_file_names_every_place_searched(tmp_path, hub,
                                                              capsys):
    with pytest.raises(FileNotFoundError) as e:
        cli.main(CLI + ["--pretrained", "--outpath", str(tmp_path / "o")])
    assert "no pretrained checkpoint for 'resnet18' found; searched " \
        f"['{hub}']" in str(e.value)
    with pytest.raises(FileNotFoundError, match="does not exist"):
        pretrained.resolve_pretrained_path("resnet18",
                                           str(tmp_path / "nowhere"))


def test_pretrained_refuses_other_families_and_heads(tmp_path, hub):
    # Every family of tpudist's that runs on one card is covered since the
    # rest of the zoo was ported; vit_moe and vit_pipe have no torchvision
    # counterpart.
    with pytest.raises(ValueError, match="'vit_moe_b_16' is a "
                       "tpudist-native architecture"):
        pretrained.resolve_pretrained_path("vit_moe_b_16")
    with pytest.raises(ValueError, match="does not support arch 'lenet5'"):
        pretrained.resolve_pretrained_path("lenet5")
    src = create_model("resnet18", num_classes=1000)
    params, stats = _random_trees(src, 6)
    path = str(hub / "resnet18-f37072fd.pth")
    torch.save(jax_tc.flax_to_torch_state_dict(params, stats, "resnet18"),
               path)
    with pytest.raises(ValueError, match="shape mismatch for 'fc.weight'"):
        pretrained.load_pretrained(create_model("resnet18", num_classes=4),
                                   "resnet18", path)
    with pytest.raises(ValueError, match="--pretrained-path x without "
                       "--pretrained"):
        cli.main(CLI + ["--pretrained-path", "x", "--outpath",
                        str(tmp_path / "o")])
