"""``python -m tpudist_torch`` on the CPU (``--device cpu``, tiny sizes).

- The CLI trains resnet18 at 32 px for two epochs and prints tpudist's
  console lines and ``best_acc1=``; every BN+ReLU epilogue of a train step
  goes through the fused ``Function``s (17 sites), and none in
  validation.
- It trains ViT-B/16 (at 32 px) with ``--flash on --optimizer adamw``:
  every attention of a train step goes through the flash ``Function``
  (12 forwards and 12 backwards a step), validation runs the forward
  alone, and the dispatch lines and events say so.
- Its events validate under tpudist's schema, and tpudist's own
  ``summarize`` reads the run.
- The sampler order, the loader's batches and the synthetic data equal
  tpudist's.
- The flag surface is tpudist's (names and defaults), every unsupported
  flag is refused by name, and without ``--device cpu`` the CLI fails
  loudly here (no card).
"""

import json
import os

import numpy as np
import pytest
import torch

from tpudist_torch import __main__ as cli
from tpudist_torch import config as port_config
from tpudist_torch.data import build_train_val_loaders
from tpudist_torch.data.sampler import ShardedSampler
from tpudist_torch.data.synthetic import SyntheticDataset
from tpudist_torch.ops import flash_attention as fa
from tpudist_torch.ops import fused_norm as fn

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tiny shapes gain nothing from more threads, and the suite runs
    several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

TINY = ["--device", "cpu", "--synthetic", "-a", "resnet18",
        "--num-classes", "8", "--image-size", "32", "-b", "16",
        "--epochs", "2", "--step", "1", "-p", "2"]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("run") / "out")
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = fn.bn_act_fwd, fn.bn_act_bwd

    def fwd(*a, **k):
        calls["fwd"] += 1
        return real_fwd(*a, **k)

    def bwd(*a, **k):
        calls["bwd"] += 1
        return real_bwd(*a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(fn, "bn_act_fwd", fwd)
    mp.setattr(fn, "bn_act_bwd", bwd)
    from contextlib import redirect_stdout
    from io import StringIO
    buf = StringIO()
    try:
        with redirect_stdout(buf):
            rc = cli.main(TINY + ["--synthetic-size", "64", "--telemetry",
                                  "--seed", "0", "--outpath", out])
    finally:
        mp.undo()
    return rc, buf.getvalue(), out, calls


def test_cli_trains_and_prints_the_console_lines(cli_run):
    rc, text, out, calls = cli_run
    assert rc == 0
    lines = text.splitlines()
    assert lines[-1].startswith("best_acc1=")
    assert any(ln.startswith("Epoch[0]:\t[0/4]") for ln in lines)
    assert any(ln.startswith("||==> Train: Epoch[1]") for ln in lines)
    assert any(ln.startswith("||==> Val: Epoch[1]") for ln in lines)
    assert ("=> fused-norm dispatch: plain epilogue (mode on, forced; the "
            "CPU runs each kernel's plain body)" in lines)
    assert not any("kernels launched" in ln for ln in lines)   # no card
    assert "self.optimizer={'lr': 0.010000000000000002}" in lines
    # 2 epochs x 4 train steps x 17 sites, each direction; none in eval.
    assert calls == {"fwd": 2 * 4 * 17, "bwd": 2 * 4 * 17}
    for name in ("experiment.log", "settings.log"):
        assert os.path.getsize(os.path.join(out, name)) > 0
    with open(os.path.join(out, "settings.log")) as f:
        assert "fused_bn: on\n" in f.read()


def test_cli_plain_epilogue_f32_without_the_overlaps(tmp_path, capsys):
    """--fused-bn off, f32, no device prefetch, no async drain: the other
    branches of the loop run the same schedule and launch no fused
    epilogue."""
    fn.reset_counts()
    rc = cli.main(TINY + ["--epochs", "1", "--synthetic-size", "32",
                          "--fused-bn", "off", "--no-use_amp",
                          "--no-device_prefetch", "--no-async_drain",
                          "--outpath", str(tmp_path / "o")])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0 and lines[-1].startswith("best_acc1=")
    assert "=> fused-norm dispatch: plain epilogue (mode off, forced)" in lines
    assert any(ln.startswith("Epoch[0]:\t[0/2]") and "Loss 0.0000e+00"
               not in ln for ln in lines)      # no lag: step 0 is drained
    assert sum(fn.LAUNCHES.values()) == 0


def test_cli_trains_vit_through_flash_with_adamw(tmp_path, capsys,
                                                monkeypatch):
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = fa.flash_attention_fwd, fa.flash_attention_bwd

    def fwd(*a, **k):
        calls["fwd"] += 1
        return real_fwd(*a, **k)

    def bwd(*a, **k):
        calls["bwd"] += 1
        return real_bwd(*a, **k)

    monkeypatch.setattr(fa, "flash_attention_fwd", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", bwd)
    fa.reset_counts()
    out = tmp_path / "vit"
    rc = cli.main(["--device", "cpu", "--synthetic", "-a", "vit_b_16",
                   "--image-size", "32", "--num-classes", "10", "-b", "4",
                   "--epochs", "1", "--synthetic-size", "8", "-p", "1",
                   "--flash", "on", "--optimizer", "adamw", "--lr", "1e-3",
                   "--weight-decay", "0.05", "--telemetry", "--seed", "0",
                   "--outpath", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0 and lines[-1].startswith("best_acc1=")
    assert ("=> attention dispatch: flash attention (mode on, forced: the "
            "CPU runs each kernel's plain body)" in lines)
    assert ("=> fused-norm dispatch: plain epilogue (mode on, ineligible; "
            "vit_b_16 has no BatchNorm)" in lines)
    train_loss = next(ln for ln in lines if ln.startswith("||==> Train"))
    assert np.isfinite(float(train_loss.split("Loss ")[1].split()[0]))
    # 2 train steps and 1 validation batch of 12 attention layers.
    assert calls == {"fwd": 12 * 3, "bwd": 12 * 2}
    assert fa.LAUNCHES == dict.fromkeys(fa.KERNELS, 0)    # no card
    events = [json.loads(ln) for ln in open(out / "events.0.jsonl")]
    disp = next(e for e in events if e["type"] == "attention_dispatch")
    assert (disp["kernel"], disp["mode"], disp["source"]) == ("flash", "on",
                                                              "forced")
    assert [e["type"] for e in events].count("step") == 2


def test_events_validate_and_tpudist_summarize_reads_them(cli_run, capsys):
    pytest.importorskip("jax")
    from tpudist import summarize
    from tpudist import telemetry as jax_telemetry
    _, _, out, _ = cli_run
    with open(os.path.join(out, "events.0.jsonl")) as f:
        events = [json.loads(ln) for ln in f]
    for ev in events:
        jax_telemetry.validate_event(ev)
    types = [e["type"] for e in events]
    assert types[0] == "run_start" and types[-1] == "run_end"
    assert types.count("step") == 8 and types.count("epoch") == 2
    assert types.count("eval") == 2
    disp = next(e for e in events if e["type"] == "fused_norm_dispatch")
    assert (disp["kernel"], disp["mode"], disp["source"]) == ("plain", "on",
                                                              "forced")
    end = events[-1]
    assert end["steps"] == 8 and end["best_acc1"] >= 0
    assert summarize.main([out]) == 0
    assert "step" in capsys.readouterr().out.lower()


def test_sampler_loader_and_data_equal_tpudists():
    pytest.importorskip("jax")
    from tpudist.data.sampler import ShardedSampler as JaxSampler
    from tpudist.data.synthetic import SyntheticDataset as JaxSynthetic
    for n, world, shuffle, seed in ((100, 1, True, 0), (103, 4, True, 7),
                                    (50, 3, False, 1)):
        for rank in range(world):
            a = ShardedSampler(n, world, rank, shuffle=shuffle, seed=seed)
            b = JaxSampler(n, world, rank, shuffle=shuffle, seed=seed)
            for epoch in (0, 3):
                a.set_epoch(epoch)
                b.set_epoch(epoch)
                np.testing.assert_array_equal(a.indices(), b.indices())
                assert len(a) == len(b)
    img, label = SyntheticDataset(8, 16, 10, seed=3)[5]
    jimg, jlabel = JaxSynthetic(8, 16, 10, seed=3)[5]
    np.testing.assert_array_equal(img, jimg)
    assert label == jlabel

    cfg = port_config.from_args(TINY + ["--synthetic-size", "48",
                                        "--seed", "2"]).finalize(1)
    train, val = build_train_val_loaders(cfg)
    train.set_epoch(1)
    batches = list(train)
    assert len(batches) == len(train) == 3 and len(val) == 2
    order = ShardedSampler(48, 1, 0, seed=2)
    order.set_epoch(1)
    want = [SyntheticDataset(48, 32, 8, seed=2)[int(i)][1]
            for i in order.indices()[:16]]
    assert batches[0][1].tolist() == want


def test_flag_surface_is_tpudists():
    pytest.importorskip("jax")
    from tpudist.config import build_parser as jax_parser
    ours = {a.dest: a for a in port_config.build_parser()._actions}
    for a in jax_parser()._actions:
        if a.dest == "help":
            continue
        assert a.dest in ours, a.dest
        assert ours[a.dest].option_strings == a.option_strings, a.dest
        if a.dest != "fused_bn":                 # port default: on
            assert ours[a.dest].default == a.default, a.dest
    assert ours["fused_bn"].default == "on"
    assert ours["device"].default == "cuda"


@pytest.mark.parametrize("flags,named", [
    (["--mixup-alpha", "0.2"], "--mixup-alpha"),
    (["--cutmix-alpha", "1.0"], "--cutmix-alpha"),
    (["-a", "vit_b_16", "--flash", "auto"], "--flash auto"),
    (["--accum-steps", "2"], "--accum-steps"),
    (["--model-ema-decay", "0.99"], "--model-ema-decay"),
    (["--amp-dtype", "float16"], "--amp-dtype"),
    (["--sync_batchnorm"], "--sync_batchnorm"),
    (["--remat"], "--remat"),
    (["--resume", "x.msgpack"], "--resume"),
    (["--doctor"], "--doctor"),
    (["--fused-bn", "auto"], "--fused-bn auto"),
    (["--flash", "on"], "--flash on"),
    (["--data", "/imagenet", "--no-synthetic"], "--data"),
    (["-a", "vit_b_16"], "-a vit_b_16"),
    (["--mesh-shape", "2"], "--mesh-shape"),
    (["--compress-grads", "int8"], "--compress-grads"),
])
def test_unsupported_flags_are_refused_by_name(tmp_path, flags, named):
    with pytest.raises(ValueError, match="unsupported in tpudist_torch") as e:
        cli.main(TINY + flags + ["--outpath", str(tmp_path / "o")])
    assert named in str(e.value)
    assert not (tmp_path / "o").exists()


def test_cli_without_device_cpu_fails_loudly(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(argv + ["--outpath", str(tmp_path / "o")])
