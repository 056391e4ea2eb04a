"""``python -m tpudist_torch`` trains the new conv families through the
planes that exist, on the CPU (``--device cpu``, 4 classes, 32 px):

- mobilenet_v3_small (dropout 0.2 before its classifier, the EMA on):
  3 epochs straight through are bit-equal (``checkpoint.msgpack``) to 2
  epochs and a ``--resume auto`` for the third: the resumed run redraws
  the straight run's dropout masks (seeded by the optimizer step), and
  its checkpoint is tpudist's format;
- mobilenet_v3_small in float16 (``--use_amp --amp-dtype float16``) with
  ``--fused-bn on`` and ``--accum-steps 2`` at 64 px, batch 16: steps land
  and the dynamic loss scale rides the checkpoint (at 32 px, batch 8,
  googlenet's microbatches of 4 normalise 4 rows on 1x1 maps and every
  step overflows down to 1,024);
- densenet121 over two gloo ranks through ``python -m
  tpudist_torch.launch`` with ``--sync_batchnorm`` (the plain epilogue,
  as tpudist) and without (DDP with the fused epilogue, 121 sites): both
  ranks finish and log ``best_acc1=``; the primary's checkpoint restores.
"""

import contextlib
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

from tpudist_torch import __main__ as cli
from tpudist_torch import checkpoint as ckpt
from tpudist_torch import serialization as ser

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cli(args, out):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["--device", "cpu", "--synthetic", "--num-classes",
                         "4", "--image-size", "32", "--val-resize", "32",
                         "-p", "4", "--seed", "0"] + list(args)
                        + ["--outpath", str(out)]) == 0
    return buf.getvalue()


MOBILE = ["-a", "mobilenet_v3_small", "-b", "8", "--synthetic-size", "16",
          "--step", "1", "--model-ema-decay", "0.5", "--fused-bn", "on"]


def test_resume_redraws_the_straight_runs_dropout(tmp_path):
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    _cli(MOBILE + ["--epochs", "3"], straight)
    _cli(MOBILE + ["--epochs", "2"], resumed)
    text = _cli(MOBILE + ["--epochs", "3", "--resume", "auto",
                          "--overwrite", "keep"], resumed)
    assert f"=> resumed from '{resumed}/checkpoint.msgpack' (epoch 2" in text
    a, b = (open(d / ckpt.CKPT_NAME, "rb").read() for d in (straight,
                                                             resumed))
    assert a == b
    tree = ser.msgpack_restore(a)
    assert tree["arch"] == "mobilenet_v3_small"
    assert int(tree["state"]["step"]) == 6
    assert "features_1" in tree["state"]["params"]
    assert tree["state"]["ema_params"] is not None
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_float16_with_accumulation_lands_steps(tmp_path):
    out = tmp_path / "f16"
    text = _cli(["-a", "mobilenet_v3_small", "-b", "16", "--image-size",
                 "64", "--val-resize", "64", "--synthetic-size", "96",
                 "--epochs", "1", "--use_amp", "--amp-dtype", "float16",
                 "--accum-steps", "2", "--fused-bn", "on"], out)
    assert "=> dynamic loss scale after epoch 0: scale" in text
    tree = ser.msgpack_restore(open(out / ckpt.CKPT_NAME, "rb").read())
    scale = tree["state"]["dynamic_scale"]
    assert np.isfinite(float(scale["scale"]))
    tail = text.split("steps skipped")[0].rsplit(";", 1)[1].split()
    skipped, steps = int(tail[0]), int(tail[2])
    assert steps == 6 and skipped < steps       # a step landed
    assert float(scale["scale"]) == 65536.0 / 2 ** skipped
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("sync", [False, True], ids=["ddp", "syncbn"])
def test_two_gloo_ranks_train_densenet(sync, tmp_path):
    out = tmp_path / "ddp"
    cmd = [sys.executable, "-m", "tpudist_torch.launch", "-n", "2", "--",
           sys.executable, "-m", "tpudist_torch", "--distributed",
           "--device", "cpu", "--synthetic", "-a", "densenet121",
           "--num-classes", "4", "--image-size", "32", "--val-resize", "32",
           "-b", "16", "--epochs", "1", "--synthetic-size", "16", "-p", "1",
           "--fused-bn", "on", "--outpath", str(out)] + (
               ["--sync_batchnorm"] if sync else [])
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, PYTHONPATH=REPO,
                                             OMP_NUM_THREADS="2"))
    assert r.returncode == 0, r.stderr[-3000:]
    log = open(out / "experiment.log").read()
    assert "=> data-parallel: world 2, backend gloo, DDP" in log
    if sync:
        assert ", SyncBN" in log
        assert "=> fused-norm dispatch: plain epilogue (mode on, " \
            "ineligible; SyncBN" in log
    else:
        assert "=> fused-norm dispatch: plain epilogue (mode on, forced; " \
            "the CPU runs each kernel's plain body" in log
    assert r.stdout.count("best_acc1=") + r.stderr.count("best_acc1=") >= 1
    tree = ckpt.load_checkpoint(str(out))
    assert tree["arch"] == "densenet121" and int(tree["state"]["step"]) == 1
    shutil.rmtree(tmp_path, ignore_errors=True)
