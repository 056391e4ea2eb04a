"""float16 through the port's other paths.

- Non-finite values in float16: the plain bodies of B1–B4 with inf and NaN
  planted in x, r and dy and an affine that overflows float16 (x·a + b past
  65,504), against tpudist's Pallas kernels in interpret mode, give
  non-finite y, dx, dr and partial sums exactly where the Pallas kernels
  do; so do the plain flash forward with inf and NaN in v (B5) and the
  plain backward with inf and NaN in dO (B6, B7). A kernel that swallowed
  an overflow would hide it from the dynamic loss scale.
- Data-parallel: two gloo ranks (``python -m tpudist_torch.launch -n 2``)
  take a float16 step of the tiny resnet18 under DDP, whose bucketed
  all-reduce averages the *scaled* gradients; the step unscales after it.
  Each rank also unscales its own gradients first and averages them as
  tpudist does (unscale, then ``pmean``): the two are bit-equal, because
  the scale is a power of two, and both ranks take the same finite flag.
- The CLI: ``--use_amp --amp-dtype float16`` trains, logs the loss scale
  after each epoch, writes it into the checkpoint, and ``--resume auto``
  restores it exactly. tpudist's own float16 refusals (``--compress-grads``,
  ``--zero full``) are kept, in tpudist's words, beside the port's refusal
  of those flags.

Run as a script (``--worker``), this file is one rank of the DDP run.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

from tpudist_torch import __main__ as cli
from tpudist_torch import checkpoint as ckpt
from tpudist_torch import config as port_config
from tpudist_torch import dist as dist_lib
from tpudist_torch import train as port_train
from tpudist_torch.models import create_model
from tpudist_torch.ops import flash_attention as fa
from tpudist_torch.ops import fused_norm as fn
from tpudist_torch.ops.mixup import mixed_ce

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_classes=8, width=16)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tiny shapes gain nothing from more threads, and the suite runs
    several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _planted(a: np.ndarray, seed: int, frac: float = 0.02) -> np.ndarray:
    """``a`` with about ``frac`` of its entries +inf, -inf or NaN."""
    u = np.random.default_rng(seed).random(a.shape)
    a = a.copy()
    a[u < frac / 3] = np.inf
    a[(u >= frac / 3) & (u < 2 * frac / 3)] = -np.inf
    a[(u >= 2 * frac / 3) & (u < frac)] = np.nan
    return a


def _same_finite(got, want, what):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want),
                                  err_msg=what)
    assert not np.isfinite(want).all(), what


# -- non-finite values -------------------------------------------------------------

@pytest.mark.parametrize("residual", [False, True])
def test_fused_norm_passes_inf_and_nan_as_pallas_does(residual):
    jnp = pytest.importorskip("jax.numpy")
    from tpudist.ops.pallas import fused_norm as jfn
    rng = np.random.default_rng(5)
    m, c = 96, 24
    x, r, dy = (_planted(rng.standard_normal((m, c)).astype(np.float32),
                         10 + i) for i in range(3))
    a = rng.standard_normal(c).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    a[:3] = 3.0e4                     # |x·a| past 65504 where |x| > 2.2
    t = [torch.from_numpy(v).half() for v in (x, r, dy)]
    j = [jnp.asarray(v, jnp.float16) for v in (x, r, dy)]
    rr, jr = (t[1], j[1]) if residual else (None, None)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a)[None], jnp.asarray(b)[None]

    y = fn.bn_act_fwd_plain(t[0], rr, ta, tb)
    jy = jfn._fwd_call(j[0], jr, ja, jb, jnp.float16, True)
    _same_finite(y, jy, "y")
    assert np.isinf(np.asarray(jy, np.float32)).any()   # the overflow shows
    dx, dr, da_p, db_p = fn.bn_act_bwd_plain(t[0], rr, t[2], ta, tb)
    jdx, jdr, jda, jdb = jfn._bwd_call(j[0], jr, j[2], ja, jb, True)
    _same_finite(dx, jdx, "dx")
    if residual:
        _same_finite(dr, jdr, "dr")
    _same_finite(da_p.sum(0), jda, "da")
    _same_finite(db_p.sum(0), jdb, "db")


def test_flash_attention_passes_inf_and_nan_as_pallas_does():
    jnp = pytest.importorskip("jax.numpy")
    from tpudist.ops.pallas.flash_attention import (_flash_backward,
                                                    _flash_forward)
    rng = np.random.default_rng(6)
    q, k, v, do = (rng.standard_normal((1, 70, 2, 32)).astype(np.float32)
                   for _ in range(4))
    v = _planted(v, 20, frac=0.005)
    do = _planted(do, 21, frac=0.005)
    tq, tk, tv, tdo = (torch.from_numpy(a).half() for a in (q, k, v, do))
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.float16) for a in (q, k, v, do))
    o, lse = fa.flash_attention_reference(tq, tk, tv)
    jo, jlse = _flash_forward(jq, jk, jv, False, 128, 128, True)
    _same_finite(o, jo, "o")
    np.testing.assert_array_equal(np.isfinite(lse.numpy()), np.isfinite(
        np.asarray(jlse)[:, :, :70, 0]))
    dq, dk, dv = fa.flash_attention_bwd(tq, tk, tv, o, lse, tdo)
    jgrads = _flash_backward(jq, jk, jv, jo, jlse, jdo, False, 128, 128,
                             True)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), jgrads):
        _same_finite(got, want, name)


# -- data-parallel: unscaling after the all-reduce ---------------------------------

def _worker(workdir: str) -> None:
    """One rank: the DDP float16 step's unscaled gradients, and this
    rank's own unscaled gradients averaged with its peer's (all-gathered)
    as tpudist averages them."""
    torch.set_num_threads(2)
    dist_lib.initialize_runtime(device="cpu")
    rank, world = dist_lib.data_rank_world()
    data = np.load(os.path.join(workdir, "inputs.npz"))
    x, y = (torch.from_numpy(data[k][rank]) for k in ("x", "y"))
    cfg = port_config.Config(arch="resnet18", lr=0.005, batch_size=8 * world,
                             use_amp=True, amp_dtype="float16"
                             ).finalize(world)

    def build():
        m = create_model("resnet18", dtype=torch.float16, fused_bn=True,
                         **TINY)
        m.reset_parameters(torch.Generator().manual_seed(0))
        return m
    scale = 1024.0
    # tpudist's order: each rank unscales, then the mean over ranks.
    local = build()
    (mixed_ce(local(x), y, None, None) * scale).backward()
    mine = [p.grad / scale for p in local.parameters()]
    gathered = [[torch.empty_like(g) for _ in range(world)] for g in mine]
    for g, out in zip(mine, gathered):
        torch.distributed.all_gather(out, g)
    tpudist_order = [sum(parts[1:], parts[0]) / world for parts in gathered]
    # The port's: DDP averages the scaled gradients, the step unscales.
    model = build()
    ddp = port_train.data_parallel(model, torch.device("cpu"))
    scaler = port_train.DynamicScale(scale=scale)
    opt = port_train.make_optimizer(model, cfg)
    seen = []
    real_step = opt.step

    def step_spy(*a, **k):
        seen.extend(p.grad.clone() for p in model.parameters())
        return real_step(*a, **k)
    opt.step = step_spy
    step = port_train.make_train_step(ddp, opt, cfg, scaler=scaler)
    finite = step(x, y, 0.005)["finite"]
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), finite=finite,
             equal=np.asarray([torch.equal(a, b)
                               for a, b in zip(seen, tpudist_order)]),
             n=len(seen))
    dist_lib.shutdown()


def test_ddp_unscaled_after_the_all_reduce_equals_tpudists_order(tmp_path):
    rng = np.random.default_rng(7)
    np.savez(tmp_path / "inputs.npz",
             x=rng.standard_normal((2, 8, 32, 32, 3)).astype(np.float32),
             y=rng.integers(0, 8, (2, 8)).astype(np.int64))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "tpudist_torch.launch", "-n", "2", "--",
         sys.executable, os.path.abspath(__file__), "--worker",
         str(tmp_path)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    ranks = [np.load(tmp_path / f"rank{i}.npz") for i in range(2)]
    for got in ranks:
        assert bool(got["finite"]) and int(got["n"]) == 62
        assert got["equal"].all(), np.flatnonzero(~got["equal"])


# -- the CLI ---------------------------------------------------------------------

CLI = ["--device", "cpu", "--synthetic", "-a", "resnet18", "--num-classes",
       "8", "--image-size", "32", "-b", "8", "--synthetic-size", "8",
       "--seed", "0", "-p", "1", "--use_amp", "--amp-dtype", "float16",
       "--fused-bn", "on", "--telemetry"]


def _cli(*args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(CLI + list(args)) == 0
    return buf.getvalue()


def test_cli_trains_in_float16_and_resumes_the_scale(tmp_path):
    out = tmp_path / "run"
    text = _cli("--epochs", "1", "--outpath", str(out))
    line = [ln for ln in text.splitlines()
            if ln.startswith("=> dynamic loss scale after epoch 0: scale ")]
    assert len(line) == 1 and "steps skipped" in line[0]
    ds = ckpt.load_checkpoint(str(out))["state"]["dynamic_scale"]
    assert np.asarray(ds["scale"]).dtype == np.float32
    assert np.asarray(ds["fin_steps"]).dtype == np.int32
    saved = (float(np.asarray(ds["scale"])), int(np.asarray(ds["fin_steps"])))
    text = _cli("--epochs", "2", "--resume", "auto", "--overwrite", "keep",
                "--outpath", str(out))
    assert (f"=> dynamic loss scale restored: scale {saved[0]:g}, "
            f"fin_steps {saved[1]}") in text
    assert "=> dynamic loss scale after epoch 1: scale " in text


@pytest.mark.parametrize("flag", [["--compress-grads", "int8"],
                                  ["--zero", "full"]])
def test_tpudists_float16_refusals_are_kept_in_its_words(tmp_path, flag):
    jax_config = pytest.importorskip("tpudist.config")
    kw = {"compress_grads": "int8"} if flag[0] == "--compress-grads" \
        else {"zero": "full"}
    with pytest.raises(ValueError) as theirs:
        jax_config.Config(use_amp=True, amp_dtype="float16",
                          **kw).finalize(1)
    with pytest.raises(ValueError, match="unsupported in tpudist_torch") as e:
        cli.main(CLI + flag + ["--outpath", str(tmp_path / "o")])
    assert str(theirs.value) in str(e.value)
    assert f"{flag[0]} (" in str(e.value)        # the port's own refusal
    assert not (tmp_path / "o").exists()


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2])
