"""The port's whole Inception v3 against tpudist's at 75 px, its
smallest input, on the CPU.

The model runs without its aux head, which needs a 299 px input (at 75 px
tpudist's aux head averages an empty map into NaN, and torch refuses the
pool), with dropout the identity, 10 classes and batch 8, from flax's
init carried across by ``compat/jax_params``.

- Eval mode, after a train-mode pass has set the running statistics on
  both sides: the logits within 1e-4 (of ``1 + max|ref|``; read at
  3.5e-6).
- Train mode: the loss, the logits and the updated running statistics
  within 5e-3, about 3× the largest of three seeds' readings (loss 1.9e-3,
  logits 1.4e-3, statistics 5e-4). At 75 px the last blocks normalise 8
  to 72 rows: each such BatchNorm divides the two frameworks' f32
  rounding noise by the batch's small spread, and 48 layers of it carry
  1e-6 at the stem to 1e-3 at the logits (at batch 2 the 1x1 maps of the
  last blocks normalise 2 rows and the two runs part entirely; the port's
  own fused and plain epilogues part by a quarter as much). The gradients
  pass back through the same divisions and differ by a fifth of their
  largest entry; they are held block by block in
  ``tests/test_torch_inception.py``.
- torchvision's ``.pth.tar``: the port's file is tpudist's for the same
  weights, and tpudist's loads into the port.
"""

import functools

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tpudist.compat import torch_checkpoint as jax_tc  # noqa: E402
from tpudist.models import inception as jax_inc  # noqa: E402
from tpudist.ops import cross_entropy_loss as jax_ce  # noqa: E402
from tpudist_torch.compat import torch_checkpoint as tc  # noqa: E402
from tpudist_torch.compat.jax_params import (  # noqa: E402
    bn_net_state_dict_from_jax)
from tpudist_torch.models import inception as inc  # noqa: E402
from tpudist_torch.ops.loss import cross_entropy_loss  # noqa: E402

import test_torch_zoo as zoo  # noqa: E402

pytestmark = pytest.mark.torch_port

_two_torch_threads = zoo._two_torch_threads
_plain_jax_epilogue = zoo._plain_jax_epilogue

TRAIN_TOL = 5e-3


@functools.lru_cache(maxsize=None)
def _init75():
    jm = jax_inc.Inception3(num_classes=10, aux_logits=False, dropout=0.0,
                            dtype=jnp.float32)
    return jm, zoo.jax_init(jm, 75)


def _port(v):
    return zoo.port_from(inc.Inception3(10, aux_logits=False, dropout=0.0,
                                        dtype=torch.float32), v)


def test_whole_model_at_75_px_matches_tpudist():
    jm, v = _init75()
    x, y = zoo.batch(8, 75)
    logits, mut = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    loss = float(jax_ce(logits, jnp.asarray(y)))
    stats = jax.device_get(mut["batch_stats"])
    pm = _port(v).train()
    got = pm(torch.from_numpy(x))
    got_loss = float(cross_entropy_loss(got, torch.from_numpy(y)))
    assert abs(got_loss - loss) <= TRAIN_TOL * (1 + abs(loss))
    zoo.close(got.detach().numpy(), np.asarray(logits), TRAIN_TOL, "logits")
    want = bn_net_state_dict_from_jax(v["params"], stats)
    for k, t in pm.state_dict().items():
        if k.endswith((".mean", ".var")):
            zoo.close(t.numpy(), want[k].numpy(), TRAIN_TOL, k)

    trained = {"params": v["params"], "batch_stats": stats}
    want_eval = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        trained, jnp.asarray(x)))
    with torch.no_grad():
        got_eval = _port(trained).eval()(torch.from_numpy(x)).numpy()
    zoo.close(got_eval, want_eval, zoo.TOL, "eval logits")


def test_pth_tar_round_trip_with_tpudist():
    _, v = _init75()
    pm = _port(v)
    mine = tc.export_state_dict(pm, "inception_v3")
    theirs = jax_tc.flax_to_torch_state_dict(v["params"], v["batch_stats"],
                                             "inception_v3")
    assert set(mine) == set(theirs)
    assert all(torch.equal(mine[k], theirs[k]) for k in theirs)
    assert "Mixed_6b.branch7x7dbl_2.conv.weight" in mine
    fresh = inc.Inception3(10, aux_logits=False, dtype=torch.float32)
    tc.load_torch_state_dict(fresh, theirs, "inception_v3")
    for k, t in pm.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], t), k
