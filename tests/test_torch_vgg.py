"""The port's VGG against tpudist's, on the CPU.

- A short VGG (``cfg`` 16, M, 32, M; 32 px, 10 classes, batch 4; the
  classifier at its full 4096 widths; dropout the identity), with and
  without BatchNorm, initialised in flax and carried across by
  ``compat/jax_params``: train-mode loss, logits, updated running
  statistics and every gradient within 1e-4 (of ``1 + max|ref|``, and
  within 6e-4 of its own L2 norm: ``zoo.close_grads``),
  through the fused ``Function``s (the kernels' plain bodies on the CPU)
  and the plain epilogue. The 8x8 map reaches the classifier through the
  7x7 adaptive pool's uneven bins.
- With dropout on, a train step's masks are the seeded generator's: two
  runs of a step are bit-equal, and the two dropouts of the classifier
  draw apart.
- torchvision's ``.pth.tar``: the port's file is tpudist's for the same
  weights (``features.N``/``classifier.N``), and tpudist's loads into the
  port.
- Every vgg arch trains a step through the trainer:
  ``tests/test_torch_zoo_train.py``.
"""

import functools

import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tpudist.compat import torch_checkpoint as jax_tc  # noqa: E402
from tpudist.models.vgg import VGG as JaxVGG  # noqa: E402
from tpudist_torch import config as port_config  # noqa: E402
from tpudist_torch import train as port_train  # noqa: E402
from tpudist_torch.compat import torch_checkpoint as tc  # noqa: E402
from tpudist_torch.models.vgg import VGG  # noqa: E402

import test_torch_zoo as zoo  # noqa: E402

pytestmark = pytest.mark.torch_port

_two_torch_threads = zoo._two_torch_threads
_plain_jax_epilogue = zoo._plain_jax_epilogue

CFG = (16, "M", 32, "M")


@functools.lru_cache(maxsize=None)
def _init(batch_norm):
    jm = JaxVGG(cfg=CFG, batch_norm=batch_norm, num_classes=10,
                dtype=jnp.float32, dropout=0.0)
    return jm, zoo.jax_init(jm, 32)


def _pair(batch_norm=True, fused=True, dropout=0.0):
    jm, v = _init(batch_norm)
    pm = VGG(CFG, batch_norm, 10, dtype=torch.float32, dropout=dropout,
             fused_bn=fused)
    return jm, v, zoo.port_from(pm, v)


@pytest.mark.parametrize("batch_norm,fused", [(True, True), (True, False),
                                              (False, True)])
def test_train_mode_matches_tpudist(batch_norm, fused):
    jm, v, pm = _pair(batch_norm, fused)
    x, y = zoo.batch(4, 32)
    zoo.check_train_mode(jm, v, pm, x, y)


def test_dropout_draws_of_a_step_are_seeded():
    def run():
        _, _, pm = _pair(dropout=0.5)
        cfg = port_config.Config(seed=3, batch_size=4, lr=0.01)
        step = port_train.make_train_step(
            pm, port_train.make_optimizer(pm, cfg), cfg)
        masks = []
        for d in (pm.drop_1, pm.drop_2):
            d.register_forward_hook(lambda m, a, out: masks.append(
                ((out != 0).clone(), (a[0] != 0).clone())))
        x, y = zoo.batch(4, 32)
        loss = step(torch.from_numpy(x), torch.from_numpy(y).long(),
                    0.01)["loss"]
        return masks, float(loss), pm.state_dict()

    (m1, l1, s1), (m2, l2, s2) = run(), run()
    assert all(torch.equal(a[0], b[0]) for a, b in zip(m1, m2)) and l1 == l2
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert not torch.equal(m1[0][0], m1[1][0])
    kept = sum(int((out & live).sum()) for out, live in m1)
    live = sum(int(live.sum()) for _, live in m1)       # after the ReLUs
    assert abs(kept / live - 0.5) < 0.02, (kept, live)


def test_pth_tar_round_trip_with_tpudist():
    _, v, pm = _pair()
    mine = tc.export_state_dict(pm, "vgg11_bn")
    theirs = jax_tc.flax_to_torch_state_dict(v["params"], v["batch_stats"],
                                             "vgg11_bn")
    assert set(mine) == set(theirs)
    assert all(torch.equal(mine[k], theirs[k]) for k in theirs)
    assert {"features.0.weight", "features.0.bias", "features.1.running_var",
            "features.4.weight", "classifier.6.weight"} <= set(mine)
    fresh = VGG(CFG, True, 10, dtype=torch.float32)
    tc.load_torch_state_dict(fresh, theirs, "vgg11_bn")
    for k, t in pm.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], t), k
