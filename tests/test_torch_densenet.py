"""The port's DenseNet against tpudist's, on the CPU.

- The names and fused sites of densenet121/161/169/201 (121 in
  densenet121) are ``tests/test_torch_zoo_names.py``'s.
- A tiny DenseNet (two blocks of two layers, growth 8, 16 initial
  features, bn_size 2; 32 px, 10 classes, batch 4), initialised in flax
  and carried across by ``compat/jax_params``: train-mode loss, logits,
  updated running statistics and every gradient within 1e-4 (of
  ``1 + max|ref|``, and within 6e-4 of its own L2 norm:
  ``zoo.close_grads``), through the fused ``Function``s (the kernels' plain
  bodies on the CPU) and through the plain epilogue; the eval logits too.
- Two SGD steps of the tiny DenseNet against tpudist's ``make_train_step``
  (loss within 1e-5, every leaf within 1e-3 of its largest update or
  1e-6, the bounds of ``tests/test_torch_train.py``).
- The port's checkpoint after those steps restores in tpudist to the same
  tree (params, batch_stats, momentum, step).
- torchvision's ``.pth.tar``: the port's file is tpudist's for the same
  weights, tpudist's loads into the port, and a file in torchvision's
  legacy names (``denselayer1.norm.1.weight``, as its released weights)
  loads too.
- Every densenet arch trains a step through the trainer:
  ``tests/test_torch_zoo_train.py``.
"""

import os

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from jax.sharding import Mesh  # noqa: E402

from tpudist import checkpoint as jax_ckpt  # noqa: E402
from tpudist import config as jax_config  # noqa: E402
from tpudist import train as jax_train  # noqa: E402
from tpudist.compat import torch_checkpoint as jax_tc  # noqa: E402
from tpudist.models.densenet import DenseNet as JaxDenseNet  # noqa: E402
from tpudist_torch import checkpoint as ckpt  # noqa: E402
from tpudist_torch import config as port_config  # noqa: E402
from tpudist_torch import train as port_train  # noqa: E402
from tpudist_torch.compat import torch_checkpoint as tc  # noqa: E402
from tpudist_torch.compat.jax_params import (  # noqa: E402
    bn_net_state_dict_from_jax)
from tpudist_torch.models.densenet import DenseNet  # noqa: E402

import test_torch_zoo as zoo  # noqa: E402

pytestmark = pytest.mark.torch_port

_two_torch_threads = zoo._two_torch_threads
_plain_jax_epilogue = zoo._plain_jax_epilogue

TINY = dict(block_config=(2, 2), growth_rate=8, num_init_features=16,
            bn_size=2, num_classes=10)


def _pair(fused=True, seed=0):
    jm = JaxDenseNet(**TINY, dtype=jnp.float32)
    v = zoo.jax_init(jm, 32, seed)
    pm = DenseNet(**TINY, dtype=torch.float32, fused_bn=fused)
    return jm, v, zoo.port_from(pm, v)


@pytest.mark.parametrize("fused", [True, False])
def test_train_mode_matches_tpudist(fused):
    jm, v, pm = _pair(fused)
    x, y = zoo.batch(4, 32)
    zoo.check_train_mode(jm, v, pm, x, y)


def test_eval_logits_match_tpudist():
    jm, v, pm = _pair(seed=1)
    x, _ = zoo.batch(4, 32, seed=1)
    _, stats = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    v = {"params": v["params"],
         "batch_stats": jax.device_get(stats["batch_stats"])}
    zoo.port_from(pm, v)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        v, jnp.asarray(x)))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x)).numpy()
    zoo.close(got, want, what="eval logits")


FIELDS = dict(arch="densenet121", num_classes=10, image_size=32,
              batch_size=8, lr=0.01, seed=0, use_amp=False)


def _steps(k, tmp_path):
    """k SGD steps on both sides from tpudist's initial state; the port
    saves its state after them."""
    jcfg = jax_config.Config(**FIELDS, fused_bn="off")
    jm = JaxDenseNet(**TINY, dtype=jnp.float32)
    state = jax_train.create_train_state(jax.random.PRNGKey(0), jm, jcfg,
                                         input_shape=(1, 32, 32, 3))
    init = jax.device_get(state)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jstep = jax_train.make_train_step(mesh, jm, jcfg)

    pcfg = port_config.Config(**FIELDS, fused_bn="on")
    pm = DenseNet(**TINY, dtype=torch.float32)
    pm.load_state_dict(bn_net_state_dict_from_jax(init.params,
                                                  init.batch_stats))
    opt = port_train.make_optimizer(pm, pcfg)
    pstep = port_train.make_train_step(pm, opt, pcfg)
    losses = []
    rng = np.random.default_rng(0)
    for _ in range(k):
        x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, 8).astype(np.int32)
        state, jm_ = jstep(state, jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(FIELDS["lr"], jnp.float32))
        pm_ = pstep(torch.from_numpy(x), torch.from_numpy(y), FIELDS["lr"])
        losses.append((float(pm_["loss"]), float(jm_["loss"])))
    saved = ckpt.state_to_dict(pm, opt, arch="densenet121", epoch=0,
                               best_acc1=0.0, step=k,
                               topology=ckpt.topology_tag(1, 8, 8))
    os.makedirs(tmp_path / "port")
    ckpt.save_checkpoint(saved, False, str(tmp_path / "port"))
    return losses, pm, opt, init, jax.device_get(state), jcfg, jm


def test_two_sgd_steps_match_tpudist_and_its_restore(tmp_path):
    losses, pm, opt, init, final, jcfg, jm = _steps(2, tmp_path)
    for got, ref in losses:
        assert abs(got - ref) <= 1e-5, losses
    want = bn_net_state_dict_from_jax(final.params, final.batch_stats)
    start = bn_net_state_dict_from_jax(init.params, init.batch_stats)
    got = pm.state_dict()
    assert set(got) == set(want)
    for k in want:
        update = float((want[k] - start[k]).abs().max())
        err = float((got[k] - want[k]).abs().max())
        assert err <= max(1e-3 * update, 1e-6), (k, err, update)

    # tpudist restores the port's file onto its own fresh state.
    template = jax_train.create_train_state(jax.random.PRNGKey(1), jm, jcfg,
                                            input_shape=(1, 32, 32, 3))
    tree = jax_ckpt.load_checkpoint(str(tmp_path / "port"
                                        / ckpt.CKPT_NAME))
    restored = jax.device_get(jax_ckpt.restore_train_state(template, tree))
    assert int(restored.step) == 2
    mine = bn_net_state_dict_from_jax(restored.params, restored.batch_stats)
    for k, t in pm.state_dict().items():
        assert torch.equal(mine[k], t), k
    momentum = bn_net_state_dict_from_jax(
        restored.opt_state.inner_state[1].trace, {})
    for k, p in pm.named_parameters():
        assert torch.equal(momentum[k], opt.state[p]["momentum_buffer"]), k


def test_pth_tar_round_trip_with_tpudist_and_legacy_names(tmp_path):
    _, v, pm = _pair(seed=2)
    params, stats = v["params"], v["batch_stats"]
    mine = tc.export_state_dict(pm, "densenet121")
    theirs = jax_tc.flax_to_torch_state_dict(params, stats, "densenet121")
    assert set(mine) == set(theirs)
    for k in theirs:
        assert torch.equal(mine[k], theirs[k]), k
    assert "features.denseblock1.denselayer1.norm1.weight" in mine
    assert "features.transition1.conv.weight" in mine

    fresh = DenseNet(**TINY, dtype=torch.float32)
    tc.load_torch_state_dict(fresh, theirs, "densenet121")
    for k, t in pm.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], t), k

    legacy = {k.replace("norm1.", "norm.1.").replace("conv2.", "conv.2."):
              t for k, t in theirs.items()}
    assert "features.denseblock1.denselayer1.norm.1.weight" in legacy
    path = str(tmp_path / "legacy.pth")
    torch.save(legacy, path)
    again = DenseNet(**TINY, dtype=torch.float32)
    epoch, best = tc.restore_from_torch(again, path, "densenet121")
    assert (epoch, best) == (0, 0.0)
    for k, t in pm.state_dict().items():
        assert torch.equal(again.state_dict()[k], t), k
