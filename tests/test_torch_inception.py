"""The port's Inception v3 against tpudist's, on the CPU.

- inception_v3's names map onto tpudist's flax tree (the aux head's
  included) and its 96 fused sites equal tpudist's ``act="relu"`` calls.
- Each block alone (``InceptionA``–``E`` and ``InceptionAux``, with the
  aux head's 768 input channels cut to 16 and the others' inputs to 8–16
  channels, on 9x9 or 17x17 maps, batch 2), initialised in flax and
  carried across: train-mode output, updated running statistics and every
  gradient within 1e-4 (of ``1 + max|ref|``, and within 6e-4 of its own
  L2 norm: ``zoo.close_grads``), through the fused
  ``Function``s (the kernels' plain bodies on the CPU). The fused backward
  copies the incoming gradient of each branch end a concatenation joins
  (the count is held).
- The whole model at 75 px is ``tests/test_torch_inception_model.py``.
- One SGD step at 299 px, batch 8, with the aux head and its 0.4-weighted
  loss on, against tpudist's ``make_train_step``: the loss within 1e-4 of
  ``1 + |loss|`` (read at 1.1e-6), and each parameter's and running
  statistic's change within ``STEP_REL`` of tpudist's change in L2 (the
  aux head's own leaves, whose gradient is the aux loss's alone, within
  ``AUX_REL``): a step that moves nothing or twice reads 1, one without
  the aux loss reads 1 on the aux head. The bounds sit about 3x above the
  readings, 0.076 (a BatchNorm bias of Mixed_5c) and 0.006. Those are
  f32 rounding carried back through the BatchNorms of a net at its init:
  the port's own f32 gradients differ from its float64 ones by 3-5 % per
  leaf here (median 3 %), as tpudist's do. A second step is not held:
  after one update the two runs' losses part by 5 % (4.26 against 4.07
  at lr 0.01, and 4.49 against 4.32 at 1e-3) and their second changes
  by 0.8-0.96 of a leaf's.
- The trainer trains inception_v3 (aux head on, its default) a step at
  299 px with the fused epilogue at every eligible site.
"""

import functools

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from jax.sharding import Mesh  # noqa: E402

from tpudist import config as jax_config  # noqa: E402
from tpudist import train as jax_train  # noqa: E402
from tpudist.models import inception as jax_inc  # noqa: E402
from tpudist.models.layers import BatchNorm as JaxBatchNorm  # noqa: E402
from tpudist_torch import config as port_config  # noqa: E402
from tpudist_torch import train as port_train  # noqa: E402
from tpudist_torch.compat.jax_params import (  # noqa: E402
    bn_net_state_dict_from_jax)
from tpudist_torch.models import inception as inc  # noqa: E402
from tpudist_torch.models.layers import BasicConv2d  # noqa: E402
from tpudist_torch.ops import fused_norm as fn  # noqa: E402

import test_torch_zoo as zoo  # noqa: E402

pytestmark = pytest.mark.torch_port

_two_torch_threads = zoo._two_torch_threads
_plain_jax_epilogue = zoo._plain_jax_epilogue


def test_names_map_onto_tpudists_tree_and_sites_match():
    zoo.check_tree_and_sites("inception_v3")


def _conv(**bn):
    return functools.partial(BasicConv2d, stddev=0.1, dtype=torch.float32,
                             bn=dict(fused=True, **bn))


# (tpudist module, port module, input channels, map size, relayouts): the
# relayouts are the branch ends a concatenation joins (the pool branches of
# B and D have no BatchNorm; E's 2a/2b and 3a/3b are joined twice, once).
BLOCKS = {
    "A": (lambda: jax_inc.InceptionA(8, JaxBatchNorm, jnp.float32),
          lambda: inc.InceptionA(16, 8, conv=_conv()), 16, 9, 4),
    "B": (lambda: jax_inc.InceptionB(JaxBatchNorm, jnp.float32),
          lambda: inc.InceptionB(8, conv=_conv()), 8, 9, 2),
    "C": (lambda: jax_inc.InceptionC(12, JaxBatchNorm, jnp.float32),
          lambda: inc.InceptionC(16, 12, conv=_conv()), 16, 9, 4),
    "D": (lambda: jax_inc.InceptionD(JaxBatchNorm, jnp.float32),
          lambda: inc.InceptionD(8, conv=_conv()), 8, 9, 2),
    "E": (lambda: jax_inc.InceptionE(JaxBatchNorm, jnp.float32),
          lambda: inc.InceptionE(16, conv=_conv()), 16, 5, 6),
    "Aux": (lambda: jax_inc.InceptionAux(JaxBatchNorm, 10, jnp.float32),
            lambda: inc.InceptionAux(16, 10, conv=_conv()), 16, 17, 0),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_tpudist(name):
    make_jax, make_port, c, size, relayouts = BLOCKS[name]
    jm = make_jax()
    x = np.random.default_rng(len(name)).standard_normal(
        (2, size, size, c)).astype(np.float32)
    v = jax.device_get(jax.jit(lambda k: jm.init(
        k, jnp.ones((1, size, size, c)), False))(jax.random.PRNGKey(0)))

    def loss(params):
        y, mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                          jnp.asarray(x), True, mutable=["batch_stats"])
        return jnp.sum(y * jnp.cos(y)), (y, mut["batch_stats"])

    (_, (want_y, stats)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(v["params"])
    pm = zoo.port_from(make_port(), v).train()
    fn.reset_counts()
    y = pm(torch.from_numpy(x).permute(0, 3, 1, 2))
    (y * torch.cos(y)).sum().backward()
    assert fn.RELAYOUTS == relayouts
    got_y = y.detach()
    if got_y.dim() == 4:
        assert got_y.is_contiguous(memory_format=torch.channels_last)
        got_y = got_y.permute(0, 2, 3, 1)
    zoo.close(got_y.numpy(), want_y, what="y")
    want = bn_net_state_dict_from_jax(jax.device_get(grads),
                                      jax.device_get(stats))
    for k, t in pm.state_dict().items():
        if k.endswith((".mean", ".var")):
            zoo.close(t.numpy(), want[k].numpy(), what=k)
    zoo.close_grads({k: p.grad.numpy() for k, p in pm.named_parameters()},
                    {k: want[k].numpy() for k, _ in pm.named_parameters()})


def test_aux_head_at_299_px_and_eval_without_it(tmp_path):
    tr = zoo.train_tiny("inception_v3", tmp_path, size=299)
    m = tr.model
    assert m.aux_logits and m.aux_loss_weight == 0.4
    with torch.no_grad():
        out = m.eval()(torch.zeros(1, 299, 299, 3))
    assert isinstance(out, torch.Tensor) and out.shape == (1, 4)


FIELDS = dict(arch="inception_v3", num_classes=10, image_size=299,
              batch_size=8, lr=0.01, seed=0, use_amp=False)
STEP_REL = 0.25
AUX_REL = 0.02


def test_first_sgd_step_with_the_aux_loss_matches_tpudist():
    jcfg = jax_config.Config(**FIELDS, fused_bn="off")
    jm = jax_inc.Inception3(num_classes=10, dropout=0.0, dtype=jnp.float32)
    state = jax.jit(lambda k: jax_train.create_train_state(
        k, jm, jcfg, input_shape=(1, 299, 299, 3)))(jax.random.PRNGKey(0))
    init = jax.device_get(state)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jstep = jax_train.make_train_step(mesh, jm, jcfg)
    pcfg = port_config.Config(**FIELDS, fused_bn="on")
    pm = inc.Inception3(10, dropout=0.0, dtype=torch.float32)
    before = bn_net_state_dict_from_jax(init.params, init.batch_stats)
    pm.load_state_dict(before)
    pstep = port_train.make_train_step(
        pm, port_train.make_optimizer(pm, pcfg), pcfg)
    x, y = zoo.batch(FIELDS["batch_size"], 299)
    state, jmet = jstep(state, jnp.asarray(x), jnp.asarray(y),
                        jnp.asarray(FIELDS["lr"], jnp.float32))
    pmet = pstep(torch.from_numpy(x), torch.from_numpy(y), FIELDS["lr"])
    loss = float(jmet["loss"])
    assert abs(float(pmet["loss"]) - loss) <= 1e-4 * (1 + abs(loss))
    after = jax.device_get(state)
    want = bn_net_state_dict_from_jax(after.params, after.batch_stats)
    got = pm.state_dict()
    assert set(got) == set(want) and any(k.startswith("AuxLogits.")
                                         for k in got)
    for k, t in got.items():
        change = want[k].double() - before[k].double()
        err = float((t.double() - want[k].double()).norm())
        bound = AUX_REL if k.startswith("AuxLogits.") else STEP_REL
        assert err <= bound * float(change.norm()), (k, err / float(
            change.norm()))
