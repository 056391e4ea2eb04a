"""The port's GoogLeNet against tpudist's, on the CPU.

- googlenet's names map onto tpudist's flax tree, its 57 fused sites
  equal tpudist's ``act="relu"`` calls (the trainer's model has no aux
  heads, as tpudist's), and with ``aux_logits`` both trees carry the two
  heads.
- With its aux heads (``aux_logits=True``; 32 px, 10 classes, batch 4;
  dropout set to the identity on both sides, the aux heads' hard-coded
  0.7 included, by patching inside the test). tpudist sows each head's
  logits under its module's own name (``aux1``), which flax refuses in a
  train-mode apply ("Duplicate use of scope name"; tpudist's trainer
  never sets ``aux_logits``), so the test renames the sown key to
  ``aux1_logits`` inside the test only. Then the train-mode loss (main + 0.3
  × each aux head, tpudist's ``_loss_fn``), logits, both aux logits and
  the updated running statistics within 1e-4 and every gradient within
  1e-3 (of ``1 + max|ref|``; ``GRAD_TOL`` says why) and within 6e-4 of
  its own L2 norm (``zoo.close_grads``), through the fused
  ``Function``s; eval mode returns the logits alone.
- torchvision's ``.pth.tar``: the port's file is tpudist's, tpudist's
  loads into the port, and a file carrying aux-head weights (as
  torchvision's released googlenet) loads into the model without them.
- The trainer builds googlenet without aux heads, as tpudist's (its step
  is ``tests/test_torch_zoo_train.py``'s).
"""

import functools

import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from flax import linen as flax_nn  # noqa: E402
from tpudist.compat import torch_checkpoint as jax_tc  # noqa: E402
from tpudist.models.googlenet import GoogLeNet as JaxGoogLeNet  # noqa: E402
from tpudist_torch.compat import torch_checkpoint as tc  # noqa: E402
from tpudist_torch.models import create_model  # noqa: E402
from tpudist_torch.models.googlenet import GoogLeNet  # noqa: E402

import test_torch_zoo as zoo  # noqa: E402

pytestmark = pytest.mark.torch_port

_two_torch_threads = zoo._two_torch_threads
_plain_jax_epilogue = zoo._plain_jax_epilogue

SIZE = 32
# googlenet is 22 convs deep and normalises 2 to 32 rows in its last
# stages at 32 px and batch 4: the f32 noise of the two frameworks' sums,
# carried back through those statistics, reads 1.1e-4 to 1.6e-4 of a
# gradient's largest entry. At 48 px a pre-activation within rounding of a
# ReLU kink lands on either side in the two frameworks and moves some
# gradients by 1e-2 (tests/test_torch_train.py shows the same for resnet).
GRAD_TOL = 1e-3


@pytest.fixture
def no_dropout(monkeypatch):
    """Dropout is the identity on both sides: tpudist's rates are fields
    but for the aux heads' 0.7, so flax's ``Dropout`` is patched here. And
    tpudist's aux logits are sown under a name apart from the heads'
    modules (see the module note)."""
    monkeypatch.setattr(flax_nn.Dropout, "__call__",
                        lambda self, x, *a, **k: x)
    sow = flax_nn.Module.sow

    def sow_apart(self, col, name, *a, **k):
        return sow(self, col, name + "_logits" if col == "intermediates"
                   else name, *a, **k)

    monkeypatch.setattr(flax_nn.Module, "sow", sow_apart)


@functools.lru_cache(maxsize=None)
def _init(seed):
    jm = JaxGoogLeNet(num_classes=10, aux_logits=True, dropout=0.0,
                      dtype=jnp.float32)
    return jm, zoo.jax_init(jm, SIZE, seed)


def _pair(fused=True, seed=0):
    jm, v = _init(seed)
    pm = GoogLeNet(10, aux_logits=True, dropout=0.0, dtype=torch.float32,
                   fused_bn=fused)
    pm.aux1.drop.rate = pm.aux2.drop.rate = 0.0
    return jm, v, zoo.port_from(pm, v)


def test_names_map_onto_tpudists_tree_and_sites_match():
    zoo.check_tree_and_sites("googlenet")


def test_aux_heads_are_in_both_trees():
    jm = JaxGoogLeNet(num_classes=1000, aux_logits=True)
    v = jax.eval_shape(lambda r, x: jm.init(r, x, train=False),
                       jax.random.PRNGKey(0), jnp.ones((1, 64, 64, 3)))
    want = zoo.flat_shapes(v["params"])
    pm = create_model("googlenet", aux_logits=True, device="meta")
    got = zoo.flat_shapes(zoo.jax_tree(pm.named_parameters()))
    assert got == want
    assert ("aux1", "fc1", "kernel") in got


def test_train_mode_with_aux_heads_matches_tpudist(no_dropout):
    jm, v, pm = _pair()
    x, y = zoo.batch(4, SIZE)
    # The fused backward copies the gradients of the 36 branch ends a
    # concatenation joins and of the two aux heads' convs (flattened).
    zoo.check_train_mode(jm, v, pm, x, y, relayouts=38, grad_tol=GRAD_TOL)
    with torch.no_grad():
        out = pm.eval()(torch.from_numpy(x))
    assert isinstance(out, torch.Tensor) and out.shape == (4, 10)


def test_pth_tar_round_trip_with_tpudist_and_released_aux_weights():
    _, v, with_aux = _pair()
    mine = tc.export_state_dict(with_aux, "googlenet")
    theirs = jax_tc.flax_to_torch_state_dict(v["params"], v["batch_stats"],
                                             "googlenet")
    assert set(mine) == set(theirs)
    assert all(torch.equal(mine[k], theirs[k]) for k in theirs)
    assert "inception3a.branch2.0.conv.weight" in mine
    assert "aux1.fc1.weight" in mine

    plain = GoogLeNet(10, dtype=torch.float32)
    tc.load_torch_state_dict(plain, theirs, "googlenet")   # aux skipped
    for k, t in plain.state_dict().items():
        assert torch.equal(t, with_aux.state_dict()[k]), k
    again = GoogLeNet(10, aux_logits=True, dtype=torch.float32)
    tc.load_torch_state_dict(again, mine, "googlenet")
    for k, t in with_aux.state_dict().items():
        assert torch.equal(again.state_dict()[k], t), k


def test_the_trainers_googlenet_has_no_aux_heads():
    from tpudist_torch import config as port_config
    from tpudist_torch.trainer import Trainer
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        cfg = port_config.from_args(["--device", "cpu", "--synthetic", "-a",
                                     "googlenet", "--num-classes", "4",
                                     "--fused-bn", "off", "--outpath", d,
                                     "--overwrite", "delete"])
        tr = Trainer(cfg)
    assert not tr.model.aux_logits and not hasattr(tr.model, "aux1")
