"""The rest of the one-card zoo in the port against tpudist's, on the CPU:
alexnet, squeezenet, mnasnet, shufflenet_v2, efficientnet (v1, v2),
convnext, swin (v1, v2) and maxvit_t.

This file holds what the families share, and the helpers their files
(``test_torch_alexnet_squeezenet.py``, ``test_torch_mnasnet_shufflenet.py``,
``test_torch_efficientnet.py``, ``test_torch_convnext.py``,
``test_torch_swin.py``, ``test_torch_maxvit.py``) import:

- the 33 archs' parameter counts on the meta device equal torchvision's
  (``tests/test_zoo.py``'s, which tpudist's models are held to), and a
  train-mode forward of each on the meta device fuses no BatchNorm
  epilogue (tpudist fuses none in these families);
- ``model_names()`` is tpudist's minus the four archs that need the
  expert and pipe mesh axes (refused by name:
  ``test_torch_zoo.py::test_other_families_are_refused_by_name``); the
  CLI takes each of the 33, and refuses ``--flash on`` for them;
- stochastic depth keeps a share ``1 − p`` of the samples, scales by
  ``1/(1 − p)`` exactly, draws nothing in eval mode or at rate 0, and a
  sample's keep covers all its windows (``rows``);
- ``check_train_mode``: tpudist's jitted train-mode step returns the
  dropout and stochastic-depth keep masks its forward drew from its
  ``"dropout"`` key, and the port's forward takes them in order
  (``layers._keep_mask``, ``replayed_drops``), so that the two
  frameworks drop the same samples and entries (the draws themselves
  differ between frameworks).
"""

import contextlib
import math

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tpudist.models import model_names as jax_model_names  # noqa: E402
from tpudist_torch import config as port_config  # noqa: E402
from tpudist_torch.compat.jax_params import (  # noqa: E402
    bn_net_state_dict_from_jax)
from tpudist_torch.models import create_model, model_names  # noqa: E402
from tpudist_torch.models import layers  # noqa: E402
from tpudist_torch.models.layers import BatchNorm  # noqa: E402

import test_torch_zoo as zoo  # noqa: E402

pytestmark = pytest.mark.torch_port

_two_torch_threads = zoo._two_torch_threads
_plain_jax_epilogue = zoo._plain_jax_epilogue

# torchvision's published counts (tests/test_zoo.py), num_classes=1000.
GOLDEN = {
    "alexnet": 61_100_840, "squeezenet1_0": 1_248_424,
    "squeezenet1_1": 1_235_496, "shufflenet_v2_x0_5": 1_366_792,
    "shufflenet_v2_x1_0": 2_278_604, "shufflenet_v2_x1_5": 3_503_624,
    "shufflenet_v2_x2_0": 7_393_996, "mnasnet0_5": 2_218_512,
    "mnasnet0_75": 3_170_208, "mnasnet1_0": 4_383_312,
    "mnasnet1_3": 6_282_256, "efficientnet_b0": 5_288_548,
    "efficientnet_b1": 7_794_184, "efficientnet_b2": 9_109_994,
    "efficientnet_b3": 12_233_232, "efficientnet_b4": 19_341_616,
    "efficientnet_b5": 30_389_784, "efficientnet_b6": 43_040_704,
    "efficientnet_b7": 66_347_960, "efficientnet_v2_s": 21_458_488,
    "efficientnet_v2_m": 54_139_356, "efficientnet_v2_l": 118_515_272,
    "convnext_tiny": 28_589_128, "convnext_small": 50_223_688,
    "convnext_base": 88_591_464, "convnext_large": 197_767_336,
    "swin_t": 28_288_354, "swin_s": 49_606_258, "swin_b": 87_768_224,
    "swin_v2_t": 28_351_570, "swin_v2_s": 49_737_442,
    "swin_v2_b": 87_930_848, "maxvit_t": 30_919_624,
}
REST = sorted(GOLDEN)
# The archs that need the expert and pipe mesh axes.
MULTI_AXIS = ("vit_moe_b_16", "vit_moe_s_16", "vit_pipe_b_16",
              "vit_pipe_s_16")
# The input a full-size model takes: maxvit_t's maps must be multiples of
# its 7x7 partition, alexnet's pools need more than 32 px.
SIZE = {"maxvit_t": 224, "alexnet": 64}


# -- the helpers the family files share ---------------------------------------

def jax_train_mode(jm, variables, x, y):
    """tpudist's train-mode loss (``_loss_fn``), logits, updated
    statistics and gradients, and the keep masks its forward drew
    (dropout and stochastic depth, from ``PRNGKey(0)``'s ``"dropout"``
    stream, in the order drawn), as ``(keep_prob, mask)`` pairs: each
    ``jax.random.bernoulli`` call's result, returned by the jitted step
    itself."""
    from tpudist import train as jax_train
    real = jax.random.bernoulli
    probs, masks = [], []

    def record(key, p=0.5, shape=None, *a, **k):
        out = real(key, p, shape, *a, **k)
        probs.append(float(p))
        masks.append(out)
        return out

    def loss_fn(params):
        loss, (logits, stats) = jax_train._loss_fn(
            jm, jax.random.PRNGKey(0), params,
            variables.get("batch_stats", {}), jnp.asarray(x),
            jnp.asarray(y))
        return loss, (logits, stats, list(masks))

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "bernoulli", record)
    try:
        (loss, (logits, stats, drawn)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables["params"])
    finally:
        mp.undo()
    loss, logits, stats, grads, drawn = jax.device_get(
        (loss, logits, stats, grads, drawn))
    return loss, logits, stats, grads, list(zip(probs, drawn))


@contextlib.contextmanager
def replayed_drops(draws):
    """Inside the block the port's ``layers._keep_mask`` hands out
    ``draws`` (``(keep_prob, mask)`` pairs) in order, each checked
    against the request's keep probability and size; on exit every one
    was taken exactly once."""
    used = [0]

    def replay(shape, keep_prob, device):
        assert used[0] < len(draws), "the port drew more masks than tpudist"
        p, mask = draws[used[0]]
        used[0] += 1
        assert abs(p - float(keep_prob)) < 1e-9, (p, keep_prob)
        assert np.asarray(mask).size == math.prod(shape), (mask.shape, shape)
        return torch.from_numpy(np.array(mask).reshape(shape)).to(device)

    mp = pytest.MonkeyPatch()
    mp.setattr(layers, "_keep_mask", replay)
    try:
        yield
    finally:
        mp.undo()
    assert used[0] == len(draws), (used[0], len(draws))


def check_train_mode(jm, variables, pm, x, y, *, tol=zoo.TOL,
                     grad_tol=zoo.TOL, grad_rel=zoo.REL) -> int:
    """The port's train-mode loss, logits, running statistics and every
    gradient against tpudist's, with tpudist's keep masks replayed into
    the port (``zoo.check_train_mode``'s bounds). Returns the number of
    masks."""
    want_loss, want_logits, want_stats, want_grads, draws = \
        jax_train_mode(jm, variables, x, y)
    with replayed_drops(draws):
        got_loss, got_logits, _ = zoo.port_train_mode(pm, x, y)
    assert abs(got_loss - float(want_loss)) <= tol * (1 + abs(want_loss))
    zoo.close(got_logits, want_logits, tol, "logits")
    want = bn_net_state_dict_from_jax(want_grads, want_stats)
    sd = pm.state_dict()
    stats = [k for k in sd if k.endswith((".mean", ".var"))]
    assert len(stats) == sum(k.endswith((".mean", ".var")) for k in want)
    for k in stats:
        zoo.close(sd[k].numpy(), want[k].numpy(), tol, k)
    params = dict(pm.named_parameters())
    assert len(params) == len(want) - len(stats)
    zoo.close_grads({k: p.grad.numpy() for k, p in params.items()},
                    {k: want[k].numpy() for k in params}, grad_tol, grad_rel)
    return len(draws)


def random_variables(jm, size: int, seed: int = 0) -> dict:
    """tpudist's variable tree of ``jm`` (shapes from an abstract init at
    ``size`` px) filled with seeded normal draws: weights for the interop
    checks, which need values but no training (no compile)."""
    v = jax.eval_shape(lambda r, x: jm.init(r, x, train=False),
                       jax.random.PRNGKey(0), jnp.ones((1, size, size, 3)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        {"params": v["params"], "batch_stats": v.get("batch_stats", {})})


def check_pth_round_trip(arch: str, must_have=()) -> None:
    """For the same (random) weights the port's ``.pth.tar`` state_dict is
    tpudist's exporter's, tensor for tensor (torchvision's names and
    layouts, the derived index buffers included), and tpudist's loads
    into a fresh port model, which then holds the same weights."""
    from tpudist.compat import torch_checkpoint as jax_tc
    from tpudist.models import create_model as jax_create
    from tpudist_torch.compat import torch_checkpoint as tc
    v = random_variables(jax_create(arch, num_classes=10),
                         SIZE.get(arch, 32), seed=2)
    pm = zoo.port_from(create_model(arch, num_classes=10), v)
    mine = tc.export_state_dict(pm, arch)
    theirs = jax_tc.flax_to_torch_state_dict(v["params"], v["batch_stats"],
                                             arch)
    assert set(mine) == set(theirs)
    for k, t in theirs.items():
        assert mine[k].dtype == t.dtype and torch.equal(mine[k], t), k
    assert set(must_have) <= set(mine), sorted(set(must_have) - set(mine))
    fresh = create_model(arch, num_classes=10)
    tc.load_torch_state_dict(fresh, theirs, arch)
    want = pm.state_dict()
    for k, t in fresh.state_dict().items():
        assert torch.equal(t, want[k]), k


def port_fused_sites(arch: str) -> int:
    """The BatchNorms of a train-mode forward of ``arch`` (full size, on
    the meta device) that ask for the fused epilogue."""
    m = create_model(arch, device="meta")
    count = [0]

    def hook(mod, args, kwargs):
        count[0] += kwargs.get("act") == "relu"

    for mod in m.modules():
        if isinstance(mod, BatchNorm):
            mod.register_forward_pre_hook(hook, with_kwargs=True)
    s = SIZE.get(arch, 32)
    out = m.train()(torch.zeros((2, s, s, 3), device="meta"))
    assert out.shape == (2, 1000)
    return count[0]


# -- registry, counts and sites ---------------------------------------------

def test_registry_is_tpudists_minus_the_multi_axis_archs():
    assert model_names() == sorted(set(jax_model_names()) - set(MULTI_AXIS))
    assert set(REST) <= set(model_names()) and len(REST) == 33


@pytest.mark.parametrize("arch", REST)
def test_param_count_on_meta_and_no_fused_site(arch):
    m = create_model(arch, device="meta")
    assert sum(p.numel() for p in m.parameters()) == GOLDEN[arch]
    assert port_fused_sites(arch) == 0


@pytest.mark.parametrize("arch", REST)
def test_the_cli_takes_the_arch(arch):
    cfg = port_config.from_args(["-a", arch, "--device", "cpu"])
    port_config.refuse_unsupported(cfg)


@pytest.mark.parametrize("arch", ["alexnet", "squeezenet1_1", "mnasnet1_0",
                                  "shufflenet_v2_x1_0", "efficientnet_b0",
                                  "convnext_tiny", "swin_t", "swin_v2_t",
                                  "maxvit_t"])
def test_flash_on_is_refused(arch):
    with pytest.raises(ValueError, match="--flash on"):
        port_config.refuse_unsupported(port_config.Config(arch=arch,
                                                          flash="on"))


# -- stochastic depth --------------------------------------------------------

@pytest.mark.parametrize("rate,dtype", [(0.2, torch.float32),
                                        (0.5, torch.bfloat16)])
def test_stochastic_depth_keeps_whole_samples(rate, dtype):
    x = (torch.rand(4000, 3, 5, generator=torch.Generator().manual_seed(0))
         + 0.5).to(dtype)
    with layers.dropout_seed(1):
        y = layers.stochastic_depth(x, rate, True)
    assert y.dtype == dtype
    kept = (y != 0).flatten(1)
    assert torch.equal(kept.all(1), kept.any(1))        # whole samples
    share, keep = float(kept.all(1).float().mean()), 1.0 - rate
    assert abs(share - keep) <= 5 * math.sqrt(keep * rate / 4000), share
    assert torch.equal(y[y != 0], x[y != 0] / keep)
    with layers.dropout_seed(1):
        assert torch.equal(layers.stochastic_depth(x, rate, True), y)
    assert layers.stochastic_depth(x, rate, False) is x
    assert layers.stochastic_depth(x, 0.0, True) is x


def test_stochastic_depth_rows_cover_each_samples_windows():
    x = torch.ones(6 * 4, 3)                 # 6 samples of 4 windows each
    with layers.dropout_seed(2):
        y = layers.stochastic_depth(x, 0.5, True, rows=6)
    per_sample = (y != 0).all(1).view(6, 4)
    assert torch.equal(per_sample.all(1), per_sample.any(1))
    with layers.dropout_seed(2):
        keep = layers._keep_mask((6,), 0.5, torch.device("cpu"))
    assert torch.equal(per_sample[:, 0], keep)


def test_bn_net_converter_keeps_the_new_leaves_by_name():
    tree = {"a": {"layer_scale": np.ones(3, np.float32),
                  "relative_position_bias_table": np.ones((9, 2),
                                                          np.float32),
                  "logit_scale": np.ones((2, 1, 1), np.float32),
                  "dense": {"kernel": np.ones((3, 4), np.float32)}}}
    sd = bn_net_state_dict_from_jax(tree, {})
    assert sd["a.layer_scale"].shape == (3,)
    assert sd["a.relative_position_bias_table"].shape == (9, 2)
    assert sd["a.logit_scale"].shape == (2, 1, 1)
    assert sd["a.dense.weight"].shape == (4, 3)
    with pytest.raises(ValueError, match="unexpected"):
        bn_net_state_dict_from_jax({"a": {"gamma": np.ones(2)}}, {})
