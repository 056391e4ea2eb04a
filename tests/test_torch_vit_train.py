"""The port's ViT training against tpudist's, through the flash backward.

The tiny ViT of ``tests/test_torch_vit.py`` (patch 8, hidden 64, 2 layers,
4 heads, mlp 128, 32 px → 17 tokens, 10 classes) with ``flash=True`` starts
from the same flax init (through the weight bridge) on both sides:

- every parameter's f32 gradient of the train loss on one batch equals
  ``jax.grad`` of ``tpudist.train._loss_fn`` (its Pallas flash forward and
  two-pass backward in interpret mode) within 1e-4 of the leaf's largest
  entry; the port's goes through ``_FlashAttention`` and the plain version
  of both backward kernels;
- 1 and 5 steps of SGD and of AdamW on the same numpy batches: tpudist's
  jitted ``make_train_step`` on a one-device mesh, the port's eager step.
  The bounds are ``tests/test_torch_train.py``'s: the loss within 1e-5
  after one step and 1e-4 over five, every parameter within 1e-3 of its
  largest update (or 1e-6 absolute).

AdamW has a kink at a zero gradient, and some entries sit on it. Its first
step moves an entry by ``lr·g/(|g| + 1e-8)``, so where the gradient is at
f32's noise floor the step follows the noise, with a sign neither side
controls. The key biases of ``in_proj`` (16 of every 48 entries) have a
gradient of exactly zero in exact arithmetic: a row's scores all shift by
``q·b_k``, and the softmax does not see it. Both packages compute ~1e-9
there against a leaf maximum of ~0.4, and their AdamW steps differ by up
to the whole step. Likewise one ``mlp_0`` weight of gradient 2.5e-7 (a
leaf maximum of 0.17) moves ~0.96·lr on both sides, 1.5e-6 apart. So
under AdamW the entries whose step-one gradient (tpudist's ``jax.grad``
on the first batch) is below 1e-5 of its leaf's largest are held to
no more than the leaf's largest tpudist step instead, and their number is
pinned: the 128 key biases and at most 22 others. SGD, linear in the
gradient, has no such exception.
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
from tpudist.models.vit import VisionTransformer as JaxViT  # noqa: E402
from tpudist_torch import config as port_config  # noqa: E402
from tpudist_torch import train as port_train  # noqa: E402
from tpudist_torch.compat.jax_params import vit_state_dict_from_jax  # noqa: E402
from tpudist_torch.models.vit import VisionTransformer  # noqa: E402
from tpudist_torch.ops.mixup import mixed_ce  # noqa: E402

pytestmark = pytest.mark.torch_port

TINY = dict(patch_size=8, hidden_dim=64, num_layers=2, num_heads=4,
            mlp_dim=128, num_classes=10)
BATCH = 8
FIELDS = {"sgd": dict(optimizer="sgd", lr=0.005),
          "adamw": dict(optimizer="adamw", lr=1e-3, weight_decay=0.05)}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tiny shapes gain nothing from more threads, and the suite runs
    several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fields(optimizer):
    return dict(arch="vit_b_16", num_classes=10, image_size=32,
                batch_size=BATCH, seed=0, use_amp=False, flash="on",
                **FIELDS[optimizer])


def _batches(k, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, BATCH).astype(np.int32)) for _ in range(k)]


@functools.lru_cache(maxsize=None)
def _jax_side(optimizer):
    """tpudist's model, initial state (on the host) and jitted step."""
    jcfg = jax_config.Config(**_fields(optimizer))
    jm = JaxViT(**TINY, flash=True)
    state = jax_train.create_train_state(jax.random.PRNGKey(0), jm, jcfg,
                                         input_shape=(1, 32, 32, 3))
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    return jm, jax.device_get(state), jax_train.make_train_step(mesh, jm,
                                                                jcfg)


def _port_model(params):
    pm = VisionTransformer(*TINY.values(), image_size=32, flash=True)
    pm.load_state_dict(vit_state_dict_from_jax(params), strict=True)
    return pm


@functools.lru_cache(maxsize=None)
def _jax_grad():
    """tpudist's loss and ``jax.grad`` of ``_loss_fn`` on the first batch
    (the first step's), as a state_dict."""
    jm, host_state, _ = _jax_side("sgd")
    (x, y), = _batches(1)
    (jloss, _), jgrad = jax.jit(jax.value_and_grad(
        lambda p: jax_train._loss_fn(jm, jax.random.PRNGKey(0), p, {},
                                     jnp.asarray(x), jnp.asarray(y)),
        has_aux=True))(host_state.params)
    return float(jloss), vit_state_dict_from_jax(jax.device_get(jgrad))


def test_gradients_match_jax_grad():
    _, host_state, _ = _jax_side("sgd")
    (x, y), = _batches(1)
    jloss, want = _jax_grad()
    pm = _port_model(host_state.params).train()
    loss = mixed_ce(pm(torch.from_numpy(x)), torch.from_numpy(y).long(),
                    None, None, 0.0)
    loss.backward()
    assert abs(loss.item() - jloss) <= 1e-5
    got = {k: p.grad for k, p in pm.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        scale = float(want[k].abs().max())
        err = float((got[k] - want[k]).abs().max())
        assert err <= 1e-4 * scale, (k, err, scale)


def _run_both(n_steps, optimizer):
    _, host_state, jstep = _jax_side(optimizer)
    state = jax.tree_util.tree_map(jnp.asarray, host_state)   # donated below
    pcfg = port_config.Config(**_fields(optimizer))
    pm = _port_model(host_state.params)
    pstep = port_train.make_train_step(
        pm, port_train.make_optimizer(pm, pcfg), pcfg)
    losses = []
    lr = port_train.lr_for_epoch(pcfg, 0)
    for x, y in _batches(n_steps):
        state, jmet = jstep(state, jnp.asarray(x), jnp.asarray(y),
                            jnp.asarray(lr, jnp.float32))
        pmet = pstep(torch.from_numpy(x), torch.from_numpy(y), lr)
        losses.append((float(pmet["loss"]), float(jmet["loss"])))
    init = vit_state_dict_from_jax(host_state.params)
    final = vit_state_dict_from_jax(jax.device_get(state.params))
    return losses, pm, init, final


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
@pytest.mark.parametrize("n_steps,tol", [(1, 1e-5), (5, 1e-4)])
def test_steps_match_tpudist(n_steps, tol, optimizer):
    losses, pm, init, want = _run_both(n_steps, optimizer)
    for i, (got, ref) in enumerate(losses):
        assert abs(got - ref) <= tol, (i, got, ref)
    got = pm.state_dict()
    assert set(got) == set(want)
    on_kink = _adamw_kink() if optimizer == "adamw" else {}
    for k in want:
        held = ~on_kink.get(k, torch.zeros_like(want[k], dtype=torch.bool))
        update = float((want[k] - init[k]).abs().max())
        err = float((got[k] - want[k])[held].abs().max())
        assert err <= max(1e-3 * update, 1e-6), (k, err, update)
        step = (got[k] - init[k])[~held].abs()
        assert torch.all(step <= update), (k, float(step.max()), update)


def _adamw_kink() -> dict:
    """Per leaf, the entries whose step-one gradient is below 1e-5 of the
    leaf's largest: the in_proj key biases (4 heads × 16 in each of 2
    layers) and a few others (11 of the other ~110k entries here)."""
    _, grads = _jax_grad()
    kink = {k: g.abs() < 1e-5 * g.abs().max() for k, g in grads.items()}
    kink = {k: m for k, m in kink.items() if m.any()}
    key_bias = torch.zeros(192, dtype=torch.bool)
    for h in range(4):
        key_bias[h * 48 + 16:h * 48 + 32] = True
    for layer in range(2):
        m = kink[f"encoder_layer_{layer}.self_attention.in_proj.bias"]
        assert torch.all(m[key_bias])
    assert 128 <= sum(int(m.sum()) for m in kink.values()) <= 150
    return kink


def test_adamw_decays_matrices_and_embeddings_only():
    """tpudist's ``no_decay_mask``: decay on tensors of two or more dims
    (the class token and position embedding are 3-D), none on biases and
    LayerNorm scales."""
    pm = VisionTransformer(*TINY.values(), image_size=32)
    opt = port_train.make_optimizer(
        pm, port_config.Config(**_fields("adamw")))
    decayed, plain = opt.param_groups
    names = {id(p): k for k, p in pm.named_parameters()}
    assert decayed["weight_decay"] == 0.05 and plain["weight_decay"] == 0.0
    assert {names[id(p)] for p in decayed["params"]} >= {
        "class_token", "pos_embedding", "conv_proj.weight",
        "encoder_layer_0.self_attention.in_proj.weight", "head.weight"}
    assert all(p.ndim < 2 for p in plain["params"])
    assert "encoder_layer_1.ln_2.weight" in {names[id(p)]
                                             for p in plain["params"]}
    assert opt.defaults["betas"] == (0.9, 0.999)
    assert opt.defaults["eps"] == 1e-8
