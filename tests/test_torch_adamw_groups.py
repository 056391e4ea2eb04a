"""The port's AdamW parameter groups are tpudist's ``no_decay_mask``, leaf
by leaf, and one AdamW step equals tpudist's ``adamw_torch`` under it.

- The groups: decay on tensors of two or more dims, but not on swin's and
  maxvit's ``relative_position_bias_table``, swin v2's ``logit_scale``
  nor anything under its ``cpb_mlp``; checked for a tiny swin v1, swin
  v2, maxvit and convnext (tpudist's own classes), resnet18 and the tiny
  ViT (whose groups the rule leaves as they were: ``ndim >= 2``).
- One step: the same f32 weights and the same seeded gradients through
  tpudist's optax chain (``make_optimizer`` of an ``--optimizer adamw``
  config: lr 1e-3, weight decay 0.05) and the port's ``torch.optim.AdamW``
  groups, for the tiny swin v2 (cosine attention: every excluded kind)
  and the tiny ViT; every updated weight within 1e-6 of tpudist's, and a
  leaf excluded from decay moves by Adam's step alone.
"""

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tpudist import train as jax_train  # noqa: E402
from tpudist.config import Config as JaxConfig  # noqa: E402
from tpudist.models.convnext import ConvNeXt as JaxConvNeXt  # noqa: E402
from tpudist.models.maxvit import MaxVit as JaxMaxVit  # noqa: E402
from tpudist.models.resnet import resnet18 as jax_resnet18  # noqa: E402
from tpudist.models.swin import SwinTransformer as JaxSwin  # noqa: E402
from tpudist.models.vit import VisionTransformer as JaxViT  # noqa: E402
from tpudist_torch import config as port_config  # noqa: E402
from tpudist_torch import train as port_train  # noqa: E402
from tpudist_torch.compat.jax_params import (  # noqa: E402
    bn_net_state_dict_from_jax, jax_tree, state_dict_from_jax)
from tpudist_torch.models import create_model  # noqa: E402
from tpudist_torch.models.convnext import ConvNeXt  # noqa: E402
from tpudist_torch.models.maxvit import MaxVit  # noqa: E402
from tpudist_torch.models.swin import SwinTransformer  # noqa: E402
from tpudist_torch.models.vit import VisionTransformer  # noqa: E402

import test_torch_zoo as zoo  # noqa: E402

pytestmark = pytest.mark.torch_port

_two_torch_threads = zoo._two_torch_threads

SWIN = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 4), window=4,
            num_classes=10)
CNX = (((8, 16, 1), (16, None, 1)), 0.0)
MAXVIT = dict(stem_channels=8, block_channels=(8, 16), block_layers=(1, 1),
              head_dim=8, partition=2, num_classes=5)
VIT = dict(patch_size=8, hidden_dim=64, num_layers=2, num_heads=4,
           mlp_dim=128, num_classes=10)


def _pair(name: str):
    """(tpudist model, port model, input px) of a tiny ``name``."""
    if name in ("swin", "swin_v2"):
        v2 = name == "swin_v2"
        return (JaxSwin(**SWIN, v2=v2, dtype=jnp.float32),
                SwinTransformer(SWIN["embed_dim"], SWIN["depths"],
                                SWIN["num_heads"], SWIN["window"], v2=v2,
                                num_classes=10), 32)
    if name == "maxvit":
        return JaxMaxVit(**MAXVIT), MaxVit(**MAXVIT), 32
    if name == "convnext":
        return (JaxConvNeXt(block_setting=CNX[0], num_classes=10),
                ConvNeXt(*CNX, 10), 32)
    if name == "resnet18":
        return (jax_resnet18(num_classes=10),
                create_model("resnet18", num_classes=10), 32)
    return (JaxViT(**VIT, dtype=jnp.float32),
            VisionTransformer(**VIT, image_size=32), 32)


def _flax_path(name: str, p: torch.Tensor) -> tuple:
    *mods, leaf = name.split(".")
    if leaf == "weight":
        leaf = "kernel" if p.ndim >= 2 else "scale"
    return (*mods, leaf)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


@pytest.mark.parametrize("name", ["swin", "swin_v2", "maxvit", "convnext",
                                  "resnet18", "vit"])
def test_groups_are_tpudists_no_decay_mask(name):
    jm, pm, size = _pair(name)
    shapes = jax.eval_shape(lambda r, x: jm.init(r, x, train=False),
                            jax.random.PRNGKey(0),
                            jnp.ones((1, size, size, 3)))["params"]
    want = _flat(jax_train.no_decay_mask(shapes))
    opt = port_train.make_optimizer(pm, port_config.Config(
        optimizer="adamw", weight_decay=0.05))
    decayed = {id(p) for p in opt.param_groups[0]["params"]}
    assert opt.param_groups[0]["weight_decay"] == 0.05
    assert opt.param_groups[1]["weight_decay"] == 0.0
    got = {_flax_path(n, p): id(p) in decayed
           for n, p in pm.named_parameters()}
    assert got == {k: bool(v) for k, v in want.items()}
    excluded = {k[-1] for k, v in want.items()
                if not v and len(shapes_at(shapes, k)) >= 2}
    if name == "swin":
        assert excluded == {"relative_position_bias_table"}
    if name == "swin_v2":
        assert excluded == {"logit_scale", "kernel"}       # cpb_mlp's
    if name in ("resnet18", "vit"):
        assert not excluded


def shapes_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree.shape


@pytest.mark.parametrize("name", ["swin_v2", "vit"])
def test_one_adamw_step_equals_tpudists(name):
    jm, pm, size = _pair(name)
    v = zoo.jax_init(jm, size)
    params = v["params"]
    rng = np.random.default_rng(7)
    grads = jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    cfg = JaxConfig(optimizer="adamw", lr=1e-3, weight_decay=0.05)
    tx = jax_train.make_optimizer(cfg)
    updates, _ = jax.jit(tx.update)(grads, tx.init(params), params)
    want = jax.device_get(jax.tree_util.tree_map(lambda p, u: p + u, params,
                                                 updates))
    convert = state_dict_from_jax if name == "vit" else \
        (lambda _a, p: bn_net_state_dict_from_jax(p, {}))
    pm.load_state_dict(convert("vit_b_16", params), strict=True)
    opt = port_train.make_optimizer(pm, port_config.Config(
        optimizer="adamw", lr=1e-3, weight_decay=0.05))
    g = convert("vit_b_16", grads)
    for n, p in pm.named_parameters():
        p.grad = g[n].clone()
    opt.step()
    got = {n: p.detach() for n, p in pm.named_parameters()}
    want_sd = convert("vit_b_16", want)
    for n, t in got.items():
        np.testing.assert_allclose(t.numpy(), want_sd[n].numpy(), rtol=0,
                                   atol=1e-6, err_msg=n)
    tree = jax_tree(list(got.items()))
    assert _flat(tree).keys() == _flat(want).keys()
