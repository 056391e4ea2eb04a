"""The port's ViT against tpudist's, through the weight bridge.

A tiny ``VisionTransformer`` (patch 8, hidden 64, 2 layers, 4 heads, mlp
128, 32 px images → 16 patches + a class token = 17 tokens, a length no
flash block divides) is initialised in flax, carried across with
``vit_state_dict_from_jax`` and run on the same numpy images by both
packages in f32. Logits agree within 1e-4: the two frameworks order the
f32 sums of two layers' matmuls, LayerNorms and softmaxes differently, and
nothing else differs.
"""

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tpudist.models.vit import VisionTransformer as JaxViT  # noqa: E402
from tpudist_torch.compat.jax_params import vit_state_dict_from_jax  # noqa: E402
from tpudist_torch.models import create_model, model_names  # noqa: E402
from tpudist_torch.models.vit import VisionTransformer  # noqa: E402

pytestmark = pytest.mark.torch_port

TINY = dict(patch_size=8, hidden_dim=64, num_layers=2, num_heads=4,
            mlp_dim=128, num_classes=10)
TOL = dict(rtol=1e-4, atol=1e-4)


def _images(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 32, 32, 3)).astype(np.float32)


def _pair(flash, pool="token", seed=0):
    jm = JaxViT(**TINY, flash=flash, pool=pool)
    params = jm.init(jax.random.PRNGKey(seed), jnp.ones((1, 32, 32, 3)),
                     train=False)["params"]
    pm = VisionTransformer(*TINY.values(), image_size=32, pool=pool,
                           flash=flash)
    pm.load_state_dict(vit_state_dict_from_jax(jax.device_get(params)),
                       strict=True)
    return jm, params, pm.eval()


@pytest.mark.parametrize("pool", ["token", "gap"])
@pytest.mark.parametrize("flash", [True, False])
def test_tiny_vit_logits_match_jax(flash, pool):
    jm, params, pm = _pair(flash, pool)
    x = _images()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               train=False))
    with torch.inference_mode():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 10)
    np.testing.assert_allclose(got, want, **TOL)


def test_bridge_keys_and_shapes():
    _, params, pm = _pair(True)
    sd = vit_state_dict_from_jax(jax.device_get(params))
    assert set(sd) == set(pm.state_dict())
    # in_proj stays head-major: the bridge transposes and nothing else
    np.testing.assert_array_equal(
        sd["encoder_layer_0.self_attention.in_proj.weight"].numpy(),
        np.asarray(params["encoder_layer_0"]["self_attention"]["in_proj"]
                   ["kernel"]).T)
    assert sd["conv_proj.weight"].shape == (64, 3, 8, 8)


def test_vit_b_16_param_count_on_meta():
    m = create_model("vit_b_16", device="meta")
    assert sum(p.numel() for p in m.parameters()) == 86_567_656


def test_unknown_arch_lists_the_available():
    with pytest.raises(ValueError, match="resnet18, .*vit_b_16"):
        create_model("vit_moe_b_16")
    rest = {"alexnet", "squeezenet1_0", "squeezenet1_1", "mnasnet0_5",
            "mnasnet0_75", "mnasnet1_0", "mnasnet1_3", "shufflenet_v2_x0_5",
            "shufflenet_v2_x1_0", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0",
            "efficientnet_v2_s", "efficientnet_v2_m", "efficientnet_v2_l",
            "convnext_tiny", "convnext_small", "convnext_base",
            "convnext_large", "swin_t", "swin_s", "swin_b", "swin_v2_t",
            "swin_v2_s", "swin_v2_b", "maxvit_t",
            *(f"efficientnet_b{i}" for i in range(8))}
    assert [n for n in model_names() if n not in rest] == [
        "densenet121", "densenet161", "densenet169", "densenet201",
        "googlenet", "inception_v3", "mobilenet_v2", "mobilenet_v3_large",
        "mobilenet_v3_small", "regnet_x_16gf", "regnet_x_1_6gf",
        "regnet_x_32gf", "regnet_x_3_2gf", "regnet_x_400mf",
        "regnet_x_800mf", "regnet_x_8gf", "regnet_y_16gf", "regnet_y_1_6gf",
        "regnet_y_32gf", "regnet_y_3_2gf", "regnet_y_400mf",
        "regnet_y_800mf", "regnet_y_8gf",
        "resnet101", "resnet152", "resnet18", "resnet34", "resnet50",
        "resnext101_32x8d", "resnext50_32x4d", "vgg11", "vgg11_bn", "vgg13",
        "vgg13_bn", "vgg16", "vgg16_bn", "vgg19", "vgg19_bn", "vit_b_16",
        "vit_b_32", "vit_h_14", "vit_l_16", "vit_l_32", "wide_resnet101_2",
        "wide_resnet50_2"]


def test_fresh_init_follows_the_flax_distributions():
    def build(seed):
        m = VisionTransformer(*TINY.values(), image_size=32)
        m.reset_parameters(torch.Generator().manual_seed(seed))
        return m

    a, b, c = build(0), build(0), build(1)
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w = a.encoder_layer_0.self_attention.in_proj.weight
    assert not torch.equal(w, c.encoder_layer_0.self_attention.in_proj.weight)
    assert abs(w.std().item() - 64 ** -0.5) < 0.1 * 64 ** -0.5  # lecun
    assert w.abs().max().item() <= 2 * 64 ** -0.5 / 0.8796 + 1e-6
    assert torch.count_nonzero(a.class_token) == 0
    assert abs(a.pos_embedding.std().item() - 0.02) < 0.003
    assert torch.all(a.ln.weight == 1) and torch.all(a.head.bias == 0)


def test_bf16_model_keeps_layernorm_in_f32():
    """A bf16 ViT holds f32 master weights, every parameter, as the flax
    tree does (``param_dtype`` f32), and computes in bf16: its output is
    bf16 and equals the f32 model's run on bf16-rounded weights within
    bf16 rounding."""
    m = VisionTransformer(*TINY.values(), image_size=32,
                          dtype=torch.bfloat16)
    m.reset_parameters(torch.Generator().manual_seed(0))
    assert {p.dtype for p in m.parameters()} == {torch.float32}
    assert m.encoder_layer_0.mlp_0.dtype == torch.bfloat16
    assert m.conv_proj.compute_dtype == torch.bfloat16
    with torch.inference_mode():
        out = m(torch.from_numpy(_images(2)))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    f32 = VisionTransformer(*TINY.values(), image_size=32)
    f32.load_state_dict({k: v.bfloat16().float()
                         for k, v in m.state_dict().items()})
    with torch.inference_mode():
        ref = f32(torch.from_numpy(_images(2)))
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(),
                               rtol=0.1, atol=0.1)
