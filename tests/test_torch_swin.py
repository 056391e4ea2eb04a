"""The port's Swin Transformer (v1, v2) against tpudist's, on the CPU.

- ``_rel_pos_index``, ``_cpb_coords`` and ``_shift_mask`` equal tpudist's,
  and ``ShiftedWindowAttention(dim=8, num_heads=2, window=4)`` (the sizes
  ``tests/test_swin.py`` uses) with shift 0 and 2, v1 and v2, on an 8x8
  map, equals tpudist's forward within 1e-5 (flax-initialised, carried
  across).
- A short Swin v2 (embed 16, depths (2, 2), heads (2, 4), window 4: the
  shifted blocks of stage 1 see four windows and the seam mask, stage 2's
  one window drops its shift) and a short v1 (the same at window 3, so
  each stage's map is padded up to a multiple of the window, as v2's
  window 8 pads at 224 px), 10 classes, 32 px, batch 4, stochastic depth
  at 0.5 live with tpudist's keep masks replayed into the port: the
  train-mode loss and logits within 1e-4 and every gradient within 1e-4
  of ``1 + max|ref|`` and 6e-4 of its own L2 norm; v2's k bias gets no
  gradient in either. No kernel of the port runs: the biased windowed
  attention is plain, as tpudist routes it to XLA.
- torchvision's ``.pth.tar`` for swin_t and swin_v2_t: the port's file is
  tpudist's for the same weights (the qkv permuted back to qkv-major with
  each stage's head count, the index and coordinate buffers written), and
  tpudist's loads into the port.
"""

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tpudist.models import swin as jax_swin  # noqa: E402
from tpudist_torch.compat.jax_params import (  # noqa: E402
    bn_net_state_dict_from_jax)
from tpudist_torch.models import swin  # noqa: E402
from tpudist_torch.ops import flash_attention as fa  # noqa: E402

import test_torch_zoo as zoo  # noqa: E402
import test_torch_zoo_rest as rest  # noqa: E402

pytestmark = pytest.mark.torch_port

_two_torch_threads = zoo._two_torch_threads


@pytest.mark.parametrize("ws", [3, 4, 7, 8])
def test_index_and_coords_equal_tpudists(ws):
    np.testing.assert_array_equal(swin._rel_pos_index(ws),
                                  jax_swin._rel_pos_index(ws))
    np.testing.assert_array_equal(swin._cpb_coords(ws),
                                  jax_swin._cpb_coords(ws))


@pytest.mark.parametrize("h,w,ws,sh,sw", [(8, 8, 4, 2, 2), (8, 8, 4, 0, 2),
                                          (56, 56, 7, 3, 3),
                                          (32, 32, 8, 4, 4)])
def test_shift_mask_equals_tpudists(h, w, ws, sh, sw):
    np.testing.assert_array_equal(swin._shift_mask(h, w, ws, sh, sw),
                                  jax_swin._shift_mask(h, w, ws, sh, sw))


@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("shift", [0, 2])
def test_window_attention_equals_tpudists(shift, v2):
    jm = jax_swin.ShiftedWindowAttention(dim=8, num_heads=2, window=4,
                                         shift=shift, v2=v2)
    x = np.random.default_rng(shift + 2 * v2).standard_normal(
        (2, 8, 8, 8)).astype(np.float32)
    v = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    if v2:      # a k bias the forward must ignore
        v = jax.tree_util.tree_map(lambda a: a + 0.5, v)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    pm = swin.ShiftedWindowAttention(8, 2, 4, shift, v2=v2)
    pm.load_state_dict(bn_net_state_dict_from_jax(v["params"], {}),
                       strict=True)
    got = pm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# v2 runs unpadded: where a map is padded, a pad token's k is 0 (x = 0,
# the k bias zeroed), and tpudist's gradient of the cosine's
# jnp.linalg.norm at 0 is NaN (torch's vector_norm gives 0 there), so
# tpudist's own v2 gradients are NaN on a padded map (ROADMAP Queue 3).
@pytest.mark.parametrize("v2,window", [(False, 3), (True, 4)])
def test_train_mode_matches_tpudist(v2, window):
    cfg = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 4), window=window,
               stochastic_depth_prob=0.5, v2=v2, num_classes=10)
    jm = jax_swin.SwinTransformer(dtype=jnp.float32, **cfg)
    v = zoo.jax_init(jm, 32)
    pm = zoo.port_from(swin.SwinTransformer(dtype=torch.float32, **cfg), v)
    x, y = zoo.batch(4, 32, seed=7)
    before = dict(fa.LAUNCHES)
    # blocks 2–4, two residuals each
    assert rest.check_train_mode(jm, v, pm, x, y) == 6
    assert fa.LAUNCHES == before
    if v2:
        for blk in ("features_1_0", "features_3_1"):
            g = getattr(pm, blk).attn.qkv.bias.grad.view(-1, 3, 8)
            assert torch.all(g[:, 1] == 0) and torch.any(g[:, 0] != 0)


def test_tpudists_v2_gradients_are_nan_on_a_padded_map_the_ports_not():
    """The divergence the v2 parity case avoids (ROADMAP Queue 3): the
    short v2 at window 3 pads each map, and tpudist's gradients hold NaN
    where the port's are finite, with the same loss."""
    cfg = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 4), window=3,
               stochastic_depth_prob=0.0, v2=True, num_classes=10)
    jm = jax_swin.SwinTransformer(dtype=jnp.float32, **cfg)
    v = zoo.jax_init(jm, 32)
    x, y = zoo.batch(4, 32, seed=7)
    loss, _, _, grads, _ = rest.jax_train_mode(jm, v, x, y)
    leaves = jax.tree_util.tree_leaves(grads)
    nan = sum(bool(np.isnan(g).any()) for g in leaves)
    assert nan == 8 and len(leaves) == 75
    pm = zoo.port_from(swin.SwinTransformer(dtype=torch.float32, **cfg), v)
    got_loss, _, _ = zoo.port_train_mode(pm, x, y)
    assert abs(got_loss - float(loss)) <= zoo.TOL * (1 + abs(float(loss)))
    assert all(torch.isfinite(p.grad).all() for p in pm.parameters())


@pytest.mark.parametrize("arch,names", [
    ("swin_t", ("features.0.0.weight", "features.0.2.bias",
                "features.1.1.attn.qkv.weight",
                "features.5.3.attn.relative_position_bias_table",
                "features.5.3.attn.relative_position_index",
                "features.6.reduction.weight", "features.7.1.mlp.3.bias",
                "norm.weight", "head.bias")),
    ("swin_v2_t", ("features.3.0.attn.logit_scale",
                   "features.3.0.attn.cpb_mlp.0.bias",
                   "features.3.0.attn.cpb_mlp.2.weight",
                   "features.3.0.attn.relative_coords_table",
                   "features.4.norm.weight"))])
def test_pth_tar_round_trip_with_tpudist(arch, names):
    rest.check_pth_round_trip(arch, names)
