"""The port's flash-attention forward against the JAX package.

The port's plain version (``flash_attention_reference``, what the wrapper
runs on a CPU tensor) is held against tpudist's Pallas kernel run in
interpret mode (``_flash_forward``: O and the per-row lse), at the bound
``tests/test_flash_attention.py`` holds the Pallas kernel to: f32 within
2e-5 (rtol and atol), bf16 within 1e-2. The port's plain ``attention``
(the ``--flash off`` path) is held against tpudist's. The CUDA kernel
itself is held against the plain version in
``tests/test_torch_flash_kernel.py``, on the card.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from tpudist.ops.pallas.flash_attention import _flash_forward  # noqa: E402
from tpudist.parallel.ring_attention import attention as jax_attention  # noqa: E402
from tpudist_torch.ops import flash_attention as fa  # noqa: E402
from tpudist_torch.parallel.ring_attention import attention  # noqa: E402

pytestmark = pytest.mark.torch_port

F32 = dict(rtol=2e-5, atol=2e-5)


def _qkv(b, tq, h, d, tk=None, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, tk or tq, h, d)).astype(np.float32)
    v = rng.standard_normal((b, tk or tq, h, d)).astype(np.float32)
    return q, k, v


def _jax_flash(q, k, v, causal, dtype=jnp.float32):
    o, lse = _flash_forward(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                            causal, 128, 128, True)
    return (np.asarray(o.astype(jnp.float32)),
            np.asarray(lse)[:, :, :q.shape[1], 0])


def _port_flash(q, k, v, causal, dtype=torch.float32):
    o, lse = fa.flash_attention_fwd(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)), causal=causal)
    return o.float().numpy(), lse.numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64, 80])
@pytest.mark.parametrize("t", [64, 197])
def test_plain_flash_matches_pallas_f32(t, d, causal):
    q, k, v = _qkv(1, t, 2, d, seed=t + d)
    o_j, lse_j = _jax_flash(q, k, v, causal)
    o_p, lse_p = _port_flash(q, k, v, causal)
    np.testing.assert_allclose(o_p, o_j, **F32)
    np.testing.assert_allclose(lse_p, lse_j, **F32)


# Every head dim the kernels take, both mask modes, at ViT-B/16's 197
# tokens, and a causal cross length (150 queries, 197 keys): the bf16
# shapes ``chip_smoke.py`` holds the tensor-core kernel to on the card.
BF16_CASES = [(197, 197, d, causal) for d in (32, 64, 80)
              for causal in (False, True)] + [(150, 197, 64, True)]


@pytest.mark.parametrize("tq,tk,d,causal", BF16_CASES)
def test_plain_flash_matches_pallas_bf16(tq, tk, d, causal):
    q, k, v = _qkv(2, tq, 2, d, tk=tk, seed=tq + d + causal)
    o_j, lse_j = _jax_flash(q, k, v, causal, jnp.bfloat16)
    o_p, lse_p = _port_flash(q, k, v, causal, torch.bfloat16)
    np.testing.assert_allclose(o_p, o_j, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(lse_p, lse_j, rtol=1e-2, atol=1e-2)


def test_causal_query_longer_than_keys_masks_whole_rows():
    """tq > tk under the k_len − q_len offset: the first tq − tk query rows
    see no key, and the kernel emits O = 0 and lse = −1e30 for them (the
    plain XLA attention would average V instead)."""
    q, k, v = _qkv(1, 80, 2, 32, tk=48, seed=3)
    o_j, lse_j = _jax_flash(q, k, v, True)
    o_p, lse_p = _port_flash(q, k, v, True)
    np.testing.assert_allclose(o_p, o_j, **F32)
    np.testing.assert_allclose(lse_p, lse_j, **F32)
    assert np.all(o_p[:, :32] == 0.0)
    assert np.all(lse_p[:, :, :32] == -1e30)
    assert np.all(np.abs(o_p[:, 32:]).sum(-1) > 0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(64, 64), (33, 57)])
def test_plain_attention_matches_jax(tq, tk, causal):
    q, k, v = _qkv(2, tq, 3, 16, tk=tk, seed=tq)
    want = np.asarray(jax_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                    causal=causal))
    got = attention(*(torch.from_numpy(x) for x in (q, k, v)),
                    causal=causal).numpy()
    np.testing.assert_allclose(got, want, **F32)
