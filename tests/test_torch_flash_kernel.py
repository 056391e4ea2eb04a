"""The flash-attention wrapper and, on a CUDA card, its kernel.

No JAX here, so this file also runs on the machine with the card
(``python -m pytest tests/test_torch_flash_kernel.py -q``), where it holds
the CUDA kernel against the plain version: f32 within 2e-5 (rtol and
atol), bf16 within 1e-2. Without a card those cases skip at setup.
"""

import numpy as np
import pytest
import torch

from tpudist_torch.ops import flash_attention as fa

pytestmark = pytest.mark.torch_port

F32 = dict(rtol=2e-5, atol=2e-5)


def _qkv(b, tq, h, d, tk=None, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(
        (b, t, h, d)).astype(np.float32)) for t in (tq, tk or tq, tk or tq))


def test_wrapper_reads_strided_views():
    """The model hands the wrapper q, k, v as views of its fused
    head-major QKV output; the result equals that of contiguous copies."""
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(
        rng.standard_normal((2, 17, 4, 3, 16)).astype(np.float32))
    q, k, v = qkv.unbind(3)
    assert not q.is_contiguous()
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, want)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 2, 16)
    other = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError, match="disagree"):
        fa.flash_attention(q, other, other)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, q.double(), q)
    with pytest.raises(ValueError, match="B, T, H, D"):
        fa.flash_attention(q[0], q[0], q[0])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,d,causal,tq,tk", [
    (torch.bfloat16, 64, False, 197, 197),
    (torch.float32, 64, True, 150, 197),
    (torch.float32, 80, False, 197, 197),
    (torch.float32, 32, True, 100, 60),
])
def test_kernel_matches_plain_on_card(cuda_device, dtype, d, causal, tq, tk):
    q, k, v = (x.to(cuda_device, dtype)
               for x in _qkv(2, tq, 3, d, tk=tk, seed=d))
    before = fa.LAUNCHES
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal=causal)
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == torch.bfloat16 else F32
    torch.testing.assert_close(o.float(), o_ref.float(), **tol)
    torch.testing.assert_close(lse, lse_ref, **tol)


def test_kernel_refuses_unsupported_inputs_on_card(cuda_device):
    q = torch.zeros(1, 8, 2, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="supports"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 128, device=cuda_device)[..., ::2]
    with pytest.raises(ValueError, match="contiguous head dim"):
        fa.flash_attention(q, q, q)
