"""The flash-attention wrappers and, on a CUDA card, their kernels.

No JAX here, so this file also runs on the machine with the card
(``python -m pytest tests/test_torch_flash_kernel.py -q``), where it holds
each CUDA kernel against its plain version and counts its launches: the
forward f32 within 2e-5 (rtol and atol), bf16 within 1e-2; the dQ and dKV
passes f32 within rtol 1e-5 and atol 1e-5·max|ref|, bf16 within 1e-2 of
the same form (the bounds ``tests/test_flash_attention.py`` holds the
Pallas kernels to). Without a card those cases skip at setup.
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
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == dict(before, flash_fwd=before["flash_fwd"] + 1)
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


CARD_CASES = [
    (torch.bfloat16, 64, False, 197, 197),
    (torch.float32, 64, True, 150, 197),
    (torch.float32, 80, False, 197, 197),
    (torch.float32, 32, True, 100, 60),      # 40 rows see no key
]


def _grad_close(got, want, dtype):
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = b.float()
        torch.testing.assert_close(
            a.float(), b, rtol=tol,
            atol=tol * max(1e-6, b.abs().max().item()), msg=name)


@pytest.mark.parametrize("dtype,d,causal,tq,tk", CARD_CASES)
def test_backward_kernels_match_plain_on_card(cuda_device, dtype, d, causal,
                                              tq, tk):
    q, k, v = (x.to(cuda_device, dtype)
               for x in _qkv(2, tq, 3, d, tk=tk, seed=d))
    do = torch.randn(q.shape, device=cuda_device).to(dtype)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    delta, lse = fa.backward_rows(o, lse, do)
    before = dict(fa.LAUNCHES)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == dict(before,
                               flash_bwd_dq=before["flash_bwd_dq"] + 1,
                               flash_bwd_dkv=before["flash_bwd_dkv"] + 1)
    assert dq.is_contiguous() and dk.dtype == dtype
    want = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, causal)
    _grad_close((dq, dk, dv), want, dtype)
    if tq > tk and causal:
        assert torch.all(dq[:, :tq - tk] == 0)


def test_function_on_card_reads_fused_qkv_views(cuda_device):
    """The model's path: q, k, v are views of one head-major QKV buffer;
    one train-mode attention launches each kernel once, and its gradients
    are the plain backward's."""
    qkv = torch.randn(2, 197, 4, 3, 64, device=cuda_device,
                      dtype=torch.bfloat16, requires_grad=True)
    q, k, v = qkv.unbind(3)
    do = torch.randn(2, 197, 4, 64, device=cuda_device).to(torch.bfloat16)
    fa.reset_counts()
    fa.flash_attention(q, k, v).backward(do)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == dict.fromkeys(fa.KERNELS, 1)
    assert fa.RELAYOUTS == 0
    o, lse = fa.flash_attention_reference(q, k, v)
    delta, lse = fa.backward_rows(o, lse, do)
    want = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta)
    _grad_close(qkv.grad.unbind(3), want, torch.bfloat16)


def test_backward_refuses_unsupported_inputs_on_card(cuda_device):
    q = torch.zeros(1, 8, 2, 48, device=cuda_device)
    rows = torch.zeros(1, 2, 8, device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_bwd_dq(q, q, q, q, rows, rows)
    q = torch.zeros(1, 8, 2, 64, device=cuda_device)
    with pytest.raises(ValueError, match="dO"):
        fa.flash_bwd_dkv(q, q, q, q.bfloat16(), rows, rows)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_bwd_dkv(q, q, q, q, rows.double(), rows)
