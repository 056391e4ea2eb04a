"""The flash-attention wrappers and, on a CUDA card, their kernels.

No JAX here, so this file also runs on the machine with the card
(``python -m pytest tests/test_torch_flash_kernel.py -q``), where it holds
each CUDA kernel against its plain version and counts its launches: the
forward f32 within 2e-5 (rtol and atol), bf16 within 1e-2 (its lse within
2e-5); the dQ and dKV passes f32 within rtol 1e-5 and atol 1e-5·max|ref|,
bf16 within 1e-2 of the same form (the bounds
``tests/test_flash_attention.py`` holds the Pallas kernels to); float16
within its own, tighter bounds (F16_TOL and the rest below). Without a
card those cases skip at setup.
"""

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

from tpudist_torch.ops import flash_attention as fa

pytestmark = pytest.mark.torch_port

F32 = dict(rtol=2e-5, atol=2e-5)
# float16's own bounds, chip_smoke.py's F16_TOL, F16_O_SHARE, BWD_TOL and
# BWD_F16_SHARE: about 3x its readings on the card, since bf16's 1e-2 would
# pass a float16 kernel that rounds P or dS at bf16
# (test_float16_bounds_see_p_and_ds_rounded_at_bf16).
F16_TOL, F16_O_SHARE = 1.5e-3, 0.45
F16_BWD_TOL, F16_GRAD_SHARE = 1e-3, 0.03


def _f16_fwd_breaks(o, o_ref) -> list:
    """What breaks float16's forward bounds: |o − ref| within
    F16_TOL·(1 + |ref|), at most F16_O_SHARE of o not bit-equal."""
    of, rf = o.float(), o_ref.float()
    bad = []
    if not bool(((of - rf).abs() <= F16_TOL * (1 + rf.abs())).all()):
        bad.append(f"o off by {(of - rf).abs().max().item()}")
    share = (o != o_ref).float().mean().item()
    if share > F16_O_SHARE:
        bad.append(f"{share:.3f} of o not bit-equal")
    return bad


def _f16_bwd_breaks(got, want) -> list:
    """What breaks float16's backward bounds: each of dq, dk, dv within
    rtol F16_BWD_TOL and atol F16_BWD_TOL·max|ref|, at most F16_GRAD_SHARE
    of it not bit-equal."""
    bad = []
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        af, bf = a.float(), b.float()
        lim = F16_BWD_TOL * (bf.abs() + bf.abs().max())
        if not bool(((af - bf).abs() <= lim).all()):
            bad.append(f"{name} off by {(af - bf).abs().max().item()}")
        share = (a != b).float().mean().item()
        if share > F16_GRAD_SHARE:
            bad.append(f"{share:.3f} of {name} not bit-equal")
    return bad


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


def _fused_views(d, shift=0, device="cpu"):
    """q, k, v as the model cuts them from its head-major fused QKV output
    (B, T, H, 3, D), in bf16, the buffer moved ``shift`` elements on."""
    b, t, h = 2, 17, 4
    flat = torch.zeros(b * t * h * 3 * d + shift, dtype=torch.bfloat16,
                       device=device)
    return flat[shift:].view(b, t, h, 3, d).unbind(3)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_alignment_predicate_takes_fused_qkv_views(d):
    """The bf16 backward copies tiles 16 bytes at a time: the model's
    fused-QKV views (row stride 3·H·D·2 bytes, head offsets D·2 bytes) are
    aligned; the same views one element on, or a row stride that is no
    multiple of 16 bytes, are not."""
    def ok(t):
        return fa.aligned_16(t.data_ptr(), t.stride(), t.element_size())

    assert all(ok(t) for t in _fused_views(d))
    assert not any(ok(t) for t in _fused_views(d, shift=1))
    odd_rows = torch.zeros(2, 17, 4, 3 * d + 1, dtype=torch.bfloat16)[..., :d]
    assert odd_rows.stride(-1) == 1 and not ok(odd_rows)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (dtype, B, Tq, Tk, H, D, causal): the forward cases chip_smoke.py's
# kernel_vs_plain holds the kernels to, in f32 (the scalar kernel) and bf16
# (the tensor-core kernel): ViT-B/16's serving shape, head dim 80 (ViT-H/14's
# 257 tokens of 16 heads), a causal cross length, and head dim 32 causal with
# 40 rows that see no key.
FWD_CARD_CASES = [
    (torch.bfloat16, 2, 197, 197, 12, 64, False),
    (torch.float32, 2, 150, 197, 4, 64, True),
    (torch.float32, 2, 257, 257, 16, 80, False),
    (torch.float32, 2, 100, 60, 3, 32, True),
    (torch.bfloat16, 2, 257, 257, 16, 80, False),
    (torch.bfloat16, 2, 150, 197, 4, 64, True),
    (torch.bfloat16, 2, 100, 60, 3, 32, True),
    # float16 (--amp-dtype float16) runs the same tensor-core kernel.
    (torch.float16, 2, 197, 197, 12, 64, False),
    (torch.float16, 2, 257, 257, 16, 80, False),
    (torch.float16, 2, 150, 197, 4, 64, True),
    (torch.float16, 2, 100, 60, 3, 32, True),
]


@pytest.mark.parametrize("dtype,b,tq,tk,h,d,causal", FWD_CARD_CASES)
def test_kernel_matches_plain_on_card(cuda_device, dtype, b, tq, tk, h, d,
                                      causal):
    """o and lse within 2e-5 (f32), o within 1e-2 (bf16) or float16's own
    bounds, and the 16-bit lse within the f32 bound (only the order of its
    f32 sums differs); a second launch bit-identical; rows that see no key
    O = 0 and lse = -1e30 exactly."""
    q, k, v = (x.to(cuda_device, dtype)
               for x in _qkv(b, tq, h, d, tk=tk, seed=d))
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == dict(before, flash_fwd=before["flash_fwd"] + 1)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal=causal)
    if dtype == torch.float16:
        assert not _f16_fwd_breaks(o, o_ref)
    else:
        tol = dict(rtol=1e-2, atol=1e-2) if dtype != torch.float32 else F32
        torch.testing.assert_close(o.float(), o_ref.float(), **tol)
    torch.testing.assert_close(lse, lse_ref, **F32)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, causal=causal)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    if causal and tq > tk:
        assert torch.all(o[:, :tq - tk] == 0)
        assert torch.all(lse[:, :, :tq - tk] == fa.NEG_INF)


def test_kernel_refuses_unsupported_inputs_on_card(cuda_device):
    q = torch.zeros(1, 8, 2, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device=cuda_device, dtype=torch.float64)
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
    # bf16 runs the tensor-core kernels: at D = 32 and 80 the scale is no
    # power of two, so only these catch an unrounded Qs.
    (torch.bfloat16, 64, True, 150, 197),
    (torch.bfloat16, 80, False, 197, 197),
    (torch.bfloat16, 32, True, 100, 60),
    (torch.float16, 64, False, 197, 197),
    (torch.float16, 64, True, 150, 197),
    (torch.float16, 80, False, 197, 197),
    (torch.float16, 32, True, 100, 60),
]


def _grad_close(got, want, dtype):
    if dtype == torch.float16:
        assert not _f16_bwd_breaks(got, want)
        return
    tol = 1e-2 if dtype != torch.float32 else 1e-5
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
    # Each block owns its output tile (no atomics): a second launch on the
    # same inputs gives the same bits.
    again = (fa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal))
    assert all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv)))


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


def test_kernels_refuse_misaligned_bf16_views_on_card(cuda_device):
    """A bf16 view one element off a 16-byte boundary is refused by name,
    by the backward passes and the forward alike, with no route to another
    kernel or to the plain version."""
    q, k, v = _fused_views(64, device=cuda_device)
    bq, bk, bv = _fused_views(64, shift=1, device=cuda_device)
    rows = torch.zeros(q.shape[0], q.shape[2], q.shape[1],
                       device=cuda_device)
    before = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_bwd_dq(bq, bk, bv, q.contiguous(), rows, rows)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_bwd_dkv(q, k, v, bq, rows, rows)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(bq, bk, bv)
    assert fa.LAUNCHES == before


def _plain_rounding_at(q, k, v, do, causal, rdt):
    """The plain forward and backward (``flash_attention_reference``,
    ``flash_attention_bwd_reference``) with P and dS rounded at ``rdt``
    where the kernels round them at the input dtype: ``(o, (dq, dk,
    dv))``."""
    tq, tk, d = q.shape[1], k.shape[1], q.shape[-1]
    scale = 1.0 / d ** 0.5
    qs = (q.float() * scale).to(q.dtype).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    valid = torch.ones(tq, tk, dtype=torch.bool)
    if causal:
        valid = valid.tril(tk - tq)
        s = torch.where(valid, s, fa.NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(rdt).float(), v.float())
    o = (o / l.squeeze(-1).transpose(1, 2).unsqueeze(-1)).to(q.dtype)
    lse = (m + torch.log(l)).squeeze(-1)
    delta, lse = fa.backward_rows(o, lse, do)
    p = torch.exp(s - lse.unsqueeze(-1))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta.unsqueeze(-1))).to(rdt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(rdt).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    return o, (dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype))


@pytest.mark.parametrize("tq,tk,d,causal", [(197, 197, 64, False),
                                            (150, 197, 64, True),
                                            (100, 60, 32, True)])
def test_float16_bounds_see_p_and_ds_rounded_at_bf16(tq, tk, d, causal):
    """On the CPU: rounded at float16, ``_plain_rounding_at`` is the plain
    version bit for bit; rounded at bf16 (a float16 kernel that kept
    bf16's rounding) it breaks float16's forward and backward bounds,
    which bf16's 1e-2 would not see."""
    q, k, v = (x.half() for x in _qkv(2, tq, 4, d, tk=tk, seed=d))
    do = torch.from_numpy(np.random.default_rng(d + 1).standard_normal(
        q.shape).astype(np.float32)).half()
    o_ref, lse = fa.flash_attention_reference(q, k, v, causal=causal)
    delta, lse = fa.backward_rows(o_ref, lse, do)
    grads = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, causal)
    o, got = _plain_rounding_at(q, k, v, do, causal, torch.float16)
    assert torch.equal(o, o_ref) and all(
        torch.equal(a, b) for a, b in zip(got, grads))
    o, got = _plain_rounding_at(q, k, v, do, causal, torch.bfloat16)
    assert _f16_fwd_breaks(o, o_ref)
    assert _f16_bwd_breaks(got, grads)
    assert torch.allclose(o.float(), o_ref.float(), rtol=1e-2, atol=1e-2)
