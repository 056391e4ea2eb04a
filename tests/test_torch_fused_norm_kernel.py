"""The fused BN-epilogue wrappers and, on a CUDA card, their kernels.

No JAX here, so this file also runs on the machine with the card
(``python -m pytest tests/test_torch_fused_norm_kernel.py -q``), where it
holds each of the four CUDA kernels against its plain version: y, dx and dr
bit for bit (the kernel rounds x·a and + b separately and g·a once, as the
plain version does), each per-block partial within ``1e-5·(1 + Σ|term|)``
over its rows (f32 sums in another order). Without a card those cases skip
at setup.
"""

import numpy as np
import pytest
import torch

from tpudist_torch.ops import fused_norm as fn

pytestmark = pytest.mark.torch_port


def _operands(m, c, dtype, device, residual, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, dt=dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device, dt)

    x, dy = t(m, c), t(m, c)
    r = t(m, c) if residual else None
    a, b = t(c, dt=torch.float32), t(c, dt=torch.float32)
    return x, r, dy, a, b


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, r, dy, a, b = _operands(6, 4, torch.float32, "cpu", True)
    with pytest.raises(ValueError, match="must be"):
        fn.bn_act_fwd(x, None, a[:3], b)
    with pytest.raises(ValueError, match="!= x"):
        fn.bn_act_fwd(x, r[:5], a, b)
    with pytest.raises(ValueError, match="M, C"):
        fn.bn_act_fwd(x[None], None, a, b)
    with pytest.raises(ValueError, match="empty"):
        fn.bn_act_bwd(x[:0], None, dy[:0], a, b)
    with pytest.raises(ValueError, match="residual shape"):
        fn.fused_bn_act(x, a, b, a, b.abs(), residual=r[:5])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("m,c", [(802_816, 64), (50_176, 256), (24, 130),
                                 (40, 8), (1000, 2048)])
@pytest.mark.parametrize("residual", [False, True])
def test_kernels_match_plain_on_card(cuda_device, dtype, m, c, residual):
    x, r, dy, a, b = _operands(m, c, dtype, cuda_device, residual, seed=c)
    fn.reset_counts()
    y = fn.bn_act_fwd(x, r, a, b)
    dx, dr, da_p, db_p = fn.bn_act_bwd(x, r, dy, a, b)
    torch.cuda.synchronize()
    name = "bn_act_fwd_res" if residual else "bn_act_fwd"
    back = "bn_act_bwd_res" if residual else "bn_act_bwd"
    assert fn.LAUNCHES[name] == 1 and fn.LAUNCHES[back] == 1
    assert sum(fn.LAUNCHES.values()) == 2

    y_ref = fn.bn_act_fwd_plain(x, r, a, b)
    dx_ref, dr_ref, da_ref, db_ref = fn.bn_act_bwd_plain(x, r, dy, a, b)
    assert y.dtype == dtype and dx.dtype == dtype
    assert torch.equal(y, y_ref)
    assert torch.equal(dx, dx_ref)
    if residual:
        assert torch.equal(dr, dr_ref)
    # Σ|g·x| and Σ|g| over each partial's rows (the mask depends on x, r,
    # a and b only).
    _, _, gx_abs, _ = fn.bn_act_bwd_plain(x, r, dy.abs() * x.sign(), a, b)
    _, _, _, g_abs = fn.bn_act_bwd_plain(x, r, dy.abs(), a, b)
    for got, want, scale in ((da_p, da_ref, gx_abs), (db_p, db_ref, g_abs)):
        assert got.shape == (-(-m // fn.BWD_BLOCK_ROWS), c)
        assert ((got - want).abs() <= 1e-5 * (1 + scale)).all()


def test_autograd_launches_both_directions_on_card(cuda_device):
    x, r, _, _, _ = _operands(4 * 5 * 5, 64, torch.bfloat16, cuda_device,
                              True)
    x = x.view(4, 5, 5, 64).requires_grad_()
    r = r.view(4, 5, 5, 64).requires_grad_()
    scale = torch.ones(64, device=cuda_device, requires_grad=True)
    bias = torch.zeros(64, device=cuda_device, requires_grad=True)
    mean = torch.zeros(64, device=cuda_device)
    var = torch.ones(64, device=cuda_device)
    fn.reset_counts()
    y = fn.fused_bn_act(x, scale, bias, mean, var, residual=r)
    y.float().sum().backward()
    torch.cuda.synchronize()
    assert fn.LAUNCHES == {"bn_act_fwd": 0, "bn_act_fwd_res": 1,
                           "bn_act_bwd": 0, "bn_act_bwd_res": 1}
    assert fn.RELAYOUTS == 0
    assert torch.isfinite(x.grad.float()).all()
    assert scale.grad.shape == (64,) and r.grad.dtype == torch.bfloat16


def test_kernel_refuses_unsupported_inputs_on_card(cuda_device):
    x = torch.zeros(2, 8, 4, 4, device=cuda_device)          # NCHW contiguous
    v = torch.ones(8, device=cuda_device)
    with pytest.raises(ValueError, match="channels_last"):
        fn.fused_bn_act(x.permute(0, 2, 3, 1), v, v, v, v)
    xh = x.to(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    assert fn.fused_bn_act(xh, v, v, v, v).shape == (2, 4, 4, 8)
    with pytest.raises(ValueError, match="float32, bfloat16 and float16"):
        fn.bn_act_fwd(torch.zeros(4, 8, device=cuda_device,
                                  dtype=torch.float64), None, v, v)
    with pytest.raises(ValueError, match="contiguous"):
        fn.bn_act_fwd(torch.zeros(8, 8, device=cuda_device)[:, ::2], None,
                      v[:4], v[:4])
