"""The fused BN-epilogue wrappers and, on a CUDA card, their kernels.

No JAX here, so this file also runs on the machine with the card
(``python -m pytest tests/test_torch_fused_norm_kernel.py -q``), where it
holds each of the four CUDA kernels against its plain version: y, dx and dr
bit for bit (the kernel rounds x·a and + b separately and g·a once, as the
plain version does), each per-block partial within ``1e-5·(1 + Σ|term|)``
over its rows (f32 sums in another order), in the variant the wrapper
chose (``vector`` for 16-byte rows, ``scalar`` otherwise) and at the edge
shapes of the vector mapping. Without a card those cases skip at setup.
The wrapper's choice of variant, and the plain partials' rows, are tested
here on the CPU.
"""

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
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


@pytest.mark.parametrize("dtype,c,want", [
    (torch.float32, 4, "vector"), (torch.float32, 8, "vector"),
    (torch.float32, 130, "scalar"), (torch.float32, 2, "scalar"),
    (torch.bfloat16, 8, "vector"), (torch.bfloat16, 16, "vector"),
    (torch.bfloat16, 2208, "vector"), (torch.bfloat16, 12, "scalar"),
    (torch.bfloat16, 4, "scalar"), (torch.float16, 72, "vector"),
    (torch.float16, 130, "scalar")])
def test_variant_follows_the_channels_per_16_bytes(dtype, c, want):
    x = torch.zeros(3, c, dtype=dtype)
    assert fn.variant(c, dtype, x, None, torch.empty_like(x)) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_variant_of_an_offset_view_is_scalar(dtype):
    m, c = 6, 16
    per = fn.VEC_BYTES // dtype.itemsize
    base = torch.zeros(m * c + per, dtype=dtype)
    assert base.data_ptr() % fn.VEC_BYTES == 0
    one_off = base[1:1 + m * c].view(m, c)
    aligned = base[per:per + m * c].view(m, c)
    assert one_off.is_contiguous() and aligned.is_contiguous()
    y = torch.empty(m, c, dtype=dtype)
    assert fn.variant(c, dtype, one_off, None, y) == "scalar"
    assert fn.variant(c, dtype, aligned, None, y) == "vector"
    # Any row operand off the boundary, a residual too, takes the scalar one.
    assert fn.variant(c, dtype, aligned, one_off, y) == "scalar"


def test_a_refused_operand_still_raises_before_any_launch():
    x, r, dy, a, b = _operands(6, 8, torch.float32, "meta", True)
    fn.reset_counts()
    with pytest.raises(ValueError, match="cuda or cpu"):
        fn.bn_act_fwd(x, None, a, b)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fn.bn_act_bwd(x, r, dy, a, b)
    assert not any(fn.LAUNCHES.values())
    assert not any(fn.VARIANT_LAUNCHES.values())


@pytest.mark.parametrize("rows", [256, 64, 7])
def test_plain_partials_follow_bwd_block_rows(monkeypatch, rows):
    m, c = 300, 8
    x, r, dy, a, b = _operands(m, c, torch.float32, "cpu", False, seed=3)
    monkeypatch.setattr(fn, "BWD_BLOCK_ROWS", rows)
    for got in (fn.bn_act_bwd(x, None, dy, a, b),
                fn.bn_act_bwd_plain(x, None, dy, a, b)):
        _, _, da_p, db_p = got
        assert da_p.shape == db_p.shape == (-(-m // rows), c)
        g = torch.where(x * a + b > 0, dy, 0.0)
        for i in range(da_p.shape[0]):
            blk = slice(i * rows, (i + 1) * rows)
            assert torch.allclose(da_p[i], (g * x)[blk].sum(0), atol=1e-4)
            assert torch.allclose(db_p[i], g[blk].sum(0), atol=1e-4)


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
    assert fn.VARIANT_LAUNCHES[fn.variant(c, dtype, x)] == 2
    _assert_matches_plain(x, r, dy, a, b, y, dx, dr, da_p, db_p)


def _assert_matches_plain(x, r, dy, a, b, y, dx, dr, da_p, db_p):
    m, c = x.shape
    dtype = x.dtype
    residual = r is not None
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


# The vector mapping's edges in bf16: rows that no row block divides, the
# fewest channels (two 16-byte groups a row), channel groups that fill no
# block evenly, and the widest (276 groups: the channels split in slices).
EDGE_SHAPES = [(50_001, 64), (1_001, 16), (3_333, 72), (12_345, 2208),
               (257, 440)]


@pytest.mark.parametrize("m,c", EDGE_SHAPES)
@pytest.mark.parametrize("residual", [False, True])
def test_vector_edge_shapes_match_plain_on_card(cuda_device, m, c,
                                                residual):
    x, r, dy, a, b = _operands(m, c, torch.bfloat16, cuda_device, residual,
                               seed=m)
    fn.reset_counts()
    y = fn.bn_act_fwd(x, r, a, b)
    dx, dr, da_p, db_p = fn.bn_act_bwd(x, r, dy, a, b)
    torch.cuda.synchronize()
    assert fn.VARIANT_LAUNCHES == {"vector": 2, "scalar": 0}
    _assert_matches_plain(x, r, dy, a, b, y, dx, dr, da_p, db_p)


@pytest.mark.parametrize("residual", [False, True])
def test_an_offset_view_takes_the_scalar_variant_on_card(cuda_device,
                                                         residual):
    m, c = 4_099, 64
    x, r, dy, a, b = _operands(m + 1, c, torch.bfloat16, cuda_device,
                               residual, seed=5)
    # Rows that start one element past a 16-byte boundary.
    x, dy = (t.view(-1)[1:1 + m * c].view(m, c) for t in (x, dy))
    r = None if r is None else r.view(-1)[1:1 + m * c].view(m, c)
    fn.reset_counts()
    y = fn.bn_act_fwd(x, r, a, b)
    dx, dr, da_p, db_p = fn.bn_act_bwd(x, r, dy, a, b)
    torch.cuda.synchronize()
    assert fn.VARIANT_LAUNCHES == {"vector": 0, "scalar": 2}
    _assert_matches_plain(x, r, dy, a, b, y, dx, dr, da_p, db_p)
    # The vector kernel refuses it rather than read across the boundary.
    with pytest.raises(RuntimeError, match="vector variant"):
        fn._launch("bn_act_fwd", x.device, "vector", fn.DTYPES[x.dtype],
                   x.data_ptr(), a.data_ptr(), b.data_ptr(),
                   torch.empty_like(x).data_ptr(), m, c)


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
