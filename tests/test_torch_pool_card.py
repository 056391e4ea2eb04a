"""The padded average pool the port runs (``layers.avg_pool_padded``:
maxvit's 3x3/s2 shortcut, inception_v3's 3x3/s1 branch pool) against
``F.avg_pool2d`` with its padding counted.

On the CPU: the same values and input gradient as ``F.avg_pool2d`` on an
NCHW-contiguous input, and the result stays channels_last. On the card
(skipped without one): its input gradient equals the CPU's, where torch's
CUDA ``avg_pool2d`` backward over a channels_last input with padding is
wrong (torch 2.11, cu128: 0.56–0.75 of the largest entry off at 3x3/s1
and 3x3/s2, padding 1; ``chip_numerics.py``). Run on the card: ``python -m pytest
tests/test_torch_pool_card.py -q``.
"""

import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch
import torch.nn.functional as F

from tpudist_torch.models.layers import avg_pool_padded

pytestmark = pytest.mark.torch_port

CASES = [((2, 64, 28, 28), 3, 2, 1), ((2, 48, 35, 35), 3, 1, 1),
         ((2, 256, 14, 14), 3, 2, 1)]


def _pool_and_grad(fn, x):
    x = x.detach().requires_grad_(True)
    y = fn(x)
    g = torch.linspace(-1, 1, y.numel(), device=x.device).view(y.shape)
    (y * g).sum().backward()
    return y.detach().cpu(), x.grad.detach().cpu()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fault is in torch's CUDA kernel")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,k,s,p", CASES)
def test_matches_avg_pool2d_on_the_cpu(shape, k, s, p):
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(0))
    want = _pool_and_grad(lambda t: F.avg_pool2d(t, k, s, p), x)
    xl = x.contiguous(memory_format=torch.channels_last)
    got = _pool_and_grad(lambda t: avg_pool_padded(t, k, s, p), xl)
    assert avg_pool_padded(xl, k, s, p).is_contiguous(
        memory_format=torch.channels_last)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("shape,k,s,p", CASES)
def test_the_cards_gradient_is_the_cpus(cuda_device, shape, k, s, p):
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(0))
    want = _pool_and_grad(lambda t: F.avg_pool2d(t, k, s, p), x)
    xl = x.to(cuda_device).contiguous(memory_format=torch.channels_last)
    got = _pool_and_grad(lambda t: avg_pool_padded(t, k, s, p), xl)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)
