"""The port's flash-attention backward against the JAX package.

The same seeded numpy q, k, v and dO go through tpudist's two-pass Pallas
backward run in interpret mode (``_flash_backward``, from its own forward's
o and lse) and through the port:

- the ``autograd.Function`` on CPU tensors (``flash_attention`` then
  ``backward``): the port's own forward, ``backward_rows`` and the plain
  version of both backward kernels, the path a CPU train step takes;
- ``flash_attention_bwd`` fed the Pallas forward's o and lse, so the two
  backward functions see the very same inputs.

The bound is the one ``tests/test_flash_attention.py`` holds the Pallas
backward to: rtol 1e-5 and atol 1e-5·max|ref| in f32, 1e-2 of the same form
in bf16; float16 within 1e-3 of it (about 3x its reading). The kernels
themselves are held against the plain version on the card in
``tests/test_torch_flash_kernel.py``.
"""

import numpy as np
import pytest
from torch_rundirs import remove_module_run_dirs, remove_run_dir  # noqa: F401
import torch

jnp = pytest.importorskip("jax.numpy")

from tpudist.ops.pallas.flash_attention import (  # noqa: E402
    _flash_backward, _flash_forward)
from tpudist_torch.ops import flash_attention as fa  # noqa: E402

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tiny shapes gain nothing from more threads, and the suite runs
    several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(b, tq, h, d, tk=None, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for t in (tq, tk or tq, tk or tq, tq)]


def _jax(q, k, v, do, causal, dtype):
    """tpudist's forward and two-pass backward, interpret mode: the
    gradients and the forward's o and lse as numpy f32."""
    qj, kj, vj = (jnp.asarray(x, dtype) for x in (q, k, v))
    o, lse = _flash_forward(qj, kj, vj, causal, 128, 128, True)
    grads = _flash_backward(qj, kj, vj, o, lse, jnp.asarray(do, dtype),
                            causal, 128, 128, True)
    as_np = lambda x: np.array(x.astype(jnp.float32))  # noqa: E731
    return ([as_np(g) for g in grads], as_np(o),
            np.array(lse)[:, :, :q.shape[1], 0])


def _close(got, want, tol, what):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(
            a, b, rtol=tol, atol=tol * max(1e-6, float(np.abs(b).max())),
            err_msg=f"{name} {what}")


def _check_against_pallas(q, k, v, do, causal, dtype=torch.float32):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.float16: jnp.float16}[dtype]
    # float16 at about 3x its reading (2.6e-4 of the form below).
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2,
           torch.float16: 1e-3}[dtype]
    want, o_j, lse_j = _jax(q, k, v, do, causal, jdt)

    ts = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    for t in ts:
        t.requires_grad_(True)
    out = fa.flash_attention(*ts, causal=causal)
    out.backward(torch.from_numpy(do).to(dtype))
    assert all(t.grad.dtype == dtype for t in ts)
    _close([t.grad.float().numpy() for t in ts], want, tol,
           "through the autograd Function")

    qt, kt, vt, dot = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    got = fa.flash_attention_bwd(qt, kt, vt, torch.from_numpy(o_j).to(dtype),
                                 torch.from_numpy(lse_j), dot, causal=causal)
    _close([g.float().numpy() for g in got], want, tol,
           "from the Pallas forward's o and lse")
    return want


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("t", [64, 197])
def test_plain_backward_matches_pallas_f32(t, d, causal):
    _check_against_pallas(*_inputs(1, t, 2, d, seed=t + d + causal), causal)


@pytest.mark.parametrize("tq,tk", [(80, 48), (48, 96)])
def test_causal_cross_lengths_and_fully_masked_rows(tq, tk):
    """Causal with tq != tk at the k_len − q_len offset. At tq > tk the
    first tq − tk query rows see no key: their forward lse is −1e30, the
    clamp takes it to 0, and their dq (and their share of dk, dv) is 0,
    not NaN."""
    q, k, v, do = _inputs(1, tq, 2, 32, tk=tk, seed=tq)
    want = _check_against_pallas(q, k, v, do, True)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    fa.flash_attention(*ts, causal=True).backward(torch.from_numpy(do))
    assert all(torch.isfinite(t.grad).all() for t in ts)
    if tq > tk:
        assert torch.all(ts[0].grad[:, :tq - tk] == 0)
        assert np.all(want[0][:, :tq - tk] == 0)


def test_plain_backward_matches_pallas_bf16():
    _check_against_pallas(*_inputs(2, 197, 2, 64, seed=7), False,
                          dtype=torch.bfloat16)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_pallas_float16(causal):
    """``--amp-dtype float16``, within 1e-3 (bf16's bound is 1e-2): P and
    dS round to float16 where the Pallas backward rounds them."""
    _check_against_pallas(*_inputs(2, 197, 2, 64, seed=7 + causal), causal,
                          dtype=torch.float16)


def test_backward_counts_no_launch_and_copies_a_strided_gradient():
    """On the CPU no kernel launches; a gradient whose head dim is not
    contiguous is copied once, and counted."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 17, 2, 16))
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa.reset_counts()
    out = fa.flash_attention(*ts)
    strided = torch.stack([do, do], dim=-1)[..., 0]
    assert strided.stride(-1) != 1 and torch.equal(strided, do)
    out.backward(strided)
    assert fa.LAUNCHES == dict.fromkeys(fa.KERNELS, 0)
    assert fa.RELAYOUTS == 1
    want = [t.grad.clone() for t in ts]
    for t in ts:
        t.grad = None
    fa.flash_attention(*ts).backward(do)
    assert fa.RELAYOUTS == 1
    assert all(torch.equal(t.grad, w) for t, w in zip(ts, want))


def test_no_grad_runs_the_forward_alone():
    q = torch.randn(1, 9, 2, 16, requires_grad=True)
    with torch.no_grad():
        out = fa.flash_attention(q, q, q)
    assert out.grad_fn is None
    assert torch.equal(out, fa.flash_attention_reference(q, q, q)[0])
