"""The fused BN epilogues: the port's plain kernel bodies and its autograd
``Function``s against tpudist's Pallas kernels in interpret mode.

- Each plain body (``bn_act_fwd_plain``, ``bn_act_bwd_plain``) against the
  Pallas kernel it stands for (``_fwd_kernel``, ``_fwd_res_kernel``,
  ``_bwd_kernel``, ``_bwd_res_kernel``) on the same numpy inputs, through
  ``_fwd_call``/``_bwd_call`` with ``interpret=True``, the ``(nm, C)``
  partials included (rows blocked as the Pallas kernel blocks them): y,
  dx and dr within the dtype's tolerance below (XLA fuses x·a + b into one
  FMA where PyTorch rounds twice), partials within ``20·1e-5·(1 +
  max|ref|)`` (f32 sums in another order).
- ``fused_bn_act`` forward and its gradients in x, scale, bias, mean, var
  and the residual against tpudist's ``fused_bn_act`` under ``jax.grad``:
  the matrix of ``tests/test_fused_norm.py`` (f32 within 1e-5, bf16 within
  1e-2; gradients within ``20·tol·(1 + max|ref|)``; odd rows and channels).
- A CPU call launches no kernel, and a BatchNorm in train mode that asks for
  the fused epilogue goes through the ``Function``s.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from jax.experimental import pallas as pl  # noqa: E402

from tpudist.ops.pallas import fused_norm as jfn  # noqa: E402
from tpudist_torch.models.layers import BatchNorm  # noqa: E402
from tpudist_torch.ops import fused_norm as fn  # noqa: E402

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tiny shapes gain nothing from more threads, and the suite runs
    several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 1e-2)}
SHAPES = [(2, 5, 5, 64), (24, 130), (40, 8)]


def _inputs(shape, dtype, residual, seed=0):
    """numpy f32 arrays: x, residual, dy (rounded to dtype on both sides),
    and the per-channel scale, bias, mean, var."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    out = {"x": rng.standard_normal(shape), "dy": rng.standard_normal(shape),
           "r": rng.standard_normal(shape) if residual else None,
           "scale": rng.standard_normal(c), "bias": rng.standard_normal(c),
           "mean": rng.standard_normal(c), "var": rng.random(c) + 0.5}
    return {k: None if v is None else v.astype(np.float32)
            for k, v in out.items()}


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


def _np(a):
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32))


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0,
                               err_msg=what)


def _folded(d):
    a = d["scale"] / np.sqrt(d["var"] + 1e-5)
    return a.astype(np.float32), (d["bias"] - d["mean"] * a).astype(
        np.float32)


def _pallas_partials(x2, r2, dy2, a, b):
    """tpudist's backward kernel's (nm, C) partials: ``_bwd_call``'s
    pallas_call, before its reduction."""
    m, c = x2.shape
    bm, bc, m_pad, c_pad = jfn._blocks(m, c)
    nm, nc = m_pad // bm, c_pad // bc
    tile, row, part = (jfn._tile_spec(bm, bc), jfn._row_spec(bc),
                       jfn._part_spec(bc))
    pad = lambda t: jfn._pad2(t, m_pad, c_pad)  # noqa: E731
    vec = lambda t: jfn._pad2(t[None, :], 1, c_pad)  # noqa: E731
    f32 = jax.ShapeDtypeStruct((nm, c_pad), jnp.float32)
    tile_out = jax.ShapeDtypeStruct((m_pad, c_pad), x2.dtype)
    if r2 is None:
        outs = pl.pallas_call(
            jfn._bwd_kernel, grid=(nm, nc), in_specs=[tile, tile, row, row],
            out_specs=[tile, part, part], out_shape=[tile_out, f32, f32],
            interpret=True)(pad(x2), pad(dy2), vec(a), vec(b))
    else:
        outs = pl.pallas_call(
            jfn._bwd_res_kernel, grid=(nm, nc),
            in_specs=[tile, tile, tile, row, row],
            out_specs=[tile, tile, part, part],
            out_shape=[tile_out, tile_out, f32, f32],
            interpret=True)(pad(x2), pad(r2), pad(dy2), vec(a), vec(b))
    return bm, outs[-2][:, :c], outs[-1][:, :c]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(50, 64), (24, 130), (40, 8)])
@pytest.mark.parametrize("residual", [False, True])
def test_plain_bodies_match_the_pallas_kernels(dtype, shape, residual):
    tdt, jdt, tol = DTYPES[dtype]
    d = _inputs(shape, dtype, residual)
    a, b = _folded(d)
    x2, dy2, r2 = _t(d["x"], tdt), _t(d["dy"], tdt), _t(d["r"], tdt)
    jx, jdy, jr = _j(d["x"], jdt), _j(d["dy"], jdt), _j(d["r"], jdt)

    y = fn.bn_act_fwd_plain(x2, r2, _t(a), _t(b))
    jy = jfn._fwd_call(jx, jr, _j(a)[None], _j(b)[None], jdt, True)
    assert y.dtype == tdt
    _close(y, jy, tol, "y")

    bm, jda_p, jdb_p = _pallas_partials(jx, jr, jdy, _j(a), _j(b))
    dx, dr, da_p, db_p = fn.bn_act_bwd_plain(x2, r2, dy2, _t(a), _t(b),
                                             block_rows=bm)
    jdx, jdr, jda, jdb = jfn._bwd_call(jx, jr, jdy, _j(a)[None],
                                       _j(b)[None], True)
    _close(dx, jdx, tol, "dx")
    if residual:
        _close(dr, jdr, tol, "dr")
    else:
        assert dr is None and jdr is None
    assert da_p.shape == jda_p.shape == (-(-shape[0] // bm), shape[1])
    for got, want, what in ((da_p, jda_p, "da partials"),
                            (db_p, jdb_p, "db partials"),
                            (da_p.sum(0), jda, "da"), (db_p.sum(0), jdb, "db")):
        _close(got, want, 20 * 1e-5 * (1 + float(np.abs(_np(want)).max())),
               what)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("residual", [False, True])
def test_fused_bn_act_fwd_and_grads_match_jax(dtype, shape, residual):
    tdt, jdt, tol = DTYPES[dtype]
    d = _inputs(shape, dtype, residual)
    names = ["x", "scale", "bias", "mean", "var"] + (["r"] if residual
                                                     else [])
    dts = {"x": tdt, "r": tdt}
    targs = {k: _t(d[k], dts.get(k, torch.float32)).requires_grad_()
             for k in names}
    jargs = [_j(d[k], jdt if k in ("x", "r") else jnp.float32) for k in names]

    fn.reset_counts()
    y = fn.fused_bn_act(targs["x"], targs["scale"], targs["bias"],
                        targs["mean"], targs["var"],
                        residual=targs.get("r"))
    y.float().sum().backward()
    assert sum(fn.LAUNCHES.values()) == 0

    def jfun(x, scale, bias, mean, var, r=None):
        return jfn.fused_bn_act(x, scale, bias, mean, var, residual=r,
                                interpret=True)

    jy = jfun(*jargs)
    assert y.dtype == tdt and jy.dtype == jdt
    _close(y, jy, tol, "y")
    jgrads = jax.grad(lambda *a: jfun(*a).astype(jnp.float32).sum(),
                      argnums=tuple(range(len(names))))(*jargs)
    for k, jg in zip(names, jgrads):
        g = targs[k].grad
        assert g.dtype == targs[k].dtype, k
        _close(g, jg, 20 * tol * (1 + float(np.abs(_np(jg)).max())),
               f"grad {k}")


def test_a_broadcast_gradient_is_copied_once_and_counted():
    x = torch.randn(2, 3, 3, 8).requires_grad_()
    v = torch.ones(8)
    fn.reset_counts()
    fn.fused_bn_act(x, v, v, 0 * v, v).sum().backward()   # dy: stride 0
    assert fn.RELAYOUTS == 1 and x.grad.shape == x.shape
    fn.reset_counts()
    y = fn.fused_bn_act(x, v, v, 0 * v, v)
    y.backward(torch.randn_like(y))
    assert fn.RELAYOUTS == 0


def test_batchnorm_train_mode_takes_the_functions():
    """A BatchNorm asked for act="relu" in train mode goes through the
    Function (its backward is the backward body, not autograd through the
    plain epilogue), matches the plain epilogue's output and gradients,
    and updates the running statistics the same way; in eval mode, or
    with fused off, it never enters the Function."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 24, 6, 6)).astype(
        np.float32)).to(memory_format=torch.channels_last)
    res = torch.from_numpy(rng.standard_normal((4, 24, 6, 6)).astype(
        np.float32)).to(memory_format=torch.channels_last)
    calls = []
    real = fn._FusedRes.backward

    def spy(ctx, dy):
        calls.append(dy.shape)
        return real(ctx, dy)

    fn._FusedRes.backward = staticmethod(spy)
    try:
        runs = {}
        for fused in (True, False):
            bn = BatchNorm(24, fused=fused)
            xi = x.clone().requires_grad_()
            y = bn(xi, act="relu", residual=res)
            y.square().sum().backward()
            runs[fused] = (y.detach(), xi.grad, bn.scale.grad, bn.mean, bn.var)
    finally:
        fn._FusedRes.backward = staticmethod(real)
    assert calls == [(4, 6, 6, 24)]
    assert runs[True][0].is_contiguous(memory_format=torch.channels_last)
    for a, b in zip(runs[True], runs[False]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)

    bn = BatchNorm(24).eval()
    with torch.no_grad():
        fn.reset_counts()
        y = bn(x, act="relu")
    assert torch.all(y >= 0) and not calls[1:]


def test_fused_batchnorm_refuses_an_output_dtype_other_than_xs():
    """The fused epilogue writes x's dtype; a BatchNorm whose dtype differs
    refuses in train mode rather than write another dtype than its plain
    epilogue would."""
    x = torch.randn(2, 8, 3, 3).to(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="writes x's dtype"):
        BatchNorm(8, dtype=torch.bfloat16)(x, act="relu")
    assert BatchNorm(8, dtype=torch.bfloat16, fused=False)(
        x, act="relu").dtype == torch.bfloat16
    assert BatchNorm(8)(x.bfloat16(), act="relu").dtype == torch.bfloat16
