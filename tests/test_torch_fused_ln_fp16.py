"""Fused residual-add + LayerNorm in float16: the PyTorch port vs the JAX
package.

The port's four plain twins (``ops.kernels.fused_ln``) are held against
the four Pallas kernels of ``paddle_tpu/ops/pallas/fused_ln.py`` run in
interpret mode on the same float16 inputs, gamma and beta in float16 (as
float16 AMP O1 casts them) or f32: the forwards' y, s, mu and rstd and the
backwards' dx, dgamma and dbeta (each twin given the Pallas forward's own
saved tensors), at H = 64 and at a ragged H = 100, and a case whose sum
x + r passes float16's 65504: the stored s holds inf exactly where the
reference's does, y and #9's dx stay finite, and #7's dx (from the
rounded, infinite s) is non-finite at the reference's places. The two
autograd functions are held against the two ``custom_vjp`` functions, and
their dgamma and dbeta come back in float16.

Bars: a float16 output within 2 float16 ulps of max(1, |reference|)
(2^-9 of it); f32 outputs (mu, the twins' dgamma and dbeta) within 1e-5,
rstd 1e-5 relative.

On the CPU the wrappers run the twins and launch nothing; the CUDA
kernels are held against the twins on the card by chip_smoke.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas import fused_ln as pallas_ln
from paddle_tpu_torch.ops.kernels import WRAPPERS
from paddle_tpu_torch.ops.kernels import fused_ln as port_ln
from torch_threads import one_torch_thread  # noqa: F401

_BLOCK_ROWS = 32  # the Pallas grid: 4 steps over 128 rows
_DT = {"float16": (jnp.float16, torch.float16),
       "float32": (jnp.float32, torch.float32)}


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _ulps(got, want, what):
    """got within 2 float16 ulps of max(1, |want|), at the same
    non-finite places."""
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    want = _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin), what
    assert np.array_equal(np.isposinf(got), np.isposinf(want)), what
    big = np.maximum(1.0, np.abs(want[fin]))
    ulp = np.exp2(np.floor(np.log2(big)) - 10)
    assert (np.abs(got[fin] - want[fin]) <= 2 * ulp).all(), (
        what, (np.abs(got[fin] - want[fin]) / ulp).max())


def _f32(got, want, what, rel=False):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = _np(want)
    if rel:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                   err_msg=what)


def _inputs(shape, w_dtype, seed, overflow=False):
    """x, res, gamma, beta and the two cotangents as numpy f32, rounded to
    float16 (gamma and beta to ``w_dtype``). ``overflow``: x and res near
    4e4, so that x + res passes 65504 in about half the places."""
    rng = np.random.default_rng(seed)
    rnd = lambda a, dt: np.asarray(  # noqa: E731
        jnp.asarray(a, _DT[dt][0]).astype(jnp.float32))
    h = shape[-1]
    if overflow:
        x = rnd(3.3e4 + 1e3 * rng.standard_normal(shape), "float16")
        res = rnd(3.3e4 + 1e3 * rng.standard_normal(shape), "float16")
    else:
        x = rnd(rng.standard_normal(shape) * 2 + 0.5, "float16")
        res = rnd(rng.standard_normal(shape), "float16")
    g = rnd(rng.standard_normal(h) * 0.1 + 1.0, w_dtype)
    b = rnd(rng.standard_normal(h) * 0.1, w_dtype)
    cy = rnd(rng.standard_normal(shape), "float16")
    cs = rnd(rng.standard_normal(shape), "float16")
    return x, res, g, b, cy, cs


def _j(a, dtype="float16"):
    return jnp.asarray(a, _DT[dtype][0])


def _t(a, dtype="float16"):
    return torch.from_numpy(np.array(a, np.float32)).to(_DT[dtype][1])


def _stats(mu, rstd):
    return (_t(_np(mu)[:, 0], "float32"), _t(_np(rstd)[:, 0], "float32"))


@pytest.mark.parametrize("w_dtype", ["float16", "float32"])
@pytest.mark.parametrize("h,eps", [(64, 1e-5), (100, 1e-12)],
                         ids=["h64", "ragged-h100"])
@pytest.mark.parametrize("variant", ["sum", "y"])
def test_twins_match_pallas_kernels(variant, h, eps, w_dtype):
    """#6/#7 (variant 'sum') and #8/#9 ('y') in float16: each twin
    against its Pallas kernel on the same inputs."""
    x, res, g, b, dy, ds = _inputs((128, h), w_dtype, seed=h)
    jx, jr, jdy, jds = (_j(a) for a in (x, res, dy, ds))
    jg, jb = _j(g, w_dtype), _j(b, w_dtype)
    px, pr, pdy, pds = (_t(a) for a in (x, res, dy, ds))
    pg, pb = _t(g, w_dtype), _t(b, w_dtype)
    if variant == "sum":
        y, s, mu, rstd = pallas_ln._fwd_call(jx, jr, jg, jb, eps,
                                             _BLOCK_ROWS, True)
        ty, ts, tmu, trstd = port_ln.fused_add_layer_norm_fwd_plain(
            px, pr, pg, pb, eps)
        assert s.dtype == jnp.float16 and ts.dtype == torch.float16
        _ulps(ts, s, "s")
        dx, dg, db = pallas_ln._bwd_call(jdy, jds, s, mu, rstd, jg,
                                         _BLOCK_ROWS, True)
        tdx, tdg, tdb = port_ln.fused_add_layer_norm_bwd_plain(
            pdy, pds, _t(_np(s)), *_stats(mu, rstd), pg)
    else:
        y, mu, rstd = pallas_ln._fwd_call_y(jx, jr, jg, jb, eps,
                                            _BLOCK_ROWS, True)
        ty, tmu, trstd = port_ln.fused_add_layer_norm_y_fwd_plain(
            px, pr, pg, pb, eps)
        dx, dg, db = pallas_ln._bwd_call_y(jdy, jx, jr, mu, rstd, jg,
                                           _BLOCK_ROWS, True)
        tdx, tdg, tdb = port_ln.fused_add_layer_norm_y_bwd_plain(
            pdy, px, pr, *_stats(mu, rstd), pg)
    assert y.dtype == dx.dtype == jnp.float16
    assert ty.dtype == tdx.dtype == torch.float16
    assert tmu.dtype == trstd.dtype == tdg.dtype == tdb.dtype == \
        torch.float32
    _ulps(ty, y, "y")
    _ulps(tdx, dx, "dx")
    _f32(tmu, _np(mu)[:, 0], "mu")
    _f32(trstd, _np(rstd)[:, 0], "rstd", rel=True)
    _f32(tdg, _np(dg)[0], "dgamma")
    _f32(tdb, _np(db)[0], "dbeta")


def test_overflowing_sum_is_inf_as_the_reference():
    """x + r past 65504: #6 stores s as inf where the reference does (no
    saturation), y stays finite (the statistics are taken on the f32 sum),
    #9 recomputes the sum in f32 and stays finite, and #7, reading the
    rounded s back, is non-finite at the reference's places."""
    x, res, g, b, dy, ds = _inputs((64, 64), "float16", seed=7,
                                   overflow=True)
    jx, jr, jg, jb, jdy, jds = (_j(a) for a in (x, res, g, b, dy, ds))
    px, pr, pg, pb, pdy, pds = (_t(a) for a in (x, res, g, b, dy, ds))
    y, s, mu, rstd = pallas_ln._fwd_call(jx, jr, jg, jb, 1e-5, _BLOCK_ROWS,
                                         True)
    ty, ts, tmu, trstd = port_ln.fused_add_layer_norm_fwd_plain(
        px, pr, pg, pb, 1e-5)
    n_inf = int(np.isposinf(_np(s)).sum())
    assert 0 < n_inf < s.size
    _ulps(ts, s, "s")
    _ulps(ty, y, "y")
    assert bool(torch.isfinite(ty).all())
    dx, _, _ = pallas_ln._bwd_call(jdy, jds, s, mu, rstd, jg, _BLOCK_ROWS,
                                   True)
    tdx, _, _ = port_ln.fused_add_layer_norm_bwd_plain(
        pdy, pds, _t(_np(s)), *_stats(mu, rstd), pg)
    assert not np.isfinite(_np(dx)).all()
    for what, f in (("+inf", np.isposinf), ("-inf", np.isneginf),
                    ("NaN", np.isnan)):
        assert np.array_equal(f(tdx.float().numpy()), f(_np(dx))), what
    dx9, _, _ = pallas_ln._bwd_call_y(jdy, jx, jr, mu, rstd, jg, _BLOCK_ROWS,
                                      True)
    tdx9, _, _ = port_ln.fused_add_layer_norm_y_bwd_plain(
        pdy, px, pr, *_stats(mu, rstd), pg)
    assert bool(torch.isfinite(tdx9).all())
    _ulps(tdx9, dx9, "dx #9")


def _jax_vjp(variant, x, res, g, b, cy, cs, eps):
    args = tuple(_j(a) for a in (x, res, g, b))
    if variant == "sum":
        fn = lambda *a: pallas_ln.fused_add_layer_norm(  # noqa: E731
            *a, eps, 0, True)
        out, vjp = jax.vjp(fn, *args)
        return out, vjp((_j(cy), _j(cs)))
    fn = lambda *a: pallas_ln.fused_add_layer_norm_y(  # noqa: E731
        *a, eps, 0, True)
    y, vjp = jax.vjp(fn, *args)
    return (y,), vjp(_j(cy))


@pytest.mark.parametrize("variant", ["sum", "y"])
def test_autograd_functions_match_custom_vjp(variant):
    """Forward and every gradient of the two autograd functions against
    the two custom_vjp functions (Pallas in interpret mode), float16 rows,
    gamma and beta; dgamma and dbeta come back in float16."""
    x, res, g, b, cy, cs = _inputs((4, 32, 64), "float16", seed=2)
    out, grads = _jax_vjp(variant, x, res, g, b, cy, cs, 1e-12)
    leaves = [_t(a).requires_grad_() for a in (x, res, g, b)]
    before = {w.__name__: w.launches for w in WRAPPERS}
    if variant == "sum":
        y, s = port_ln.fused_add_layer_norm(*leaves, 1e-12)
        torch.autograd.backward((y, s), (_t(cy), _t(cs)))
        got = (y, s)
    else:
        y = port_ln.fused_add_layer_norm_y(*leaves, 1e-12)
        y.backward(_t(cy))
        got = (y,)
    assert {w.__name__: w.launches for w in WRAPPERS} == before
    for name, a, w in zip(("y", "s"), got, out):
        assert a.dtype == torch.float16
        _ulps(a, w, name)
    for name, leaf, w in zip(("dx", "dres", "dgamma", "dbeta"), leaves,
                             grads):
        assert leaf.grad.dtype == torch.float16 == leaf.dtype, name
        assert w.dtype == jnp.float16, name
        _ulps(leaf.grad, w, name)


def _meta(*shape, dtype=torch.float16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_cuda_branch_passes_the_float16_code(monkeypatch):
    """On the CUDA branch (checked on meta tensors) float16 rows reach the
    launch with dtype code 2 and gamma's code (2 for float16, 0 for f32),
    the backward at bf16's plan (the same 2-byte chunks); float64 rows
    still raise before any launch."""
    seen = []
    monkeypatch.setattr(port_ln, "_on_cuda", lambda fn, t: None)
    monkeypatch.setattr(port_ln, "_launch",
                        lambda fn, symbol, argtypes, x, *args:
                        seen.append((symbol, args)))
    n, h = 8, 768
    rows, mu = _meta(n, h), _meta(n, dtype=torch.float32)
    for g in (_meta(h), _meta(h, dtype=torch.float32)):
        code = 2 if g.dtype == torch.float16 else 0
        seen.clear()
        port_ln.fused_add_layer_norm_fwd(rows, rows, g, g)
        port_ln.fused_add_layer_norm_y_fwd(rows, rows, g, g)
        port_ln.fused_add_layer_norm_bwd(rows, rows, rows, mu, mu, g)
        port_ln.fused_add_layer_norm_y_bwd(rows, rows, rows, mu, mu, g)
        assert [s for s, _ in seen] == ["fused_ln_fwd"] * 2 + \
            ["fused_ln_bwd"] * 2
        assert all(a[-2:] == (2, code) for _, a in seen), seen
        blocks = [a[-3] for s, a in seen if s == "fused_ln_bwd"]
        assert blocks == [port_ln.bwd_plan(n, h, torch.bfloat16).blocks] * 2
    assert port_ln.bwd_plan(16384, 768, torch.float16) == \
        port_ln.bwd_plan(16384, 768, torch.bfloat16)
    assert port_ln.row_split(4096, torch.float16) == \
        port_ln.row_split(4096, torch.bfloat16)
    seen.clear()
    with pytest.raises(TypeError, match="dtype"):
        port_ln.fused_add_layer_norm_fwd(*(_meta(n, h, dtype=torch.float64),)
                                         * 2, g, g)
    assert not seen
