"""Fused 1x1-conv + BatchNorm + ReLU (+ residual) in float16: the PyTorch
port vs the JAX package.

The port's plain twin (``ops.kernels.conv_bn_act.conv_bn_act_plain``) and
its wrapper (which runs the twin on the CPU and launches nothing) are held
against the Pallas kernel of ``paddle_tpu/ops/pallas/conv_bn_act.py`` run
in interpret mode on the same float16 inputs, at a shape the reference
sends to ``pl.pallas_call`` (Cin and Cout multiples of 128; a spy on
``_fwd_call`` shows it), with and without the residual, and with scale and
shift large enough that part of the output passes float16's 65504: the
kernel's +inf must sit in the reference's places (no saturation). The
autograd function's backward (plain PyTorch, as the reference's
``_fused_bwd`` is plain jnp) is held against ``jax.grad`` through the
custom_vjp: dx and dw come back in float16, dscale and dshift in f32.

Bars: float16 outputs within 2 float16 ulps of max(1, |reference|) (2^-9
of it); f32 gradients within 1e-5 of max(1, |reference|).

The CUDA kernel itself is held against the twin on the card by
chip_smoke.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas import conv_bn_act as pallas_cba
from paddle_tpu_torch.ops.kernels import conv_bn_act as port_cba
from torch_threads import one_torch_thread  # noqa: F401

_M, _CIN, _COUT = 256, 128, 256


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _ulps(got, want, what):
    got = np.asarray(got.detach().float(), np.float32)
    want = _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    fin = np.isfinite(want)
    assert np.array_equal(np.isposinf(got), np.isposinf(want)), what
    assert np.array_equal(np.isfinite(got), fin), what
    big = np.maximum(1.0, np.abs(want[fin]))
    ulp = np.exp2(np.floor(np.log2(big)) - 10)
    assert (np.abs(got[fin] - want[fin]) <= 2 * ulp).all(), (
        what, (np.abs(got[fin] - want[fin]) / ulp).max())


def _f32(got, want, what):
    got = got.detach().numpy()
    want = _np(want)
    scaled = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert scaled.max() <= 1e-5, (what, scaled.max())


def _inputs(seed, overflow=False):
    """x2, w, res2 and a cotangent rounded to float16, scale and shift
    f32, as numpy f32. ``overflow``: scale 1e4 and shift 6e4, so that part
    of y passes 65504."""
    rng = np.random.default_rng(seed)
    rnd = lambda a: np.asarray(  # noqa: E731
        jnp.asarray(a, jnp.float16).astype(jnp.float32))
    scale = 1.0 + 0.1 * rng.standard_normal(_COUT)
    shift = 0.1 * rng.standard_normal(_COUT)
    if overflow:
        scale, shift = scale * 1e4, shift + 6e4
    return dict(x2=rnd(rng.standard_normal((_M, _CIN))),
                w=rnd(rng.standard_normal((_CIN, _COUT)) / np.sqrt(_CIN)),
                scale=scale.astype(np.float32),
                shift=shift.astype(np.float32),
                res2=rnd(rng.standard_normal((_M, _COUT))),
                cot=rnd(rng.standard_normal((_M, _COUT))))


def _jax_args(a, res):
    return (jnp.asarray(a["x2"], jnp.float16),
            jnp.asarray(a["w"], jnp.float16), jnp.asarray(a["scale"]),
            jnp.asarray(a["shift"]),
            jnp.asarray(a["res2"], jnp.float16) if res else None)


def _torch_args(a, res, grad=False):
    mk = lambda v, dt: torch.tensor(v, dtype=dt,  # noqa: E731
                                    requires_grad=grad)
    h = torch.float16
    return (mk(a["x2"], h), mk(a["w"], h), mk(a["scale"], torch.float32),
            mk(a["shift"], torch.float32),
            mk(a["res2"], h) if res else None)


@pytest.fixture
def fwd_calls(monkeypatch):
    """The reference's calls of ``_fwd_call``, the function that reaches
    ``pl.pallas_call``."""
    calls = []
    real = pallas_cba._fwd_call

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)
    monkeypatch.setattr(pallas_cba, "_fwd_call", spy)
    return calls


@pytest.mark.parametrize("res,overflow", [(False, False), (True, False),
                                          (True, True)],
                         ids=["plain", "residual", "overflow"])
def test_twin_matches_the_pallas_kernel(res, overflow, fwd_calls):
    a = _inputs(1, overflow)
    want = pallas_cba.fused_conv1x1_bn_act(*_jax_args(a, res), True, 0,
                                           True)
    assert fwd_calls == [(_M, _CIN)], "the reference did not reach pallas"
    assert want.dtype == jnp.float16
    if overflow:
        n_inf = int(np.isposinf(_np(want)).sum())
        assert 0 < n_inf < want.size
    args = _torch_args(a, res)
    before = port_cba.fused_conv1x1_bn_act.launches
    for got in (port_cba.conv_bn_act_plain(*args, True),
                port_cba.fused_conv1x1_bn_act(*args, True)):
        assert got.dtype == torch.float16
        _ulps(got, want, f"y res={res} overflow={overflow}")
    assert port_cba.fused_conv1x1_bn_act.launches == before


@pytest.mark.parametrize("res", [True, False])
def test_gradients_match_the_reference_vjp(res):
    """The plain backward at float16 primals: dx, dw (and dres) float16,
    dscale, dshift f32, each against jax.grad through the custom_vjp."""
    a = _inputs(2)
    jargs = _jax_args(a, res)
    cot = jnp.asarray(a["cot"])
    argnums = (0, 1, 2, 3, 4) if res else (0, 1, 2, 3)

    def loss(x2, w, s, b, r=None):
        y = pallas_cba.fused_conv1x1_bn_act(x2, w, s, b, r, True, 0, True)
        return jnp.sum(y.astype(jnp.float32) * cot)

    want = jax.grad(loss, argnums=argnums)(*jargs[:len(argnums)])
    targs = _torch_args(a, res, grad=True)
    y = port_cba.fused_conv1x1_bn_act(*targs, True)
    assert y.grad_fn is not None and y.dtype == torch.float16
    (y.float() * torch.tensor(a["cot"])).sum().backward()
    names = ("dx", "dw", "dscale", "dshift", "dres")
    for name, t, g in zip(names, targs, want):
        assert t.grad.dtype == t.dtype, name
        if t.dtype == torch.float16:
            assert g.dtype == jnp.float16, name
            _ulps(t.grad, g, name)
        else:
            _f32(t.grad, g, name)

