"""Fused 1x1-conv + BatchNorm + ReLU (+ residual) of the PyTorch port vs
the JAX package.

The port's plain twin (``ops.kernels.conv_bn_act.conv_bn_act_plain``) and
its wrapper (which runs the twin on the CPU) are held against the Pallas
kernel of ``paddle_tpu/ops/pallas/conv_bn_act.py`` run in interpret mode on
the same numpy inputs, at shapes where the reference reaches
``pl.pallas_call`` (Cin and Cout multiples of 128, M a multiple of 8; a
spy on ``_fwd_call`` shows it), with and without the residual, ReLU on and
off: f32 within 1e-5, bf16 within 1e-2 of max(1, |reference|). The
autograd function's gradients (dx, dw, dscale, dshift, dres) are held
against ``jax.grad`` through the reference's custom_vjp, f32 within 1e-5
of max(1, |reference|), at a tiling shape and a ragged one; in bf16 each
gradient comes back in its primal's dtype. ``conv1x1_batch_stats`` is held
against the reference's. The wrapper raises on what the kernel does not
take, on every device, and on the CPU it counts no launch.

The CUDA kernel itself is checked against the twin on the card by
chip_smoke.py (phase 19).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas import conv_bn_act as pallas_cba
from paddle_tpu_torch.ops.kernels import WRAPPERS
from paddle_tpu_torch.ops.kernels import conv_bn_act as port_cba
from torch_threads import one_torch_thread  # noqa: F401

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _inputs(m, cin, cout, dtype, seed=0):
    """x2, w, scale, shift, res2 and a cotangent as numpy f32, rounded to
    ``dtype`` where they are stored in it (scale and shift stay f32)."""
    rng = np.random.default_rng(seed)
    jdt = _DT[dtype][0]
    rnd = lambda a: np.asarray(  # noqa: E731
        jnp.asarray(a, jdt).astype(jnp.float32))
    return dict(x2=rnd(rng.standard_normal((m, cin))),
                w=rnd(rng.standard_normal((cin, cout)) / np.sqrt(cin)),
                scale=(1.0 + 0.1 * rng.standard_normal(cout)).astype(
                    np.float32),
                shift=(0.1 * rng.standard_normal(cout)).astype(np.float32),
                res2=rnd(rng.standard_normal((m, cout))),
                cot=rnd(rng.standard_normal((m, cout))))


def _jax_args(a, dtype, res):
    jdt = _DT[dtype][0]
    return (jnp.asarray(a["x2"], jdt), jnp.asarray(a["w"], jdt),
            jnp.asarray(a["scale"]), jnp.asarray(a["shift"]),
            jnp.asarray(a["res2"], jdt) if res else None)


def _torch_args(a, dtype, res, grad=False):
    tdt = _DT[dtype][1]
    mk = lambda v, dt: torch.tensor(v, dtype=dt,  # noqa: E731
                                    requires_grad=grad)
    return (mk(a["x2"], tdt), mk(a["w"], tdt), mk(a["scale"], torch.float32),
            mk(a["shift"], torch.float32),
            mk(a["res2"], tdt) if res else None)


def _close(got, want, dtype, what, tol=None):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scaled = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert scaled.max() <= (tol or _TOL[dtype]), (what, scaled.max())


@pytest.fixture
def fwd_calls(monkeypatch):
    """Counts the reference's calls of ``_fwd_call``, the function that
    reaches ``pl.pallas_call``."""
    calls = []
    real = pallas_cba._fwd_call

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)
    monkeypatch.setattr(pallas_cba, "_fwd_call", spy)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("res,relu", [(False, True), (True, True),
                                      (True, False), (False, False)])
def test_twin_matches_the_pallas_kernel(dtype, res, relu, fwd_calls):
    a = _inputs(256, 128, 256, dtype)
    want = pallas_cba.fused_conv1x1_bn_act(*_jax_args(a, dtype, res), relu,
                                           0, True)
    assert fwd_calls == [(256, 128)], "the reference did not reach pallas"
    assert want.dtype == _DT[dtype][0]
    args = _torch_args(a, dtype, res)
    before = port_cba.fused_conv1x1_bn_act.launches
    for got in (port_cba.conv_bn_act_plain(*args, relu),
                port_cba.fused_conv1x1_bn_act(*args, relu)):
        assert got.dtype == _DT[dtype][1]
        _close(got, want, dtype, f"y {dtype} res={res} relu={relu}")
    assert port_cba.fused_conv1x1_bn_act.launches == before


@pytest.mark.parametrize("m,cin,cout", [(64, 128, 256), (7, 3, 5)])
@pytest.mark.parametrize("res", [True, False])
def test_gradients_match_the_reference_vjp(m, cin, cout, res):
    a = _inputs(m, cin, cout, "float32", seed=1)
    jargs = _jax_args(a, "float32", res)
    cot = jnp.asarray(a["cot"])
    argnums = (0, 1, 2, 3, 4) if res else (0, 1, 2, 3)

    def loss(x2, w, s, b, r=None):
        y = pallas_cba.fused_conv1x1_bn_act(x2, w, s, b, r, True, 0, True)
        return jnp.sum(y * cot)

    want = jax.grad(loss, argnums=argnums)(*jargs[:len(argnums)])
    targs = _torch_args(a, "float32", res, grad=True)
    y = port_cba.fused_conv1x1_bn_act(*targs, True)
    assert y.grad_fn is not None
    (y * torch.tensor(a["cot"])).sum().backward()
    names = ("dx", "dw", "dscale", "dshift", "dres")
    for name, t, g in zip(names, targs, want):
        _close(t.grad, g, "float32", f"{name} m{m} {cin}->{cout}")


def test_bf16_gradients_come_back_in_the_primal_dtypes():
    a = _inputs(32, 16, 24, "bfloat16", seed=2)
    targs = _torch_args(a, "bfloat16", True, grad=True)
    y = port_cba.fused_conv1x1_bn_act(*targs, True)
    assert y.dtype == torch.bfloat16
    (y.float() * torch.tensor(a["cot"])).sum().backward()
    for t in targs:
        assert t.grad is not None and t.grad.dtype == t.dtype, t.dtype
        assert t.grad.shape == t.shape


def test_batch_stats_match_the_reference():
    rng = np.random.default_rng(3)
    x2 = rng.standard_normal((96, 32)).astype(np.float32) + 0.5
    w = (rng.standard_normal((32, 128)) / 6).astype(np.float32)
    want = pallas_cba.conv1x1_batch_stats(jnp.asarray(x2), jnp.asarray(w))
    got = port_cba.conv1x1_batch_stats(torch.tensor(x2), torch.tensor(w))
    for g, r, name in zip(got, want, ("mean", "var")):
        assert g.dtype == torch.float32
        _close(g, r, "float32", name)
    direct = torch.tensor(x2) @ torch.tensor(w)
    _close(got[1], direct.var(0, correction=0).numpy(), "float32",
           "var vs the product's own", tol=1e-4)


def test_wrapper_is_listed_and_raises_on_what_the_kernel_does_not_take():
    fn = port_cba.fused_conv1x1_bn_act
    assert fn in WRAPPERS
    x2, w = torch.ones(8, 16), torch.ones(16, 4)
    s, b = torch.ones(4), torch.zeros(4)
    before = fn.launches
    for dt in (torch.float64, torch.int32):
        with pytest.raises(TypeError, match="kernel takes"):
            fn(x2.to(dt), w.to(dt), s, b)
    with pytest.raises(ValueError, match="w is"):
        fn(x2, w.bfloat16(), s, b)
    with pytest.raises(ValueError, match="scale is"):
        fn(x2, w, s.bfloat16(), b)
    with pytest.raises(ValueError, match="res2 is"):
        fn(x2, w, s, b, torch.ones(8, 5))
    with pytest.raises(ValueError, match="are not"):
        fn(x2, torch.ones(15, 4), s, b)
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.ones(16, 8).t(), w, s, b)
    assert fn(x2, w, s, b).shape == (8, 4)
    assert fn.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        fn(x2.to("meta"), w.to("meta"), s.to("meta"), b.to("meta"))
