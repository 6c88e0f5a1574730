"""The 3xTF32 arithmetic of kernel #11's f32 path, emulated in plain
PyTorch, vs the JAX package's Pallas kernel.

The f32 path of ``paddle_tpu_torch/csrc/conv_bn_act.cu``
(``conv_bn_act_tf32_kernel``) runs the product x @ w on the tensor cores in
TF32: every f32 operand v is split as hi = tf32(v), lo = tf32(v - hi),
with tf32 the rounding of ``cvt.rna.tf32.f32`` (round to nearest, ties
away from zero, on 10 mantissa bits), and each step of 8 input channels
takes lo(w).hi(x), hi(w).lo(x) and hi(w).hi(x), in this order (three wgmma
m64nNk8 products). The four steps of a stage of 32 input channels are
summed apart, and each stage's sum is added to the running f32 sum in
order, zero past Cin. The epilogue is acc * scale + shift (+ res), then the
ReLU as ``jnp.where(y > 0, y, 0)``. The kernel runs only on the card; here
its arithmetic is emulated stage by stage and held against ``_fwd_call`` in
interpret mode, with a ``block_m`` that tiles M, at the f32 bar: 1e-5 of
max(1, |reference|), ragged M, Cin and Cout, with and without the residual
and the ReLU, and one ResNet-50 bottleneck shape at small M. Inside a stage
the emulation sums in f32 with IEEE rounding; the tensor cores' own f32
accumulation drops some low bits more, which the emulation does not model.
"""
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from test_torch_tf32_split import split
from torch_threads import one_torch_thread  # noqa: F401

pallas_cba = importlib.import_module("paddle_tpu.ops.pallas.conv_bn_act")
port_cba = importlib.import_module("paddle_tpu_torch.ops.kernels.conv_bn_act")

_TOL = 1e-5
_STAGE = 32  # input channels a stage of the kernel's loop


def conv_3xtf32(x2, w, scale, shift, res2=None, relu=True):
    """The f32 kernel's y, in plain PyTorch: the product in 3xTF32 over
    steps of 8 input channels, the two small terms first, each stage of 32
    channels summed apart and added to the running sum in order; then the
    epilogue."""
    m, cin = x2.shape
    acc = torch.zeros(m, w.shape[1])
    for s0 in range(0, cin, _STAGE):
        part = torch.zeros_like(acc)
        for k0 in range(s0, min(s0 + _STAGE, cin), 8):
            xh, xl = split(x2[:, k0:k0 + 8])
            wh, wl = split(w[k0:k0 + 8])
            part = part + xh @ wl
            part = part + xl @ wh
            part = part + xh @ wh
        acc = acc + part
    y = acc * scale + shift
    if res2 is not None:
        y = y + res2
    if relu:
        y = torch.where(y > 0, y, torch.zeros_like(y))
    return y


def _block_m(m):
    """The largest divisor of M below M (M itself when it has none): a
    ``block_m`` whose grid tiles M in more than one step where it can."""
    return next((b for b in range(min(m - 1, 128), 0, -1) if m % b == 0
                 and b > 1), m)


def _inputs(m, cin, cout, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, cin)).astype(np.float32),
            (rng.standard_normal((cin, cout)) / np.sqrt(cin)).astype(
                np.float32),
            (1.0 + 0.1 * rng.standard_normal(cout)).astype(np.float32),
            (0.1 * rng.standard_normal(cout)).astype(np.float32),
            rng.standard_normal((m, cout)).astype(np.float32))


def _reference(x2, w, scale, shift, res2, relu):
    """The Pallas ``_fwd_call`` in interpret mode with a ``block_m`` that
    tiles M; ``_reference`` where the Pallas call refuses the shape."""
    args = (jnp.asarray(x2), jnp.asarray(w), jnp.asarray(scale),
            jnp.asarray(shift), None if res2 is None else jnp.asarray(res2))
    try:
        out = pallas_cba._fwd_call(*args, relu, _block_m(x2.shape[0]), True)
    except Exception:  # noqa: BLE001 - any refusal of the shape
        out = pallas_cba._reference(*args, relu)
    return np.asarray(out)


def _close(got, want, what):
    got = got.numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scaled = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert np.isfinite(scaled).all() and scaled.max() <= _TOL, (
        what, scaled.max())


# (M, Cin, Cout): M from 1 to 300, Cin 3 / 64 / 100 / 512 (a ragged last
# step of 8 and of 32), Cout 1 / 9 / 64 / 70 / 256 (one or two tile
# widths, ragged)
SHAPES = [
    (1, 64, 64), (7, 3, 1), (7, 100, 9), (33, 512, 70), (96, 64, 256),
    (130, 3, 70), (130, 100, 64), (200, 64, 9), (257, 512, 1),
    (300, 100, 256), (300, 512, 64), (64, 3, 256), (299, 64, 70),
    (128, 512, 9),
]
CASES = [(True, True), (False, True), (True, False), (False, False)]


@pytest.mark.parametrize("res,relu", CASES)
@pytest.mark.parametrize("m,cin,cout", SHAPES)
def test_3xtf32_matches_pallas(m, cin, cout, res, relu):
    x2, w, scale, shift, r2 = _inputs(m, cin, cout, m + 7 * cin + cout)
    r2 = r2 if res else None
    want = _reference(x2, w, scale, shift, r2, relu)
    got = conv_3xtf32(*(torch.from_numpy(a) for a in (x2, w, scale, shift)),
                      None if r2 is None else torch.from_numpy(r2), relu)
    _close(got, want, f"3xTF32 M={m} {cin}->{cout} res={res} relu={relu}")


@pytest.mark.parametrize("m,cin,cout,res", [(392, 64, 256, True),
                                            (392, 256, 64, False)])
def test_bottleneck_shape_at_small_m(m, cin, cout, res, monkeypatch):
    """A ResNet-50 layer1 bottleneck's conv3 (64 -> 256, + the shortcut)
    and the next block's conv1 (256 -> 64) at batch 2 x 14 x 14: the
    emulation and the port's twin (what the wrapper runs on the CPU) both
    within the f32 bar of the Pallas kernel, which a spy shows reached."""
    calls = []
    real = pallas_cba._fwd_call

    def spy(*args, **kwargs):
        calls.append(args[6])
        return real(*args, **kwargs)
    monkeypatch.setattr(pallas_cba, "_fwd_call", spy)
    x2, w, scale, shift, r2 = _inputs(m, cin, cout, 3)
    r2 = r2 if res else None
    want = _reference(x2, w, scale, shift, r2, True)
    assert calls == [_block_m(m)] and m % calls[0] == 0 and calls[0] < m
    targs = [torch.from_numpy(a) for a in (x2, w, scale, shift)]
    tres = None if r2 is None else torch.from_numpy(r2)
    _close(conv_3xtf32(*targs, tres), want, "3xTF32 bottleneck")
    before = port_cba.fused_conv1x1_bn_act.launches
    _close(port_cba.fused_conv1x1_bn_act(*targs, tres), want,
           "the wrapper's twin on the CPU")
    assert port_cba.fused_conv1x1_bn_act.launches == before


@pytest.mark.parametrize("cin", [512, 2048])
def test_3xtf32_error_against_float64(cin):
    """The dropped lo.lo term and the f32 sums leave the emulated product
    near 1e-6 of float64's at ResNet-50's widest Cin, inside the 1e-5 f32
    bar: the kernel on the H100 reads 1.2e-6 to 2.2e-6 there."""
    x2, w, scale, shift, r2 = _inputs(256, cin, 128, 11)
    got = conv_3xtf32(*(torch.from_numpy(a) for a in (x2, w, scale, shift)),
                      torch.from_numpy(r2), False)
    exact = (x2.astype(np.float64) @ w.astype(np.float64)) * scale + shift \
        + r2
    err = np.abs(got.numpy() - exact) / np.maximum(1.0, np.abs(exact))
    assert err.max() <= 5e-6, err.max()
