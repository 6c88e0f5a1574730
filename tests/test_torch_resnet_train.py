"""Training ResNet with the PyTorch port vs the JAX package.

Weights cross from the reference into the port through numpy
(``load_numpy_state``), with every BatchNorm's statistics and affine
parameters drawn at random from a numpy seed (at 0/1/1/0 a wrong fold
would hide). Inputs are numpy arrays from a seed. Checked on the CPU:

- ``optimizer.Momentum`` (plain, Nesterov, coupled weight decay) against
  the reference's ``Momentum.update``, step by step over 5 steps with the
  same gradients (f32 within 1e-5 of max(1, |reference|)); the eager
  ``step()`` and ``Engine``'s ``_apply`` give the same parameters;
- ``nn.CrossEntropyLoss`` against the reference's (mean, sum, none,
  ``ignore_index``; f32 within 1e-5, bf16 logits within 1e-2), and its
  keywords that are not ported raise naming ROADMAP.md queue 1 item 1.6;
- a fused ``BottleneckBlock`` in training (batch statistics through
  ``conv1x1_batch_stats``, the 1x1 chains through
  ``fused_conv1x1_bn_act``; the reference's through the Pallas kernel in
  interpret mode), for a block whose conv1 fuses (128 -> 128, with a
  downsample) and one whose conv1 contracts (512 -> 128), which both
  packages run through the plain ops: the output and ``bn1``/``bn3``
  running statistics within 1e-5 (f32) and 1e-2 (bf16) of max(1,
  |reference|), and the gradients of ``conv1.weight``, ``conv3.weight``,
  ``bn1.weight``, ``bn3.weight`` and ``bn3.bias`` within as much of
  max(1, their max-abs);
- ``s2d_stem``: ``s2d_weights_from_7x7`` equal to the reference's, the
  stem equal to the 7x7/2 conv in both layouts and to the reference's
  stem, resnet50 with it in NHWC equal to NCHW, odd sizes raising.

``resnet50`` in training is held in tests/test_torch_resnet.py, beside the
other tests of the reference resnet50 (whose eager build takes most of a
minute), and the Engine steps in tests/test_torch_resnet_steps.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jax_nn
from paddle_tpu.nn.layer import functional_call as jax_functional_call
from paddle_tpu.nn.layers_conv import to_channels_last as jax_channels_last
from paddle_tpu.ops.pallas import conv_bn_act as pallas_cba
from paddle_tpu.optimizer import Momentum as JaxMomentum
from paddle_tpu.vision.models import resnet as jax_resnet
from paddle_tpu_torch import nn as port_nn
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision.models import resnet as port_resnet
from torch_threads import one_torch_thread  # noqa: F401


def _np(t):
    return np.asarray(jnp.asarray(t._value if hasattr(t, "_value") else t,
                                  jnp.float32))


def _scaled_err(got, want):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    want = _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())


def _close(got, want, tol=1e-5, what=""):
    err = _scaled_err(got, want)
    assert err <= tol, (what, err)


def _grad_close(got, want, tol, what=""):
    """A gradient within tol of max(1, its max-abs), as the reference's own
    fused-bottleneck gradient test holds it: the batch statistics' backward
    sums over the rows in another order than XLA's, and an element's error
    follows the largest elements, not its own size."""
    got = got.detach().float().numpy()
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, (what, err)


def _randomized_state(jm, seed):
    """The reference module's state as numpy, every BatchNorm's statistics
    and affine parameters drawn at random, set back into the reference."""
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in jm.state_dict().items():
        a = np.asarray(v._value, np.float32)
        if k.endswith("_variance"):
            a = rng.uniform(0.5, 1.5, a.shape)
        elif k.endswith(("_mean", "bias")):
            a = 0.1 * rng.standard_normal(a.shape)
        elif a.ndim == 1:  # a BatchNorm weight
            a = 1.0 + 0.1 * rng.standard_normal(a.shape)
        state[k] = a.astype(np.float32)
    jm.set_state_dict(state)
    return state


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _nhwc(x):
    return np.ascontiguousarray(x.transpose(0, 2, 3, 1))


# -- Momentum -----------------------------------------------------------------

MOMENTUM_CASES = {
    "plain": dict(),
    "nesterov": dict(use_nesterov=True),
    "weight_decay": dict(weight_decay=0.01),
}


@pytest.mark.parametrize("case", sorted(MOMENTUM_CASES))
def test_momentum_matches_the_reference(case):
    kw = MOMENTUM_CASES[case]
    rng = np.random.default_rng(7)
    shapes = {"w": (4, 6), "b": (6,), "k": (1, 1, 3, 5)}
    start = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    ref = JaxMomentum(0.1, momentum=0.9, **kw)
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    jstate = ref.init_state(jp)
    params = [torch.tensor(start[k], requires_grad=True) for k in shapes]
    opt = Momentum(0.1, momentum=0.9, parameters=zip(shapes, params), **kw)
    twin = [torch.tensor(start[k]) for k in shapes]
    engine_side = Momentum(0.1, momentum=0.9, **kw)
    for i, g in enumerate(grads, start=1):
        jp, jstate = ref.update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                                jstate, 0.1, i)
        for p, k in zip(params, shapes):
            p.grad = torch.from_numpy(g[k])
        opt.step()
        engine_side._apply(list(shapes), twin,
                           [torch.from_numpy(g[k]) for k in shapes], 0.1, i)
        for p, t, k in zip(params, twin, shapes):
            _close(p, jp[k], what=f"{case} step {i} {k}")
            _close(opt._state[k]["velocity"], jstate["velocity"][k],
                   what=f"{case} step {i} velocity {k}")
            torch.testing.assert_close(p.detach(), t, atol=0, rtol=0)
    assert all(s["velocity"].dtype == torch.float32
               for s in opt._state.values())


def test_momentum_parameter_groups_raise():
    w = torch.zeros(2, requires_grad=True)
    with pytest.raises(NotImplementedError, match="queue 1 item 1.8"):
        Momentum(0.1, parameters=[{"params": [w], "learning_rate": 0.5}])


# -- CrossEntropyLoss ---------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_loss_matches_the_reference(reduction, dtype, tol):
    rng = np.random.default_rng(8)
    logits = (3 * rng.standard_normal((6, 1000))).astype(np.float32)
    labels = rng.integers(0, 1000, (6,)).astype(np.int64)
    labels[2] = 7
    want = jax_nn.CrossEntropyLoss(ignore_index=7, reduction=reduction)(
        paddle.to_tensor(jnp.asarray(logits, dtype)),
        paddle.to_tensor(labels))
    got = port_nn.CrossEntropyLoss(ignore_index=7, reduction=reduction)(
        torch.from_numpy(logits).to(getattr(torch, dtype)),
        torch.from_numpy(labels))
    _close(got, want, tol=tol, what=reduction)
    if reduction == "none":
        assert float(got[2]) == 0.0


@pytest.mark.parametrize("kw", [dict(weight=torch.ones(3)),
                                dict(soft_label=True),
                                dict(use_softmax=False),
                                dict(label_smoothing=0.1)],
                         ids=["weight", "soft_label", "use_softmax",
                              "label_smoothing"])
def test_cross_entropy_loss_keywords_not_ported_raise(kw):
    with pytest.raises(NotImplementedError, match="queue 1 item 1.6"):
        port_nn.CrossEntropyLoss(**kw)


# -- the train-mode fused bottleneck ------------------------------------------

def _downsample(nn_mod, cin, cout, **kw):
    return nn_mod.Sequential(
        nn_mod.Conv2D(cin, cout, 1, bias_attr=False, **kw),
        nn_mod.BatchNorm2D(cout, **kw))


# (inplanes, planes, downsample): conv1 128 -> 128 fuses, conv3 128 -> 512
# fuses; conv1 512 -> 128 contracts and runs the plain ops in both packages
BLOCKS = {"conv1_fused": (128, 128, True), "conv1_contracting": (512, 128,
                                                                  False)}


def _fused_blocks(case, seed=3):
    inplanes, planes, down = BLOCKS[case]
    paddle.seed(seed)
    jm = jax_resnet.BottleneckBlock(
        inplanes, planes,
        downsample=_downsample(jax_nn, inplanes, 4 * planes) if down
        else None)
    pm = port_resnet.BottleneckBlock(
        inplanes, planes,
        downsample=_downsample(port_nn, inplanes, 4 * planes, device="cpu")
        if down else None, device="cpu")
    jax_channels_last(jm)
    port_nn.to_channels_last(pm)
    jm._fused = pm._fused = True
    load_numpy_state(pm, _randomized_state(jm, seed))
    return jm, pm


GRAD_KEYS = ("conv1.weight", "conv3.weight", "bn1.weight", "bn3.weight",
             "bn3.bias")


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_train_fused_bottleneck_matches_the_reference(case, dtype, tol,
                                                      monkeypatch):
    jm, pm = _fused_blocks(case)
    jm.train()
    pm.train()
    if dtype == "bfloat16":
        # the parameters in bf16 and the running statistics f32, as under
        # an AMP step
        for p in jm.parameters():
            p._value = p._value.astype(jnp.bfloat16)
        for p in pm.parameters():
            p.data = p.data.to(torch.bfloat16)
    x = _nhwc(_x((2, BLOCKS[case][0], 4, 4), seed=4))
    jx = jnp.asarray(x, dtype)
    params, buffers = jm.raw_state()

    def loss_fn(pp):
        out = jax_functional_call(jm, pp, buffers, paddle.Tensor(jx))
        return jnp.sum(jnp.square(out._value.astype(jnp.float32)))
    # op by op, as the port runs: under jit XLA keeps a bf16 chain's
    # intermediates in f32 and moves outputs near 0 across the ReLU
    want_grads = jax.grad(loss_fn)(params)
    reached = []
    real = pallas_cba._fwd_call
    monkeypatch.setattr(pallas_cba, "_fwd_call",
                        lambda *a: reached.append(1) or real(*a))
    calls = []
    real_port = port_resnet.fused_conv1x1_bn_act
    monkeypatch.setattr(port_resnet, "fused_conv1x1_bn_act",
                        lambda *a: calls.append(1) or real_port(*a))
    want = jm(paddle.Tensor(jx))  # eager: updates the running statistics

    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = pm(xt)
    got.float().square().sum().backward()
    fused = 2 if case == "conv1_fused" else 1
    assert len(calls) == fused and len(reached) == fused
    assert got.dtype == xt.dtype
    _close(got, want, tol=tol, what="y")
    for bn in ("bn1", "bn3"):
        for stat in ("_mean", "_variance"):
            _close(getattr(getattr(pm, bn), stat),
                   getattr(getattr(jm, bn), stat), tol=tol,
                   what=f"{bn}.{stat}")
    state = dict(pm.named_parameters())
    for k in GRAD_KEYS:
        g = state[k].grad
        assert g is not None and g.dtype == xt.dtype, k
        _grad_close(g, want_grads[k], tol, what=f"grad {k}")


# -- s2d_stem -----------------------------------------------------------------

def test_s2d_weights_match_the_reference():
    w7 = np.random.default_rng(11).standard_normal((16, 3, 7, 7)).astype(
        np.float32)
    np.testing.assert_array_equal(port_resnet.s2d_weights_from_7x7(w7),
                                  jax_resnet.s2d_weights_from_7x7(w7))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_s2d_stem_equals_the_7x7_conv(layout):
    conv7 = port_nn.Conv2D(3, 16, 7, stride=2, padding=3, bias_attr=False,
                           device="cpu")
    stem = port_resnet.SpaceToDepthStem(16, device="cpu")
    with torch.no_grad():
        stem.conv.weight.copy_(torch.from_numpy(
            port_resnet.s2d_weights_from_7x7(conv7.weight.numpy())))
    jstem = jax_resnet.SpaceToDepthStem(16)
    jstem.set_state_dict({"conv.weight": stem.conv.weight.detach().numpy()})
    x = _x((2, 3, 32, 32), seed=12)
    if layout == "NHWC":
        for m in (conv7, stem):
            port_nn.to_channels_last(m)
        jax_channels_last(jstem)
        x = _nhwc(x)
    with torch.no_grad():
        want = conv7(torch.from_numpy(x))
        got = stem(torch.from_numpy(x))
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    _close(got, jstem(paddle.to_tensor(x)), what="reference stem")


def test_resnet50_s2d_stem_layouts_agree():
    """The port's counterpart of the reference's
    test_resnet50_s2d_stem_nhwc_parity: one state, NCHW against converted
    to NHWC (the stem's kernel re-stored HWIO)."""
    paddle.seed(0)
    nchw = port_resnet.resnet50(num_classes=8, s2d_stem=True, layout="NCHW",
                                device="cpu").eval()
    nhwc = port_resnet.resnet50(num_classes=8, s2d_stem=True, layout="NCHW",
                                device="cpu").eval()
    nhwc.load_state_dict(nchw.state_dict())
    nhwc.convert_to_nhwc()
    assert nhwc.conv1.conv.weight.shape == (4, 4, 12, 64)
    x = torch.from_numpy(_x((2, 3, 32, 32), seed=14))
    with torch.no_grad():
        torch.testing.assert_close(nhwc(x), nchw(x), atol=2e-4, rtol=1e-4)


def test_s2d_stem_rejects_odd_sizes():
    m = port_resnet.resnet18(s2d_stem=True, device="cpu")
    assert "conv1.conv.weight" in m.state_dict()
    with pytest.raises(ValueError, match="even input"):
        m(torch.zeros(1, 3, 33, 32))
    stem = port_nn.to_channels_last(
        port_resnet.SpaceToDepthStem(8, device="cpu"))[0]
    with pytest.raises(ValueError, match="even input"):
        stem(torch.zeros(1, 32, 31, 3))
