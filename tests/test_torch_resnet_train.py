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
- ``resnet50`` fused NHWC in training at 2 x 3 x 48 x 48: logits within
  1e-3 and running statistics within 1e-4 (BatchNorm over 8 rows at
  layer4; see the test), and the 17 fused chains of a training forward
  against the reference's 7 ``_fwd_call`` launches;
- three ``Engine.train_batch`` steps of ``ResNet(BottleneckBlock, 18)``,
  fused NHWC, Momentum(0.1, 0.9), in f32 and under bf16 AMP, each from the
  reference's state: losses, running statistics (f32 under bf16) and the
  classifier element by element, the other leaves' updates by their
  relative L2 norm (ReLU kinks; see ``_UPDATE_TOL``);
- ``s2d_stem``: ``s2d_weights_from_7x7`` equal to the reference's, the
  stem equal to the 7x7/2 conv in both layouts and to the reference's
  stem, resnet50 with it in NHWC equal to NCHW, odd sizes raising.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jax_nn
from paddle_tpu.hapi.engine import Engine as JaxEngine
from paddle_tpu.nn.layer import functional_call as jax_functional_call
from paddle_tpu.nn.layers_conv import to_channels_last as jax_channels_last
from paddle_tpu.ops.pallas import conv_bn_act as pallas_cba
from paddle_tpu.optimizer import Momentum as JaxMomentum
from paddle_tpu.vision.models import resnet as jax_resnet
from paddle_tpu_torch import nn as port_nn
from paddle_tpu_torch.hapi import Engine
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.ops.kernels import conv_bn_act as port_cba
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision.models import resnet as port_resnet


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


# -- resnet50 in training -----------------------------------------------------

def test_resnet50_train_forward_matches_the_reference(monkeypatch):
    """Fused NHWC resnet50 (8 classes) at 2 x 3 x 48 x 48, training: 48 px
    keeps layer4 at 2 x 2 so the batch statistics are well conditioned."""
    paddle.seed(0)
    jm = jax_resnet.resnet50(num_classes=8, layout="NHWC",
                             fused_bottleneck=True)
    state = _randomized_state(jm, seed=5)
    pm = port_resnet.resnet50(num_classes=8, layout="NHWC",
                              fused_bottleneck=True, device="cpu")
    load_numpy_state(pm, state)
    jm.train()
    pm.train()
    reached = []
    real = pallas_cba._fwd_call
    monkeypatch.setattr(pallas_cba, "_fwd_call",
                        lambda *a: reached.append(1) or real(*a))
    x = _x((2, 3, 48, 48), seed=6)
    want = jm(paddle.to_tensor(x))
    port_cba.fused_conv1x1_bn_act.launches = 0
    calls = []
    real_port = port_resnet.fused_conv1x1_bn_act
    monkeypatch.setattr(port_resnet, "fused_conv1x1_bn_act",
                        lambda *a: calls.append(1) or real_port(*a))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    # layer1.0's conv1 (64 -> 64) and the sixteen conv3s. The reference
    # sends 10 of them to jnp (its _supported and _pick_block_m): layer1's
    # four (Cin = 64) and layer3's six (M = 2 x 3 x 3 = 18 rows, not a
    # multiple of 8)
    assert len(calls) == 17 and len(reached) == 7
    assert port_cba.fused_conv1x1_bn_act.launches == 0  # the CPU twin
    # BatchNorm over 8 rows at layer4 magnifies f32 reduction order: at
    # this input each package's logits sit 3e-4 to 7e-4 of max(1, |x|) from
    # a float64 run (measured: the reference fused 6.3e-4, the port fused
    # 3.4e-4, both unfused ~1.7e-4), and the reference's own test holds its
    # two layouts to 2e-3 of the max-abs here; the running statistics take
    # the training-step bar of 1e-4 (layer4.2.bn3's variance: 1.3e-5)
    _close(got, want, tol=1e-3, what="logits")
    for k in ("bn1", "layer2.0.bn3", "layer4.2.bn3"):
        for stat in ("_mean", "_variance"):
            mod_p, mod_j = pm, jm
            for part in k.split("."):
                mod_p = getattr(mod_p, part) if not part.isdigit() \
                    else mod_p[int(part)]
                mod_j = getattr(mod_j, part) if not part.isdigit() \
                    else mod_j[int(part)]
            _close(getattr(mod_p, stat), getattr(mod_j, stat), tol=1e-4,
                   what=f"{k}.{stat}")


# -- Engine steps -------------------------------------------------------------

_LR, _STEPS = 0.1, 3


@pytest.fixture(scope="module")
def resnet18_bottleneck():
    """ResNet(BottleneckBlock, 18, num_classes=10) fused NHWC from the
    reference (seed 0, random BatchNorm statistics), its state and one
    batch of 4 x 3 x 64 x 64 with labels."""
    paddle.seed(0)
    jm = jax_resnet.ResNet(jax_resnet.BottleneckBlock, 18, num_classes=10,
                           layout="NHWC", fused_bottleneck=True)
    state = _randomized_state(jm, seed=9)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((4, 3, 64, 64)).astype(np.float32)
    y = rng.integers(0, 10, (4,)).astype(np.int64)
    return state, x, y


def _engines(state, amp):
    """The reference Engine and the port's, each over its package's
    ResNet(BottleneckBlock, 18) loaded from ``state``, with
    Momentum(0.1, 0.9) and cross entropy."""
    jm = jax_resnet.ResNet(jax_resnet.BottleneckBlock, 18, num_classes=10,
                           layout="NHWC", fused_bottleneck=True)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    jm.train()
    jeng = JaxEngine(jm, loss=jax_nn.CrossEntropyLoss(),
                     optimizer=JaxMomentum(_LR, momentum=0.9,
                                           parameters=jm.parameters()),
                     amp_dtype=jnp.bfloat16 if amp else None)
    pm = port_resnet.ResNet(port_resnet.BottleneckBlock, 18, num_classes=10,
                            layout="NHWC", fused_bottleneck=True,
                            device="cpu")
    load_numpy_state(pm, state)
    opt = Momentum(_LR, momentum=0.9, parameters=pm.named_parameters())
    peng = Engine(pm, loss=port_nn.CrossEntropyLoss(), optimizer=opt,
                  amp_dtype="bfloat16" if amp else None)
    return jm, jeng, pm, opt, peng


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                     1e-30))


# A ReLU input within the f32 forward's error of 0 (~1e-4 at layer4 here,
# against float64) lands on the other side of the kink in the other
# package, and the gradient of its (row, channel) changes, with it every
# gradient upstream of it. Measured at this seed on step 1: the reference's
# own fused and unfused models differ by up to 1.9e-2 (relative L2, layer
# 2's BatchNorm weights), the reference against a float64 run by 1.65e-2,
# the port's fused model against float64 by 2.9e-5. So the update of a
# leaf below a ReLU is held by its relative L2 norm, the loss, the running
# statistics and the classifier (no ReLU after it) element by element,
# and in f32 the first step's gradients against a float64 step of the
# unfused model: the port's worst leaf no farther from it than the
# reference's (or 1e-4).
#
# Under bf16 AMP both packages are far from float64 (median relative L2 of
# a leaf's gradient 0.83 in each, the port against the reference 0.54):
# the batch statistics' backward over 16 to 1024 rows of bf16 values
# cancels most of its input. The loss and the classifier stay within
# 1e-2; a running variance over 16 rows whose mean^2 is ~20x the variance
# loses ~16 % of the batch variance to bf16 rounding (1.8e-2 of the
# running value, measured), so the statistics are held to 5e-2; an
# update to a relative L2 of 0.9 (a zero or reversed update scores 1 or
# 2).
_UPDATE_TOL = {False: 5e-2, True: 0.9}
_STATS_TOL = {False: 1e-5, True: 5e-2}


@pytest.mark.parametrize("amp,tol", [(False, 1e-5), (True, 1e-2)])
def test_engine_steps_match_the_reference(resnet18_bottleneck, amp, tol):
    """Three Engine steps, each from the reference's state (parameters,
    running statistics and velocity carried across before the next): with
    lr 0.1 the first step takes the loss from 3.3 to ~33, and from there
    BatchNorm over 4 images makes the two trajectories part."""
    state, x, y = resnet18_bottleneck
    jm, jeng, pm, opt, peng = _engines(state, amp)
    if not amp:
        exact = port_resnet.ResNet(port_resnet.BottleneckBlock, 18,
                                   num_classes=10, layout="NHWC",
                                   device="cpu", dtype=torch.float64)
        load_numpy_state(exact, state)
        port_nn.CrossEntropyLoss()(exact(torch.from_numpy(x).double()),
                                   torch.from_numpy(y)).backward()
        g64 = {k: p.grad.numpy() for k, p in exact.named_parameters()}
    for step in range(1, _STEPS + 1):
        before = {k: v.detach().float().numpy().copy()
                  for k, v in pm.state_dict().items()}
        jl = float(jeng.train_batch([jnp.asarray(x)], [jnp.asarray(y)])[0])
        pl = float(peng.train_batch([x], [y])[0])
        assert abs(pl - jl) <= tol * abs(jl), (step, pl, jl)
        jstate = {k: np.asarray(v._value, np.float32)
                  for k, v in jm.state_dict().items()}
        pstate = pm.state_dict()
        assert set(pstate) == set(jstate)
        for k, v in pstate.items():
            what = f"step {step} {k}"
            if k.endswith(("_mean", "_variance")):
                assert v.dtype == torch.float32, what
                assert not np.array_equal(v.numpy(), before[k]), what
                _close(v, jstate[k], tol=_STATS_TOL[amp], what=what)
            elif k.startswith("fc."):
                _close(v, jstate[k], tol=tol, what=what)
            else:
                err = _rel_l2(v.detach().numpy() - before[k],
                              jstate[k] - before[k])
                assert err <= _UPDATE_TOL[amp], (what, err)
        if step == 1 and not amp:
            # the velocity after the first step is the gradient: the
            # port's sits as close to float64's as the reference's does
            far = {side: max(_rel_l2(np.asarray(v, np.float64), g64[k])
                             for k, v in vel.items())
                   for side, vel in (
                       ("port", {k: s["velocity"].numpy()
                                 for k, s in opt._state.items()}),
                       ("reference", jeng._opt_state["velocity"]))}
            assert far["port"] <= max(far["reference"], 1e-4), far
        load_numpy_state(pm, jstate)
        for k, vel in jeng._opt_state["velocity"].items():
            opt._state[k]["velocity"].copy_(
                torch.tensor(np.asarray(vel, np.float32)))


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
