"""The classification zoo of the PyTorch port vs the JAX package: the
shallow families, their substrate, ``pretrained=<path>`` and training.

The reference's weights cross into the port through numpy
(``nlp.convert.load_numpy_state``, strictly, key for key), with every
BatchNorm statistic and affine parameter and every bias drawn at random
from a numpy seed: at their initial values a wrong BatchNorm wiring hides.
Each reference model is built once a module (its eager build compiles
every initializer's shape, ~10 s a family) and run through
``tests.conftest.jit_forward``, one compile a model. On the CPU:

- ``relu6``, ``hardswish``, ``swish`` and their layers, ``avg_pool2d``
  (exclusive and not, ``ceil_mode``, uneven padding, NHWC) and
  ``adaptive_avg_pool2d`` to outputs larger than the input, vs the
  reference's functions within 1e-6;
- every shallow family once, at the smallest member and the input size of
  the reference's ``test_vision_models.py`` (AlexNet at 64 instead of 96:
  every stride still passes, and the (6, 6) pool then reads a 1 x 1 map),
  batch 2, eval: ``vgg11``, ``alexnet``, ``squeezenet1_0`` and ``1_1``,
  ``mobilenet_v1``/``v2`` at scale 0.25, ``mobilenet_v3_small`` at 0.5 and
  ``shufflenet_v2_x0_25``: logits within 1e-5 of max(1, |reference|);
- MobileNetV2 in training (batch statistics) at 2 x 3 x 96 x 96, every
  ``Dropout``'s ``p`` set to 0 on both sides (the two packages draw masks
  from different generators): logits within 1e-4 of max(1, |reference|),
  the bar of a whole deep model: batch statistics over the last 3 x 3
  maps magnify rounding (each package measured ~1.2e-5 from a float64
  forward, 2.3e-5 from each other; at 64 px, 2 x 2 maps, 8.9e-5);
- two ``Engine`` steps of ``mobilenet_v2(scale=0.25)`` at 8 x 3 x 32 x 32
  with Adam, each from the reference's state, against the reference
  Engine: losses within 1e-5 relative, running statistics within 1e-5,
  the first step's gradients against float64, parameters within 1e-5
  but where a gradient lies within rounding of 0 (see ``_APART`` for
  why); and the reference's ``test_mobilenet_trains`` on
  the port;
- ``pretrained=<path>``: a file the reference wrote (``paddle_tpu.save``
  of a reference model's state) loads into the port's factory and gives
  the reference's logits.

The deep families (DenseNet, GoogLeNet, Inception v3) are held in
tests/test_torch_zoo_deep.py, and the reference's other zoo cases with
every factory's ``pretrained=<path>`` in tests/test_torch_zoo_pretrained.py,
so that xdist's ``--dist loadfile`` runs them on other workers.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jax_nn
from paddle_tpu.hapi.engine import Engine as JaxEngine
from paddle_tpu.nn import functional as jax_F
from paddle_tpu.vision import models as JM
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as port_nn
from paddle_tpu_torch.hapi import Engine
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.nn import functional as port_F
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.vision import models as PM
from tests.conftest import jit_forward
from torch_threads import one_torch_thread  # noqa: F401

# name -> (input size, factory keywords): the reference test's _CASES
SHALLOW = {
    "vgg11": (64, {}),
    "alexnet": (64, {}),
    "squeezenet1_0": (64, {}),
    "squeezenet1_1": (64, {}),
    "mobilenet_v1": (64, {"scale": 0.25}),
    "mobilenet_v2": (64, {"scale": 0.25}),
    "mobilenet_v3_small": (64, {"scale": 0.5}),
    "shufflenet_v2_x0_25": (64, {}),
}
F32_TOL = 1e-5
DEEP_TOL = 1e-4
LR = 1e-3


def _np(t):
    return np.asarray(t._value if hasattr(t, "_value") else t, np.float32)


def _close(got, want, tol, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scaled = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert scaled.max() <= tol, (what, float(scaled.max()))


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def randomized_state(jm, seed):
    """The reference module's state as numpy, every BatchNorm statistic,
    affine parameter and bias drawn at random; set back into the
    reference so both sides carry it."""
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


def zero_dropout(jm, pm):
    """Every Dropout's p set to 0 on both sides: the packages draw their
    masks from different generators, so only p = 0 compares."""
    for m in jm.sublayers():
        if isinstance(m, jax_nn.Dropout):
            m.p = 0.0
    for m in pm.modules():
        if isinstance(m, port_nn.Dropout):
            m.p = 0.0


@pytest.fixture(scope="module")
def zoo():
    """(name, cases) -> (reference model in eval, its randomized state),
    each built once a module from seed 0 with 10 classes."""
    cache = {}

    def get(name, cases=SHALLOW):
        if name not in cache:
            hw, kw = cases[name]
            paddle.seed(0)
            jm = getattr(JM, name)(num_classes=10, **kw)
            jm.eval()
            seed = sorted(cases).index(name) + 3
            cache[name] = (jm, randomized_state(jm, seed=seed))
        return cache[name]
    return get


def port_model(name, state, cases=SHALLOW):
    hw, kw = cases[name]
    pm = getattr(PM, name)(num_classes=10, device="cpu", **kw)
    load_numpy_state(pm, state)
    return pm.eval()


# -- the substrate ---------------------------------------------------------------

@pytest.mark.parametrize("fn", ["relu6", "hardswish", "swish"])
def test_activations_match(fn):
    x = _x((4, 5, 6), seed=2) * 5
    want = getattr(jax_F, fn)(paddle.to_tensor(x))
    _close(getattr(port_F, fn)(torch.from_numpy(x)), want, 1e-6, fn)
    layer = {"relu6": "ReLU6", "hardswish": "Hardswish", "swish": "Swish"}
    _close(getattr(port_nn, layer[fn])()(torch.from_numpy(x)),
           getattr(jax_nn, layer[fn])()(paddle.to_tensor(x)), 1e-6, fn)


AVG_CASES = {
    "k3s1p1": dict(kernel_size=3, stride=1, padding=1),
    "k3s1p1_inclusive": dict(kernel_size=3, stride=1, padding=1,
                             exclusive=False),
    "k2s2": dict(kernel_size=2, stride=2),
    "k3s2_ceil": dict(kernel_size=3, stride=2, ceil_mode=True),
    "k3s2p1_ceil_inclusive": dict(kernel_size=3, stride=2, padding=1,
                                  ceil_mode=True, exclusive=False),
    "pad_2n": dict(kernel_size=3, stride=2, padding=[1, 0, 2, 1]),
    "same": dict(kernel_size=3, stride=2, padding="SAME"),
}


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", sorted(AVG_CASES))
def test_avg_pool2d_matches(case, layout):
    kw = AVG_CASES[case]
    x = _x((2, 3, 9, 8) if layout == "NCHW" else (2, 9, 8, 3), seed=3)
    want = jax_F.avg_pool2d(paddle.to_tensor(x), data_format=layout, **kw)
    _close(port_F.avg_pool2d(torch.from_numpy(x), data_format=layout, **kw),
           want, 1e-6, case)
    layer = port_nn.AvgPool2D(data_format=layout, **kw)
    _close(layer(torch.from_numpy(x)), want, 1e-6, case)


@pytest.mark.parametrize("size,out", [(1, (6, 6)), (2, (7, 7)), (3, 4),
                                      (5, (7, 3))])
def test_adaptive_avg_pool2d_past_the_input(size, out):
    """VGG's (7, 7) and AlexNet's (6, 6) over small maps, GoogLeNet's aux
    4: windows repeat cells where the output is larger than the input."""
    x = _x((2, 3, size, size + 1), seed=4)
    want = jax_F.adaptive_avg_pool2d(paddle.to_tensor(x), out)
    _close(port_F.adaptive_avg_pool2d(torch.from_numpy(x), out), want, 1e-6)


def test_depthwise_conv_loads_oihw(zoo):
    """A depthwise Conv2D's kernel is OIHW [out, in / groups, kh, kw] on
    both sides (MobileNetV2's first inverted residual, groups = 8)."""
    jm, state = zoo("mobilenet_v2")
    key = "features.1.conv.0.conv.weight"
    pm = port_model("mobilenet_v2", state)
    conv = pm.features[1].conv[0].conv
    assert conv._groups == 8 and tuple(conv.weight.shape) == (8, 1, 3, 3)
    assert state[key].shape == (8, 1, 3, 3)
    np.testing.assert_array_equal(conv.weight.detach().numpy(), state[key])


# -- the families in eval -------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SHALLOW))
def test_eval_forward_matches(zoo, name):
    jm, state = zoo(name)
    hw = SHALLOW[name][0]
    x = _x((2, 3, hw, hw))
    want = jit_forward(jm, jnp.asarray(x))
    pm = port_model(name, state)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    _close(got, want, F32_TOL, name)
    assert np.array_equal(got.argmax(1).numpy(), _np(want).argmax(1))


def test_mobilenet_v2_train_forward_matches(zoo):
    jm, state = zoo("mobilenet_v2")
    pm = port_model("mobilenet_v2", state)
    zero_dropout(jm, pm)
    jm.train()
    pm.train()
    try:
        x = _x((2, 3, 96, 96), seed=5)
        want = jit_forward(jm, jnp.asarray(x))
        with torch.no_grad():
            got = pm(torch.from_numpy(x))
    finally:
        jm.eval()
        for m in jm.sublayers():
            if isinstance(m, jax_nn.Dropout):
                m.p = 0.2
    _close(got, want, DEEP_TOL, "mobilenet_v2 train")


# -- training -------------------------------------------------------------------------

def _mobilenet_batch():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 3, 32, 32)).astype(np.float32)
    x[:4] += 2.0
    return x, np.array([1] * 4 + [0] * 4, np.int64)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                     1e-30))


# Adam's first update is lr * g / (|g| + eps): lr times the sign of g. An
# element whose gradient lies within f32 rounding of 0 therefore steps +lr
# in one package and -lr in the other. In train-mode MobileNetV2 two kinds
# have such gradients: every projection's BatchNorm bias (the first
# block's is ``features.1.conv.1``, as it has no expansion), which only
# shifts the input of a convolution whose BatchNorm removes the batch
# mean again, so that its gradient is 0 in exact arithmetic (measured ~1e-15 in float64, rounding noise of
# ~1e-6 in f32); and elements at a ReLU6 kink, whose gradient moves by
# more than its size when the kink's input lands on the other side
# (measured: |g| 2.4e-4 flipping sign in a leaf whose median |g| is 1.3).
# Run on from their own first steps, 382 elements were 2 * lr apart after
# two steps and the second loss 9e-4 relative apart. So, as
# tests/test_torch_resnet_steps.py holds ResNet, each step runs from the
# reference's state (parameters, running statistics and Adam's moments
# carried across before the next); the loss within 1e-5 relative, or no
# farther from a float64 step's than the reference's (BatchNorm over the
# 8 values of a 1 x 1 map magnifies rounding: the second loss measured
# 1.3e-5 relative apart); the running statistics element by element; the
# first step's gradient (Adam's m / (1 - beta1)) against a float64
# gradient, the port's no farther from it than the reference's (or 1e-4
# relative L2), leaf by leaf; and every parameter within 2 * lr, all but
# ``_APART`` of the elements of the leaves whose gradient is not 0 in
# exact arithmetic within 1e-5 (measured: 26 of 240290 elements, 1.1e-4,
# over the two steps).
_APART = 5e-4


def test_engine_steps_match_the_reference():
    """Two Adam steps of mobilenet_v2(scale=0.25, num_classes=2) at 8 x 3
    x 32 x 32, each from the reference's state (dropout p 0 on both
    sides)."""
    paddle.seed(0)
    jm = JM.mobilenet_v2(scale=0.25, num_classes=2)
    state = randomized_state(jm, seed=11)
    pm = PM.mobilenet_v2(scale=0.25, num_classes=2, device="cpu")
    load_numpy_state(pm, state)
    zero_dropout(jm, pm)
    jm.train()
    jeng = JaxEngine(jm, loss=jax_nn.CrossEntropyLoss(),
                     optimizer=paddle.optimizer.Adam(
                         LR, parameters=jm.parameters()))
    opt = Adam(LR, parameters=pm.named_parameters())
    peng = Engine(pm, loss=port_nn.CrossEntropyLoss(), optimizer=opt)
    x, y = _mobilenet_batch()
    exact = PM.mobilenet_v2(scale=0.25, num_classes=2, device="cpu",
                            dtype=torch.float64)
    zero_dropout(jm, exact)
    apart, start = 0, state
    for step in (1, 2):
        load_numpy_state(exact, start)
        exact.zero_grad()
        l64 = port_nn.CrossEntropyLoss()(exact(torch.from_numpy(x).double()),
                                         torch.from_numpy(y))
        l64.backward()
        if step == 1:
            g64 = {k: p.grad.numpy() for k, p in exact.named_parameters()}
            zero_grad = {k for k, g in g64.items()
                         if np.abs(g).max() < 1e-10}
            assert len(zero_grad) == 17, sorted(zero_grad)
            assert all(k.endswith("bn.bias") for k in zero_grad)
        jl = float(jeng.train_batch([jnp.asarray(x)], [jnp.asarray(y)])[0])
        pl = float(peng.train_batch([torch.from_numpy(x)],
                                    [torch.from_numpy(y)])[0])
        assert (abs(pl - jl) <= 1e-5 * abs(jl)
                or abs(pl - l64.item()) <= abs(jl - l64.item())), (
            step, pl, jl, l64.item())
        jstate = {k: _np(v) for k, v in jm.state_dict().items()}
        pstate = pm.state_dict()
        assert set(pstate) == set(jstate)
        for k, v in pstate.items():
            what = f"step {step} {k}"
            if k.endswith(("_mean", "_variance")):
                _close(v, jstate[k], 1e-5, what)
            else:
                diff = np.abs(v.detach().numpy() - jstate[k])
                assert diff.max() <= 2 * LR, (what, float(diff.max()))
                if k not in zero_grad:
                    apart += int((diff > 1e-5).sum())
        if step == 1:
            far = {}
            for side, moments in (
                    ("port", {k: s["m"].numpy()
                              for k, s in opt._state.items()}),
                    ("reference", {k: _np(m) for k, m in
                                   jeng._opt_state["m"].items()})):
                far[side] = max(_rel_l2(moments[k] / 0.1, g64[k])
                                for k in g64 if k not in zero_grad)
            assert far["port"] <= max(far["reference"], 1e-4), far
        load_numpy_state(pm, jstate)
        start = jstate
        for slot in ("m", "v"):
            for k, t in jeng._opt_state[slot].items():
                opt._state[k][slot].copy_(torch.tensor(_np(t)))
    n = sum(p.numel() for k, p in pm.named_parameters()
            if k not in zero_grad)
    assert apart <= _APART * n, (apart, n)


def test_mobilenet_trains():
    """The reference's test_mobilenet_trains on the port: 25 Adam steps
    halve the loss."""
    pm = PM.mobilenet_v2(scale=0.25, num_classes=2, device="cpu",
                         generator=pt.seed(0, device="cpu"))
    eng = Engine(pm, loss=port_nn.CrossEntropyLoss(),
                 optimizer=Adam(2e-3, parameters=pm.named_parameters()))
    x, y = (torch.from_numpy(a) for a in _mobilenet_batch())
    losses = [float(eng.train_batch([x], [y])[0]) for _ in range(25)]
    assert losses[-1] < losses[0] * 0.5, losses[::6]


# -- the reference's other zoo cases ------------------------------------------------

def test_pretrained_path_loads_a_reference_file(zoo, tmp_path):
    """A .pdparams the reference wrote from its model loads through the
    port's factory and gives the reference's logits."""
    jm, _ = zoo("shufflenet_v2_x0_25")
    path = str(tmp_path / "shufflenet.pdparams")
    paddle.save(jm.state_dict(), path)
    pm = PM.shufflenet_v2_x0_25(pretrained=path, num_classes=10,
                                device="cpu").eval()
    x = _x((2, 3, 64, 64), seed=7)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    _close(got, jit_forward(jm, jnp.asarray(x)), F32_TOL)
