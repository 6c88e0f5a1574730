"""float16 AMP training of a ResNet of bottleneck blocks (NHWC,
``fused_bottleneck``) under TrainGuard's GradScaler: the port vs the JAX
package.

The model is ``ResNet(BottleneckBlock, 18, num_classes=10, layout="NHWC",
fused_bottleneck=True)`` cut after ``layer2`` (``layer3`` and ``layer4``
built as identities, the classifier a 512 -> 10 Linear): the stem
and four bottleneck blocks, whose 1x1 chains run through #11's twin and
``conv1x1_batch_stats`` in the port and through the Pallas kernel in
interpret mode (``layer2``'s 128 -> 512 conv3s) or the reference's jnp
path (``layer1``'s 64-wide ones) in the JAX package. It is built and
seeded in the port (seed 0); the weights cross into the reference's model
through numpy. Both Engines
take ``amp_dtype=float16`` (BatchNorm's weight and bias float16, its
running statistics f32, as the reference's O1 cast leaves them),
``TrainGuard(snapshot_every=1, rollback_after=3,
scaler=GradScaler(init_loss_scaling=1024, incr_every_n_steps=2))``,
Momentum(1e-4, 0.9) and the gradient-norm telemetry, and run 4
``train_batch`` steps of one batch (4 x 3 x 32 x 32, labels of 10
classes) with ``nan_grads`` injected at step 2.

Held at 1e-2: the good steps' losses and the unscaled gradients' global
norm (relative; measured 7.4e-4 and 8.3e-3 at most), each running
statistic after each good step (of its max-abs; 1.4e-3 at most). Exactly: the skipped step's NaN loss and norm, the guard's
counters, the scale after each step, ``opt_step``, the parameters and the
f32 running statistics unchanged across the skip.

Each leaf's gradient behind a ReLU or the max-pool is not held to the
reference's at 1e-2: there a float16 step's gradient is not a continuous
function of the weights. A ReLU whose input lies within rounding of zero
passes its element's gradient in one package and stops it in the other.
In float64 this network's gradient moves linearly while its weights move
by up to 1e-8 of themselves; at 5e-7 one ReLU of the 32768 at layer2's
output flips and the median leaf jumps by 1.1e-2; at 5e-4, about
float16's rounding, it moves by 1.1e-1. The two packages' float16
gradients sit 1.22e-1 apart on the median leaf (1.41e-1 at worst), each
about that far from a float64 step. So Momentum's velocity after the
first good step (the unscaled gradient) is held twice. Against the
reference's: the classifier's leaves at 1e-2 (measured 9.9e-4 at most),
every other leaf at 0.3 in relative L2 and its norm within 0.1 of the
reference's (3.2e-2 at worst), as the chip check holds the card against
the CPU; a leaf zeroed or doubled reads 1. Against a float64 step of the
same model and batch: the port's median and worst leaf no further from
it than 1.5x the reference's (measured 0.89x and 0.94x: 1.13e-1 and
1.47e-1 against 1.27e-1 and 1.56e-1).
"""
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jax_nn
from paddle_tpu.amp import GradScaler as JaxGradScaler
from paddle_tpu.hapi.engine import Engine as JaxEngine
from paddle_tpu.optimizer import Momentum as JaxMomentum
from paddle_tpu.resilience import TrainGuard as JaxTrainGuard
from paddle_tpu.resilience import faults as jax_faults
from paddle_tpu.vision.models import resnet as jax_resnet
from paddle_tpu_torch import nn as port_nn
from paddle_tpu_torch import seed
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.hapi import Engine
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.resilience import TrainGuard, faults
from paddle_tpu_torch.vision.models import resnet as port_resnet
from torch_threads import one_torch_thread  # noqa: F401

_B, _HW, _STEPS, _BAD = 4, 32, 4, 2
_TOL = 1e-2
_LR = 1e-4
_GUARD = dict(snapshot_every=1, rollback_after=3)
_SCALER = dict(init_loss_scaling=1024.0, incr_every_n_steps=2)
_STATS = ("_mean", "_variance")


def _cut_resnet(mod, nn_mod, fused=True, **kw):
    """``mod.ResNet(BottleneckBlock, 18, num_classes=10, layout="NHWC")``
    cut after layer2: its layers of 256 and 512 planes are built as
    identities (nothing after them draws from the seed), and the
    classifier takes layer2's 512 channels."""
    real = mod.ResNet._make_layer

    def make(self, block, planes, *args, **more):
        if planes > 128:
            return nn_mod.Identity()
        return real(self, block, planes, *args, **more)
    mod.ResNet._make_layer = make
    try:
        m = mod.ResNet(mod.BottleneckBlock, 18, num_classes=10,
                       layout="NHWC", fused_bottleneck=fused, **kw)
    finally:
        mod.ResNet._make_layer = real
    m.fc = nn_mod.Linear(512, 10, **kw)
    return m


def _port_model(state=None, dtype=torch.float32, fused=True):
    m = _cut_resnet(port_resnet, port_nn, fused, device="cpu", dtype=dtype,
                    **({} if state else dict(generator=seed(0, "cpu"))))
    return (load_numpy_state(m, state) if state else m).train()


def _reference_model(state):
    """The reference's model, loaded from ``state``. While it is built,
    jax.random's uniform and normal are stood in by numpy zeros: its
    initial weights are replaced at once, and each weight shape would
    compile a random draw (~13 s over the model)."""
    real = jax.random.uniform, jax.random.normal

    def zeros(key, shape, dtype=jnp.float32, *args, **kw):
        return np.zeros(shape, np.float32)
    jax.random.uniform = jax.random.normal = zeros
    try:
        m = _cut_resnet(jax_resnet, jax_nn)
    finally:
        jax.random.uniform, jax.random.normal = real
    m.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    return m


def _run(pkg, state, x, y):
    """(losses, grad norms, scales, state after each step, the velocity
    after step 1, guard, opt_step) of one package's guarded float16 run."""
    fm = jax_faults if pkg == "jax" else faults
    fm.clear()
    if pkg == "jax":
        m = _reference_model(state).train()
        guard = JaxTrainGuard(**_GUARD, scaler=JaxGradScaler(**_SCALER))
        eng = JaxEngine(m, loss=jax_nn.CrossEntropyLoss(),
                        optimizer=JaxMomentum(_LR, momentum=0.9,
                                              parameters=m.parameters()),
                        amp_dtype=jnp.float16, guard=guard)
        ins, labs = [jnp.asarray(x)], [jnp.asarray(y)]
        now = lambda: {k: np.asarray(v._value)  # noqa: E731
                       for k, v in m.state_dict().items()}
        velocity = lambda: {k: np.asarray(v) for k, v in  # noqa: E731
                            eng._opt_state["velocity"].items()}
    else:
        m = _port_model(state)
        guard = TrainGuard(**_GUARD, scaler=GradScaler(**_SCALER))
        opt = Momentum(_LR, momentum=0.9)
        eng = Engine(m, loss=port_nn.CrossEntropyLoss(), optimizer=opt,
                     amp_dtype=torch.float16, guard=guard)
        ins, labs = [torch.from_numpy(x)], [torch.from_numpy(y)]
        now = lambda: {k: v.detach().clone().numpy()  # noqa: E731
                       for k, v in m.state_dict().items()}
        velocity = lambda: {k: s["velocity"].numpy().copy()  # noqa: E731
                            for k, s in opt._state.items()}
    eng.enable_grad_norm()
    fm.inject("nan_grads", step=_BAD)
    out = dict(losses=[], norms=[], scales=[], after=[])
    try:
        for step in range(_STEPS):
            out["losses"].append(float(np.asarray(
                eng.train_batch(ins, labs)[0])))
            out["norms"].append(float(np.asarray(eng.last_grad_norm)))
            out["scales"].append(float(np.asarray(
                eng._scaler_state["scale"])))
            out["after"].append(now())
            if step == 0:
                out["velocity"] = velocity()
    finally:
        fm.clear()
    return dict(out, guard=guard, opt_step=eng._opt_step)


def _f64_grads(state, x, y):
    """The first step's gradients in float64 (the unfused model: #11 takes
    no float64)."""
    m = _port_model(state, torch.float64, fused=False)
    port_nn.CrossEntropyLoss()(m(torch.from_numpy(x).double()),
                               torch.from_numpy(y)).backward()
    return {k: p.grad.numpy() for k, p in m.named_parameters()}


@functools.lru_cache(maxsize=None)
def _runs():
    """(the seeded state, the reference's run, the port's run, the float64
    gradients), computed once for the module."""
    state = {k: v.detach().clone().numpy()
             for k, v in _port_model().state_dict().items()}
    rng = np.random.default_rng(10)
    x = rng.standard_normal((_B, 3, _HW, _HW)).astype(np.float32)
    y = rng.integers(0, 10, (_B,)).astype(np.int64)
    return (state, _run("jax", state, x, y), _run("port", state, x, y),
            _f64_grads(state, x, y))


def _bad(i):
    return i + 1 == _BAD


def _held(key, ref, got):
    bad = [_bad(i) for i in range(_STEPS)]
    assert [np.isnan(v) for v in got[key]] == bad
    assert [np.isnan(v) for v in ref[key]] == bad
    np.testing.assert_allclose(
        [v for v, b in zip(got[key], bad) if not b],
        [v for v, b in zip(ref[key], bad) if not b], rtol=_TOL, atol=0)


def test_losses_match():
    _, ref, got, _ = _runs()
    _held("losses", ref, got)


def test_grad_norms_match():
    """The unscaled gradients' global norm: a missing or doubled 1/scale
    would move it by the scale or by 2."""
    _, ref, got, _ = _runs()
    _held("norms", ref, got)


def test_running_statistics():
    """f32, unchanged by the skipped step, and within 1e-2 of the
    reference's (of each one's max-abs) after every good step."""
    state, ref, got, _ = _runs()
    stats = [k for k in state if k.endswith(_STATS)]
    assert stats
    for step in range(_STEPS):
        for k in stats:
            have, want = got["after"][step][k], ref["after"][step][k]
            assert have.dtype == np.float32, k
            if _bad(step):
                assert np.array_equal(have, got["after"][step - 1][k]), k
                continue
            err = np.abs(have - want).max() / np.abs(want).max()
            assert err <= _TOL, f"step {step + 1}: {k}: {err}"
            assert not np.array_equal(have, state[k]), k


def _distances(grads, g64):
    """Each leaf's relative L2 distance from the float64 gradient, sorted."""
    return sorted(float(np.linalg.norm(grads[k].astype(np.float64) - g)
                        / np.linalg.norm(g)) for k, g in g64.items())


def test_first_gradients_match():
    """Momentum's velocity after step 1, leaf by leaf against the
    reference's: the classifier's at 1e-2 in relative L2, the leaves
    behind a ReLU at 0.3 and their norms within 0.1 (see the module
    docstring)."""
    _, ref, got, g64 = _runs()
    assert set(got["velocity"]) == set(ref["velocity"]) == set(g64)
    for k, want in ref["velocity"].items():
        have = got["velocity"][k]
        rel = np.linalg.norm(have - want) / np.linalg.norm(want)
        if k.startswith("fc."):
            assert rel <= _TOL, (k, rel)
            continue
        ratio = np.linalg.norm(have) / np.linalg.norm(want) - 1.0
        assert rel <= 0.3 and abs(ratio) <= 0.1, (k, rel, ratio)


def test_first_gradients_against_float64():
    """Momentum's velocity after step 1 is the unscaled float16 gradient:
    the port's median and worst leaf no further from the float64 one than
    1.5x the reference's (see the module docstring)."""
    _, ref, got, g64 = _runs()
    assert set(got["velocity"]) == set(g64)
    port, theirs = _distances(got["velocity"], g64), \
        _distances(ref["velocity"], g64)
    for at in (len(port) // 2, -1):
        assert port[at] <= 1.5 * theirs[at], (at, port[at], theirs[at])


def test_guard_and_scale_match():
    state, ref, got, _ = _runs()
    assert got["scales"] == ref["scales"] == [1024.0, 512.0, 512.0,
                                              1024.0]
    assert got["guard"].stats() == ref["guard"].stats()
    assert got["guard"].log_scalars() == ref["guard"].log_scalars() == {
        "skipped": 1, "rollbacks": 0, "found_inf": 1}
    assert got["opt_step"] == ref["opt_step"] == _STEPS - 1
    for k, v in got["after"][_BAD - 1].items():
        assert np.array_equal(v, got["after"][_BAD - 2][k]), k
    params = [k for k in state if not k.endswith(_STATS)]
    assert all(not np.array_equal(got["after"][-1][k], state[k])
               for k in params)
