"""The Engine's step modes of the PyTorch port vs the JAX package's Engine.

The reference compiles its training step with ``jax.jit``; the port's
Engine records it as a CUDA graph on the card and runs the same function
eagerly on the CPU (no recording: the caller asked for the CPU), so these
tests hold that function to the reference on the CPU. Weights cross from
the JAX package through numpy (``load_numpy_state``); batches are the
same numpy arrays; dropout 0; f32, tolerance 1e-5 (losses relative,
parameters absolute).

- GPT (gpt-tiny: 2 layers, hidden 64, 4 heads; 2 x 32 tokens; AdamW with
  ``fused_kernel=True``, the kernel's twin on the CPU), one parametrised
  test over four cases: ``train_batch_multi`` with K = 4, with and
  without ``lr_values``; ``train_batch_accum`` over two windows of 4
  micro-batches under ``ClipGradByGlobalNorm``; and ``enable_grad_norm``'s
  ``last_grad_norm`` over two steps (None after accumulation and multi
  steps, as in the reference).
- LeNet through ``Model.fit(accumulate_grad_batches=2)`` at batch 8, two
  epochs of 5 batches each (so a tail window is flushed at each epoch's
  end), with a StepDecay schedule that steps only on real updates.
- The reference's ``test_multi_mismatched_k_fails_before_counters_move``
  and ``test_multi_flushes_pending_accum_window``, in the port.
- #10's twin and its CPU wrapper on host floats against the device array
  [lr, bc1, bc2] that the kernel reads: bit for bit, with and without the
  clip's scale.
- A loss that declares ``host_reads`` (``DETRLoss``): ``capture=True``
  raises ``ValueError`` naming it; ``capture=None`` runs eagerly and says
  why.
- No host read in the steps that a CUDA graph records (GPT, LeNet and a
  fused-bottleneck ResNet under Momentum; a train step, a multi step, an
  accumulated window): none of the ops that read a tensor back to the
  host (``aten._local_scalar_dense``, ``nonzero``) runs in them.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.hapi.engine import Engine as JaxEngine
from paddle_tpu.nlp.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nlp.gpt import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.nlp.gpt import _resolve_config as jax_config
from paddle_tpu.vision.models import LeNet as JaxLeNet
import paddle_tpu_torch as pt
from paddle_tpu_torch import seed
from paddle_tpu_torch.hapi import Engine
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.nlp.gpt import GPTForCausalLM, GPTPretrainingCriterion
from paddle_tpu_torch.nlp.gpt import _resolve_config as port_config
from paddle_tpu_torch.ops.kernels import fused_adamw as port_adamw
from paddle_tpu_torch.optimizer import Adam, AdamW, Momentum
from paddle_tpu_torch.vision.models import LeNet
from torch_threads import one_torch_thread  # noqa: F401

_B, _S, _K = 2, 32, 4
_LR = 1e-3
_TOL = 1e-5


def _state(jm):
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


@pytest.fixture(scope="module")
def gpt_start():
    """gpt-tiny's initial weights from the JAX package, and 8 batches."""
    paddle.seed(0)
    jm = JaxGPT(jax_config("gpt-tiny"))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, (8, _B, _S)).astype(np.int32)
    labels = rng.integers(0, 256, (8, _B, _S)).astype(np.int32)
    return _state(jm), ids, labels


def _jax_gpt(state, clip=None):
    jm = JaxGPT(jax_config("gpt-tiny"))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    jm.train()
    opt = paddle.optimizer.AdamW(
        learning_rate=_LR, weight_decay=0.01, parameters=jm.parameters(),
        fused_kernel=True,
        grad_clip=None if clip is None else paddle.nn.ClipGradByGlobalNorm(
            clip))
    return jm, JaxEngine(jm, loss=JaxCriterion(), optimizer=opt)


def _port_gpt(state, clip=None):
    pm = GPTForCausalLM(port_config("gpt-tiny"), device="cpu",
                        generator=seed(0, device="cpu"))
    load_numpy_state(pm, state).train()
    opt = AdamW(learning_rate=_LR, weight_decay=0.01, fused_kernel=True,
                grad_clip=None if clip is None else
                pt.nn.ClipGradByGlobalNorm(clip))
    return pm, Engine(pm, loss=GPTPretrainingCriterion(), optimizer=opt)


def _run_case(case, eng, ids, labels, arr):
    """The case's calls on one Engine -> (losses, grad norms); ``arr``
    makes an input array for that Engine's package."""
    losses, norms = [], []
    if case.startswith("multi"):
        # a decay from the base lr: an Adam update's rounding noise grows
        # with lr, and the 1e-5 bar holds updates of at most 1e-3
        lrs = (np.asarray([1e-3, 7e-4, 4e-4, 2e-4], np.float32)
               if case == "multi-lr" else None)
        out, none = eng.train_batch_multi([arr(ids[:_K])], [arr(labels[:_K])],
                                          lr_values=lrs)
        assert none is None and eng.last_grad_norm is None
        losses = list(np.asarray(out))
        assert eng._step == eng._opt_step == _K
    elif case == "accum-clip":
        for i in range(2 * _K):
            loss, _, applied = eng.train_batch_accum(
                [arr(ids[i])], [arr(labels[i])],
                apply_update=(i + 1) % _K == 0)
            assert bool(applied) == ((i + 1) % _K == 0)
            assert eng.last_grad_norm is None
            losses.append(float(np.asarray(loss)))
        assert eng._step == 2 * _K and eng._opt_step == 2
    else:  # grad-norm
        eng.enable_grad_norm()
        for i in range(2):
            loss, _ = eng.train_batch([arr(ids[i])], [arr(labels[i])])
            losses.append(float(np.asarray(loss)))
            norms.append(float(np.asarray(eng.last_grad_norm)))
        eng.train_batch_accum([arr(ids[2])], [arr(labels[2])],
                              apply_update=True)
        assert eng.last_grad_norm is None
    return losses, norms


@pytest.mark.parametrize("case", ["multi", "multi-lr", "accum-clip",
                                  "grad-norm"])
def test_engine_steps_match_jax_engine(gpt_start, case):
    state, ids, labels = gpt_start
    clip = 0.5 if case == "accum-clip" else None
    jm, jeng = _jax_gpt(state, clip)
    pm, peng = _port_gpt(state, clip)
    jl, jn = _run_case(case, jeng, ids, labels, jnp.asarray)
    pl, pn = _run_case(case, peng, ids, labels, torch.from_numpy)
    np.testing.assert_allclose(pl, jl, rtol=_TOL, atol=0)
    np.testing.assert_allclose(pn, jn, rtol=_TOL, atol=0)
    _params_close(pm, peng, _state(jm), case)
    if case.startswith("multi"):
        # K train_batch calls at the same rates, bit for bit
        sm, seng = _port_gpt(state)
        for i, lr in enumerate([1e-3, 7e-4, 4e-4, 2e-4] if case == "multi-lr"
                               else [_LR] * _K):
            seng.optimizer._lr = lr
            seng.train_batch([torch.from_numpy(ids[i])],
                             [torch.from_numpy(labels[i])])
        for a, b in zip(pm.state_dict().values(), sm.state_dict().values()):
            assert torch.equal(a, b)
    for k, v in pm.state_dict().items():
        assert not np.array_equal(v.detach().numpy(), state[k]), k


def _params_close(pm, eng, want, what):
    """Parameters within _TOL; where Adam's second moment says every
    gradient of an element stayed below 1e-6 (the update is a step
    function of g near eps there: the key biases, zero in exact
    arithmetic), within 2 * lr an update, as PERF.md's training bars
    hold it."""
    opt = eng.optimizer
    bc2 = 1.0 - opt._beta2 ** eng._opt_step
    for k, p in pm.named_parameters():
        diff = np.abs(p.detach().numpy() - want[k])
        steep = np.sqrt(opt._state[k]["v"].numpy() / bc2) < 1e-6
        assert diff[~steep].max(initial=0.0) <= _TOL, f"{what}: {k}"
        assert diff[steep].max(initial=0.0) <= 2 * _LR * eng._opt_step, k


# -- Model.fit with gradient accumulation ------------------------------------

class _Losses(pt.hapi.callbacks.Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"][0])


def test_fit_accumulate_matches_jax_model():
    import paddle_tpu.hapi.callbacks as rcb

    class RefLosses(rcb.Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"][0])

    rng = np.random.default_rng(5)
    xs = rng.random((40, 1, 28, 28)).astype(np.float32)
    ys = rng.integers(0, 10, 40).astype(np.int64)
    paddle.seed(0)
    jnet = JaxLeNet()
    jsched = paddle.optimizer.lr.StepDecay(_LR, step_size=2, gamma=0.5)
    jm = paddle.Model(jnet)
    jm.prepare(paddle.optimizer.Adam(jsched, parameters=jnet.parameters()),
               paddle.nn.CrossEntropyLoss())
    pnet = LeNet(device="cpu")
    load_numpy_state(pnet, _state(jnet))
    psched = pt.optimizer.lr.StepDecay(_LR, step_size=2, gamma=0.5)
    pm = pt.Model(pnet)
    pm.prepare(Adam(psched, parameters=pnet.parameters()),
               pt.nn.CrossEntropyLoss())
    rl, pl = RefLosses(), _Losses()
    kw = dict(epochs=2, batch_size=8, shuffle=False, verbose=0,
              accumulate_grad_batches=2)
    jm.fit(paddle.io.TensorDataset([xs, ys]), callbacks=[rl], **kw)
    pm.fit(pt.io.TensorDataset([xs, ys]), callbacks=[pl], **kw)
    assert len(pl.losses) == len(rl.losses) == 10
    np.testing.assert_allclose(pl.losses, rl.losses, rtol=_TOL, atol=0)
    # windows end at batches 2 and 4, and the tail (batch 5) is flushed
    # at each epoch's end: 3 updates an epoch, the schedule with them
    assert pm._engine._step == 10 and pm._engine._opt_step == 6
    assert psched.last_epoch == jsched.last_epoch == 6
    _params_close(pnet, pm._engine, _state(jnet), "fit")


# -- the reference's multi-step cases, in the port ----------------------------

def _small():
    g = seed(3, device="cpu")
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                              torch.nn.Linear(16, 4))
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return Engine(net, loss=pt.nn.CrossEntropyLoss(),
                  optimizer=AdamW(0.01, parameters=net.named_parameters()))


def _data(k=4, b=8):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((k, b, 8)).astype(np.float32),
            rng.integers(0, 4, (k, b)).astype(np.int64))


def test_multi_mismatched_k_fails_before_counters_move():
    x, y = _data(4)
    eng = _small()
    with pytest.raises(ValueError, match="disagree on K"):
        eng.train_batch_multi([x], [y[:3]])
    assert eng._step == 0 and eng._opt_step == 0
    with pytest.raises(ValueError, match="lr_values"):
        eng.train_batch_multi([x], [y], lr_values=np.ones(2, np.float32))
    assert eng._step == 0 and eng._opt_step == 0


def test_multi_flushes_pending_accum_window():
    x, y = _data(2)
    eng = _small()
    eng.train_batch_accum([x[0]], [y[0]], apply_update=False)
    assert eng._micro_count == 1
    eng.train_batch_multi([x], [y])
    assert eng._micro_count == 0
    assert eng._step == 3 and eng._opt_step == 3
    # reset drops a half window: its sums are zeroed, nothing applied
    eng.train_batch_accum([x[0]], [y[0]], apply_update=False)
    eng.reset_accum_window()
    assert eng._micro_count == 0 and not eng.flush_accum()
    assert all(not a.any() for a in eng._acc) and eng._opt_step == 3


# -- #10 on host floats and on the device array --------------------------------

def test_adamw_twin_host_floats_equal_device_scalars():
    rng = np.random.default_rng(4)
    shapes = [(64, 33), (7,), (1,), (4096,)]

    def leaves():
        return [[torch.from_numpy((rng.standard_normal(s) * sc).astype(
            np.float32)).abs_() if i == 2 else torch.from_numpy(
            (rng.standard_normal(s) * sc).astype(np.float32))
            for s in shapes] for i, sc in enumerate((1.0, 0.1, 0.01, 1.0))]
    hp = dict(beta1=0.9, beta2=0.999, eps=1e-8, decoupled=True,
              weight_decays=[0.01, 0.0, 0.01, 0.01])
    opt = AdamW(_LR)
    for step, scale in ((1, None), (3, torch.tensor(0.25))):
        start = leaves()
        host = [[t.clone() for t in xs] for xs in start[:3]]
        dev = [[t.clone() for t in xs] for xs in start[:3]]
        wrap = [[t.clone() for t in xs] for xs in start[:3]]
        bc1, bc2 = 1 - 0.9 ** step, 1 - 0.999 ** step
        port_adamw.adamw_multi_update_plain(*host, start[3], _LR, bc1, bc2,
                                            scale=scale, **hp)
        scalars = opt.fill_scalars(_LR, step, "cpu")
        assert scalars.tolist() == torch.tensor(
            [_LR, bc1, bc2], dtype=torch.float32).tolist()
        port_adamw.adamw_multi_update_plain(*dev, start[3], scalars,
                                            scale=scale, **hp)
        port_adamw.fused_adamw_multi_update(*wrap, start[3], scalars,
                                            scale=scale, **hp)
        for a, b, c in zip(sum(host, []), sum(dev, []), sum(wrap, [])):
            assert torch.equal(a, b) and torch.equal(a, c)


# -- declared host reads -------------------------------------------------------

def test_declared_host_read_refuses_capture():
    from paddle_tpu_torch.vision.models import DETRLoss
    net = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match="auction_match"):
        Engine(net, loss=DETRLoss(80), optimizer=AdamW(_LR), capture=True)
    eng = Engine(net, loss=DETRLoss(80), optimizer=AdamW(_LR))
    assert not eng.captures and "auction_match" in eng.eager_reason
    eng = Engine(net, loss=pt.nn.CrossEntropyLoss(), optimizer=AdamW(_LR),
                 capture=True)
    # on the CPU the step runs without recording: the caller asked for it
    assert not eng.captures and eng.eager_reason is None


# -- no host read in a recorded step -------------------------------------------

class _HostReads(TorchDispatchMode):
    """Records every op that reads a tensor back to the host."""

    READS = ("aten::_local_scalar_dense", "aten::nonzero",
             "aten::masked_select")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name in self.READS:
            self.seen.append(func._schema.name)
        return func(*args, **(kwargs or {}))


def _lenet_engine():
    net = LeNet(device="cpu", generator=seed(0, device="cpu"))
    return Engine(net, loss=pt.nn.CrossEntropyLoss(),
                  optimizer=Adam(_LR, parameters=net.parameters(),
                                 fused_kernel=True,
                                 grad_clip=pt.nn.ClipGradByGlobalNorm(1.0)))


def _resnet_engine():
    from paddle_tpu_torch.vision.models.resnet import BottleneckBlock, ResNet
    net = ResNet(BottleneckBlock, 18, num_classes=10, layout="NHWC",
                 fused_bottleneck=True, device="cpu",
                 generator=seed(1, device="cpu"))
    return Engine(net, loss=pt.nn.CrossEntropyLoss(),
                  optimizer=Momentum(0.1, momentum=0.9))


@pytest.mark.parametrize("model", ["gpt", "lenet", "resnet"])
def test_recorded_steps_read_nothing_back(gpt_start, model):
    rng = np.random.default_rng(1)
    if model == "gpt":
        _, eng = _port_gpt(gpt_start[0], clip=1.0)
        x, y = gpt_start[1][:2], gpt_start[2][:2]
    elif model == "lenet":
        eng = _lenet_engine()
        x = rng.random((2, 8, 1, 28, 28)).astype(np.float32)
        y = rng.integers(0, 10, (2, 8)).astype(np.int64)
    else:
        eng = _resnet_engine()
        x = rng.standard_normal((2, 2, 3, 32, 32)).astype(np.float32)
        y = rng.integers(0, 10, (2, 2)).astype(np.int64)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    eng.enable_grad_norm()
    eng.train_batch([x[0]], [y[0]])  # the slots exist before the check
    with _HostReads() as mode:
        eng.train_batch([x[0]], [y[0]])
        eng.train_batch_multi([x], [y])
        eng.train_batch_accum([x[0]], [y[0]], apply_update=False)
        eng.train_batch_accum([x[1]], [y[1]], apply_update=True)
    assert mode.seen == [], mode.seen
    assert eng._opt_step == 5
