"""float16 AMP training of ERNIE with ``fused_ln`` under TrainGuard's
GradScaler: the port vs the JAX package.

A 2-layer, hidden-128, 2-head ERNIE (head_dim 64) with ``fused_ln=True``
(its residual-add LayerNorms through #8/#9's twins here, the Pallas
kernels in interpret mode in the reference) is built and seeded in the
JAX package; its weights cross through numpy. Both Engines take
``amp_dtype=float16``, ``TrainGuard(snapshot_every=1, rollback_after=3,
scaler=GradScaler(init_loss_scaling=1024, incr_every_n_steps=2))``,
Momentum(0.1, 0.9) (its update is linear in the unscaled gradients, so it
holds the float16 backward and the unscale) and the gradient-norm
telemetry, and run 4 ``train_batch`` steps of one pretraining batch (2 x
64 tokens, 30 % of them labelled, NSP labels; dropout 0) with
``nan_grads`` injected at step 2.

Held at 1e-2: the good steps' losses (relative; measured 7.3e-5 at most),
the unscaled gradients' global norm (relative; 2.2e-4 at most) and each
good step's update p_t - p_(t-1) per leaf (relative L2; 9.2e-3 at most
after step 1). Exactly: the skipped step's NaN loss and norm, the guard's
counters, the scale after each step (1024, halved by the bad step,
doubled after two good ones), ``opt_step`` and the unchanged model across
the skip. The key projections' biases are held apart: their gradient is
zero in exact arithmetic (a shift of every key's score by the same q.b,
which softmax cancels), so both updates are rounding noise, under 1e-6 lr
in rms.

At step 1, from the shared start, two leaves of the NSP path (the
pooler's and the seq_relationship bias: a sum over the batch's 2
sentences that cancels) sit 1.5e-2 and 2.0e-2 from the reference's
update. There the reference's float16 update is the one further from the
reference's own f32 Momentum step from the same start: 1.35e-2 and
2.41e-2 against the port's 7.2e-3 and 6.0e-3. So a leaf over the bar at
step 1 passes only where the port's update is the nearer of the two to
the reference's f32 step, and within 1e-2 of it.

Unlike GPT's (tests/test_torch_fp16_train.py), the reference's float16
ERNIE step is finite at the seeded init (its unfused embedding LayerNorm,
which normalises in float16, does not overflow here), so the weights are
not scaled.
"""
import functools

import numpy as np
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.amp import GradScaler as JaxGradScaler
from paddle_tpu.hapi.engine import Engine as JaxEngine
from paddle_tpu.nlp import ernie as jax_ernie
from paddle_tpu.optimizer import Momentum as JaxMomentum
from paddle_tpu.resilience import TrainGuard as JaxTrainGuard
from paddle_tpu.resilience import faults as jax_faults
from paddle_tpu_torch import seed
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.hapi import Engine
from paddle_tpu_torch.nlp import ernie as port_ernie
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.resilience import TrainGuard, faults
from torch_threads import one_torch_thread  # noqa: F401

_OVR = dict(hidden_size=128, num_attention_heads=2, fused_ln=True)
_B, _S, _STEPS, _BAD = 2, 64, 4, 2
_TOL = 1e-2
_LR = 0.1
_GUARD = dict(snapshot_every=1, rollback_after=3)
_SCALER = dict(init_loss_scaling=1024.0, incr_every_n_steps=2)


def _params(m, pkg):
    if pkg == "jax":
        return {k: np.asarray(v._value) for k, v in m.state_dict().items()}
    return {k: v.detach().clone().numpy() for k, v in m.state_dict().items()}


def _port_model(state):
    m = port_ernie.ErnieForPretraining(
        port_ernie._resolve_config("ernie-tiny", **_OVR), device="cpu",
        generator=seed(0, device="cpu"))
    return load_numpy_state(m, state).train()


def _reference_engine(state, **kw):
    """(model, Engine) of the reference's ERNIE loaded from ``state``,
    under Momentum(_LR, 0.9) and the Engine's ``kw``."""
    m = jax_ernie.ErnieForPretraining(
        jax_ernie._resolve_config("ernie-tiny", **_OVR))
    m.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    m.train()
    return m, JaxEngine(m, loss=jax_ernie.ErniePretrainingCriterion(),
                        optimizer=JaxMomentum(_LR, momentum=0.9,
                                              parameters=m.parameters()),
                        **kw)


def _run(pkg, state, batch):
    """(losses, grad norms, scales, params after each step, guard,
    opt_step) of one package's guarded float16 run."""
    ids, labels, nsp = batch
    fm = jax_faults if pkg == "jax" else faults
    fm.clear()
    if pkg == "jax":
        guard = JaxTrainGuard(**_GUARD, scaler=JaxGradScaler(**_SCALER))
        m, eng = _reference_engine(state, amp_dtype=jnp.float16, guard=guard)
        ins = [jnp.asarray(ids)]
        labs = [jnp.asarray(labels), jnp.asarray(nsp)]
    else:
        m = _port_model(state)
        guard = TrainGuard(**_GUARD, scaler=GradScaler(**_SCALER))
        eng = Engine(m, loss=port_ernie.ErniePretrainingCriterion(),
                     optimizer=Momentum(_LR, momentum=0.9),
                     amp_dtype=torch.float16, guard=guard)
        ins = [torch.from_numpy(ids)]
        labs = [torch.from_numpy(labels), torch.from_numpy(nsp)]
    eng.enable_grad_norm()
    fm.inject("nan_grads", step=_BAD)
    losses, norms, scales, after = [], [], [], []
    try:
        for _ in range(_STEPS):
            losses.append(float(np.asarray(eng.train_batch(ins, labs)[0])))
            norms.append(float(np.asarray(eng.last_grad_norm)))
            scales.append(float(np.asarray(eng._scaler_state["scale"])))
            after.append(_params(m, pkg))
    finally:
        fm.clear()
    return dict(losses=losses, norms=norms, scales=scales, after=after,
                guard=guard, opt_step=eng._opt_step)


def _f32_step(state, batch):
    """The reference's f32 Momentum step from the start (no guard)."""
    ids, labels, nsp = batch
    m, eng = _reference_engine(state)
    eng.train_batch([jnp.asarray(ids)],
                    [jnp.asarray(labels), jnp.asarray(nsp)])
    return _params(m, "jax")


@functools.lru_cache(maxsize=None)
def _runs():
    """(the seeded state, the reference's run, the port's run, the
    reference's f32 step), computed once for the module."""
    paddle.seed(0)
    cfg = jax_ernie._resolve_config("ernie-tiny", **_OVR)
    jm = jax_ernie.ErnieForPretraining(cfg)
    state = _params(jm, "jax")
    vocab = cfg.vocab_size
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab, (_B, _S)).astype(np.int64)
    labels = np.where(rng.random((_B, _S)) < 0.3,
                      rng.integers(0, vocab, (_B, _S)), -100).astype(np.int64)
    nsp = rng.integers(0, 2, (_B,)).astype(np.int64)
    batch = (ids, labels, nsp)
    return (state, _run("jax", state, batch), _run("port", state, batch),
            _f32_step(state, batch))


def _bad(i):
    return i + 1 == _BAD


def test_losses_match():
    _, ref, got, _ = _runs()
    bad = [_bad(i) for i in range(_STEPS)]
    assert [np.isnan(v) for v in got["losses"]] == bad
    assert [np.isnan(v) for v in ref["losses"]] == bad
    good = [v for v, b in zip(got["losses"], bad) if not b]
    np.testing.assert_allclose(
        good, [v for v, b in zip(ref["losses"], bad) if not b], rtol=_TOL,
        atol=0)
    assert good[-1] < good[0]


def test_grad_norms_match():
    """The unscaled gradients' global norm: a missing or doubled 1/scale
    would move it by the scale or by 2."""
    _, ref, got, _ = _runs()
    bad = [_bad(i) for i in range(_STEPS)]
    assert [np.isnan(v) for v in got["norms"]] == bad
    assert [np.isnan(v) for v in ref["norms"]] == bad
    np.testing.assert_allclose(
        [v for v, b in zip(got["norms"], bad) if not b],
        [v for v, b in zip(ref["norms"], bad) if not b], rtol=_TOL, atol=0)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_updates_match():
    """Each good step's update p_t - p_(t-1), lr times Momentum's velocity:
    per leaf in relative L2 (see the module docstring for the key biases
    and for step 1's arbitration by the f32 step)."""
    state, ref, got, f32 = _runs()
    prev_r = prev_g = state
    for step in range(_STEPS):
        if _bad(step):
            continue
        for k in state:
            dr = ref["after"][step][k].astype(np.float64) - prev_r[k]
            dg = got["after"][step][k].astype(np.float64) - prev_g[k]
            if k.endswith("attn.k_proj.bias"):
                for d in (dr, dg):
                    assert np.sqrt(np.mean(d ** 2)) <= 1e-6 * _LR, k
                continue
            rel = _rel(dg, dr)
            if rel > _TOL and step == 0:
                d32 = f32[k].astype(np.float64) - state[k]
                near, far = _rel(dg, d32), _rel(dr, d32)
                assert near <= min(far, _TOL), (k, rel, near, far)
                continue
            assert rel <= _TOL, f"step {step + 1}: {k}: {rel}"
        prev_r, prev_g = ref["after"][step], got["after"][step]


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
        assert np.array_equal(ref["after"][_BAD - 1][k],
                              ref["after"][_BAD - 2][k]), k
    assert all(v.dtype == np.float32 for v in got["after"][-1].values())
    moved = [k for k, v in got["after"][-1].items()
             if not np.array_equal(v, state[k])]
    assert len(moved) == len(state)
