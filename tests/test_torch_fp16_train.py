"""float16 AMP training of GPT under TrainGuard's GradScaler: the port vs
the JAX package.

A 2-layer, hidden-128, 2-head GPT (head_dim 64) is built and seeded in
the JAX package; its weights cross through numpy. Both Engines take
``amp_dtype=float16``, ``TrainGuard(snapshot_every=1, rollback_after=3,
scaler=GradScaler(init_loss_scaling=1024, incr_every_n_steps=2))`` and
the gradient-norm telemetry, and run 4 ``train_batch`` steps of one fixed
batch (2 x 128 tokens, dropout 0) with ``nan_grads`` injected at step 2:
three applied updates around one skipped step. Each run is made twice:
with AdamW(1e-4, weight decay 0.01, ``fused_kernel=True``), the #10 path
masked by the finite flag, and with Momentum(0.1, 0.9), whose update is
linear in the unscaled gradients. Adam moves an element by about
lr sign(g) whatever the gradient's size, and is blind to a constant
factor in it, so its parameters alone cannot hold the float16 backward or
the unscale; the gradient norm and Momentum's updates do.

Held to the reference at the bf16 bar of 1e-2: the good steps' losses
(relative; measured 1.5e-4 at most under AdamW, 2.2e-4 under
Momentum), the unscaled gradients' global norm (relative; measured 1.9e-4
at most under AdamW, 4.5e-4 under Momentum), Momentum's update p_t -
p_(t-1) per leaf (relative L2; measured 2.0e-3 at most) and every
parameter after every step (absolute; measured 4.6e-4 at most under
AdamW, 1.7e-4 under Momentum). Exactly: the skipped step's NaN loss and
norm, the guard's counters, the scale after each step (1024, halved by
the bad step, doubled after two good ones), ``opt_step`` and the
unchanged model across the skip.

The embeddings of the shared weights are scaled up 8x. At the seeded
init (std 0.02) the reference's float16 step has a non-finite gradient at
every step, whatever the loss scale: its ``layer_norm`` runs the whole
normalisation in the input dtype, and the backward of ``rsqrt(var +
eps)`` over the first block's small-variance input overflows float16
(``test_reference_layer_norm_overflows`` shows it). PyTorch's float16
``layer_norm`` keeps its statistics in f32, so the port's step is finite
there; that case holds the port's step to being finite and the
reference's to overflowing, as they are.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.amp import GradScaler as JaxGradScaler
from paddle_tpu.hapi.engine import Engine as JaxEngine
from paddle_tpu.nlp.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nlp.gpt import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.nlp.gpt import _resolve_config as jax_config
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer import Momentum as JaxMomentum
from paddle_tpu.resilience import TrainGuard as JaxTrainGuard
from paddle_tpu.resilience import faults as jax_faults
from paddle_tpu_torch import seed
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.hapi import Engine
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.nlp.gpt import GPTForCausalLM, GPTPretrainingCriterion
from paddle_tpu_torch.nlp.gpt import _resolve_config as port_config
from paddle_tpu_torch.optimizer import AdamW, Momentum
from paddle_tpu_torch.resilience import TrainGuard, faults
from torch_threads import one_torch_thread  # noqa: F401

_OVR = dict(hidden_size=128, num_attention_heads=2)  # head_dim 64
_B, _S, _STEPS, _BAD = 2, 128, 4, 2
_TOL = 1e-2
_GUARD = dict(snapshot_every=1, rollback_after=3)
_SCALER = dict(init_loss_scaling=1024.0, incr_every_n_steps=2)
_MOMENTUM_LR = 0.1
# the embeddings' scale-up (see the module docstring)
_EMB = 8.0


def _numpy_state(named):
    return {k: np.asarray(v) for k, v in named}


def _optimizer(pkg, opt, params=None):
    if opt == "momentum":
        cls = JaxMomentum if pkg == "jax" else Momentum
        return cls(learning_rate=_MOMENTUM_LR, momentum=0.9,
                   **({} if params is None else dict(parameters=params)))
    cls = JaxAdamW if pkg == "jax" else AdamW
    return cls(learning_rate=1e-4, weight_decay=0.01, fused_kernel=True,
               **({} if params is None else dict(parameters=params)))


def _run(pkg, opt, state, ids, labels):
    """(losses, grad norms, scales, params after each step, guard,
    opt_step) of one package's guarded float16 run."""
    fm = jax_faults if pkg == "jax" else faults
    fm.clear()
    if pkg == "jax":
        m = JaxGPT(jax_config("gpt-tiny", **_OVR))
        m.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
        m.train()
        guard = JaxTrainGuard(**_GUARD, scaler=JaxGradScaler(**_SCALER))
        eng = JaxEngine(m, loss=JaxCriterion(),
                        optimizer=_optimizer(pkg, opt, m.parameters()),
                        amp_dtype=jnp.float16, guard=guard)
        params = lambda: _numpy_state(  # noqa: E731
            (k, v._value) for k, v in m.state_dict().items())
        ins, labs = [jnp.asarray(ids)], [jnp.asarray(labels)]
    else:
        m = GPTForCausalLM(port_config("gpt-tiny", **_OVR), device="cpu",
                           generator=seed(0, device="cpu"))
        load_numpy_state(m, state).train()
        guard = TrainGuard(**_GUARD, scaler=GradScaler(**_SCALER))
        eng = Engine(m, loss=GPTPretrainingCriterion(),
                     optimizer=_optimizer(pkg, opt),
                     amp_dtype=torch.float16, guard=guard)
        params = lambda: _numpy_state(  # noqa: E731
            (k, v.detach().clone()) for k, v in m.state_dict().items())
        ins, labs = [ids], [labels]
    eng.enable_grad_norm()
    fm.inject("nan_grads", step=_BAD)
    losses, norms, scales, after = [], [], [], []
    try:
        for _ in range(_STEPS):
            losses.append(float(np.asarray(eng.train_batch(ins, labs)[0])))
            norms.append(float(np.asarray(eng.last_grad_norm)))
            scales.append(float(np.asarray(eng._scaler_state["scale"])))
            after.append(params())
    finally:
        fm.clear()
    return dict(opt=opt, losses=losses, norms=norms, scales=scales,
                after=after, guard=guard, opt_step=eng._opt_step)


@functools.lru_cache(maxsize=None)
def _runs(opt):
    """(the seeded state, the reference's run, the port's run) of one
    optimizer, computed once for the module."""
    paddle.seed(0)
    jm = JaxGPT(jax_config("gpt-tiny", **_OVR))
    state = _numpy_state((k, v._value) for k, v in jm.state_dict().items())
    for k in ("gpt.embeddings.word_embeddings.weight",
              "gpt.embeddings.position_embeddings.weight"):
        state[k] = state[k] * _EMB
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, (_B, _S)).astype(np.int32)
    labels = rng.integers(0, 256, (_B, _S)).astype(np.int32)
    return (state, _run("jax", opt, state, ids, labels),
            _run("port", opt, state, ids, labels))


@pytest.fixture(scope="module", params=("adamw", "momentum"))
def runs(request):
    return _runs(request.param)


def test_losses_match(runs):
    _, ref, got = runs
    bad = [i + 1 == _BAD for i in range(_STEPS)]
    assert [np.isnan(v) for v in got["losses"]] == bad
    assert [np.isnan(v) for v in ref["losses"]] == bad
    good = [v for v, b in zip(got["losses"], bad) if not b]
    np.testing.assert_allclose(
        good, [v for v, b in zip(ref["losses"], bad) if not b], rtol=_TOL,
        atol=0)
    assert good[-1] < good[0]


def test_grad_norms_match(runs):
    """The unscaled gradients' global norm: a missing or doubled 1/scale
    would move it by the scale or by 2."""
    _, ref, got = runs
    bad = [i + 1 == _BAD for i in range(_STEPS)]
    assert [np.isnan(v) for v in got["norms"]] == bad
    assert [np.isnan(v) for v in ref["norms"]] == bad
    np.testing.assert_allclose(
        [v for v, b in zip(got["norms"], bad) if not b],
        [v for v, b in zip(ref["norms"], bad) if not b], rtol=_TOL, atol=0)


def test_updates_match():
    """Under Momentum each good step's update p_t - p_(t-1) is lr times the
    velocity, linear in the unscaled gradients: held per leaf in relative
    L2. The key projection's bias is held apart: its gradient is zero in
    exact arithmetic (it shifts each query's scores by the same q.b, which
    softmax cancels), so both updates are rounding noise, under 1e-6 lr in
    rms."""
    state, ref, got = _runs("momentum")
    prev_r = prev_g = state
    for step in range(_STEPS):
        if step + 1 == _BAD:
            continue
        for k in state:
            dr = ref["after"][step][k].astype(np.float64) - prev_r[k]
            dg = got["after"][step][k].astype(np.float64) - prev_g[k]
            if k.endswith("attn.k_proj.bias"):
                for d in (dr, dg):
                    assert np.sqrt(np.mean(d ** 2)) <= 1e-6 * _MOMENTUM_LR, k
                continue
            rel = np.linalg.norm(dg - dr) / np.linalg.norm(dr)
            assert rel <= _TOL, f"step {step + 1}: {k}: {rel}"
        prev_r, prev_g = ref["after"][step], got["after"][step]


def test_guard_and_scale_match(runs):
    _, ref, got = runs
    assert got["scales"] == ref["scales"] == [1024.0, 512.0, 512.0,
                                              1024.0]
    assert got["guard"].stats() == ref["guard"].stats()
    assert got["guard"].log_scalars() == ref["guard"].log_scalars() == {
        "skipped": 1, "rollbacks": 0, "found_inf": 1}
    assert got["opt_step"] == ref["opt_step"] == _STEPS - 1


def test_params_match(runs):
    state, ref, got = runs
    for step in range(_STEPS):
        want, have = ref["after"][step], got["after"][step]
        assert list(have) == list(want)
        for k in want:
            np.testing.assert_allclose(have[k].astype(np.float32),
                                       want[k].astype(np.float32),
                                       atol=_TOL, rtol=0,
                                       err_msg=f"step {step + 1}: {k}")
    # the skipped step moved nothing, bit for bit; the last moved every
    # leaf, the tied embedding included
    for k, v in got["after"][_BAD - 1].items():
        assert np.array_equal(v, got["after"][_BAD - 2][k]), k
        assert not np.array_equal(got["after"][-1][k], state[k]), k


def test_reference_layer_norm_overflows():
    """At the seeded init the reference's float16 GPT gradient is not
    finite (its float16 LayerNorm backward overflows in the first block)
    while the port's, with PyTorch's f32 statistics, is."""
    import jax

    from paddle_tpu.nn.layer import functional_call
    paddle.seed(0)
    jm = JaxGPT(jax_config("gpt-tiny", **_OVR))
    jm.train()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, (_B, _S)).astype(np.int32)
    labels = rng.integers(0, 256, (_B, _S)).astype(np.int32)
    params, buffers = jm.raw_state()
    crit = JaxCriterion()

    def loss(p):
        p16 = {k: v.astype(jnp.float16) for k, v in p.items()}
        logits = functional_call(jm, p16, buffers, jnp.asarray(ids))
        return crit(logits, jnp.asarray(labels))._value.astype(jnp.float32)
    grads = jax.grad(loss)(params)
    bad = sorted(k for k, g in grads.items()
                 if not bool(jnp.all(jnp.isfinite(g))))
    assert "gpt.h.0.ln_1.weight" in bad and "gpt.h.1.ln_1.weight" not in bad
    state = _numpy_state((k, v._value) for k, v in jm.state_dict().items())
    pm = GPTForCausalLM(port_config("gpt-tiny", **_OVR), device="cpu",
                        generator=seed(0, device="cpu"))
    load_numpy_state(pm, state).train()
    eng = Engine(pm, loss=GPTPretrainingCriterion(), optimizer=AdamW(
        learning_rate=1e-4, fused_kernel=True), amp_dtype=torch.float16,
        guard=TrainGuard(scaler=GradScaler(init_loss_scaling=1.0)))
    loss_v, _ = eng.train_batch([ids], [labels])
    assert np.isfinite(float(loss_v)) and eng.guard.last_outcome == "ok"
