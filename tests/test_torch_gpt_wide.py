"""GPT at GPT-1.3B's width in the PyTorch port vs the JAX package.

``gpt3-1.3B`` (hidden 2048, 16 heads of 128) cut to 1 layer and a
256-token vocabulary, dropout 0, is built and seeded in the JAX package;
its ``state_dict`` crosses into the port through numpy
(``load_numpy_state``). With ``fused_ln`` off and on (GPT's fused block:
kernels #6/#7 at rows of 2048 values, the Pallas kernels in interpret mode
on the JAX side, the plain twins in the port):

- the forward's logits agree within 1e-5 (f32);
- the gradients of the pretraining loss agree within 1e-5 of each leaf's
  largest magnitude, or 1e-5 absolute where that is below 1 (the JAX
  Engine's gradient program against the port's eager ``backward()``);
- one ``Engine.train_batch`` of AdamW (lr 1e-4, weight decay 0.01,
  ``fused_kernel=True``) gives the same loss (1e-5 relative) and the same
  parameters: 1e-5 where |grad| >= 1e-6 on both sides, 2 * lr where
  Adam's first step is a step function of a gradient near its eps.
"""
import numpy as np
import pytest

import torch

import paddle_tpu as paddle
from paddle_tpu.hapi.engine import Engine as JaxEngine
from paddle_tpu.nlp.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nlp.gpt import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.nlp.gpt import _resolve_config as jax_config
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.hapi import Engine
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.nlp.gpt import GPTForCausalLM, GPTPretrainingCriterion
from paddle_tpu_torch.nlp.gpt import _resolve_config as port_config
from paddle_tpu_torch.optimizer import AdamW
from torch_threads import one_torch_thread  # noqa: F401

_OVR = dict(num_hidden_layers=1, vocab_size=256, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
_B, _S = 2, 32


def numpy_state(jax_model):
    return {k: np.asarray(v._value) for k, v in
            jax_model.state_dict().items()}


@pytest.fixture(scope="module")
def start():
    """The JAX model's initial weights and one fixed batch."""
    paddle.seed(0)
    jm = JaxGPT(jax_config("gpt3-1.3B", **_OVR))
    cfg = jm.config
    assert (cfg.hidden_size, cfg.num_attention_heads) == (2048, 16)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, (_B, _S)).astype(np.int32)
    labels = rng.integers(0, 256, (_B, _S)).astype(np.int32)
    return numpy_state(jm), ids, labels


def _models(state, fused_ln):
    jm = JaxGPT(jax_config("gpt3-1.3B", **_OVR, fused_ln=fused_ln))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    pm = GPTForCausalLM(port_config("gpt3-1.3B", **_OVR, fused_ln=fused_ln),
                        device="cpu")
    load_numpy_state(pm, state)
    return jm, pm


_FUSED = pytest.mark.parametrize("fused_ln", [False, True],
                                 ids=["plain_ln", "fused_ln"])
_RUNS = {}
_LR = 1e-4


def _run(start, fused_ln):
    """Each side's logits, loss and gradients of one batch, then the loss
    and parameters of one Engine step from the same weights, once a
    configuration: {"jax": (logits, loss, grads, step loss, params),
    "port": (the same)}. The JAX side takes its gradients from its own
    Engine's compiled gradient program (``train_batch_accum`` without an
    update, the window then dropped); the port's from an eager
    ``backward()``, its Engine taking its own ``autograd.grad``."""
    if fused_ln not in _RUNS:
        state, ids, labels = start
        jm, pm = _models(state, fused_ln)
        jeng = JaxEngine(jm, loss=JaxCriterion(), optimizer=JaxAdamW(
            learning_rate=_LR, weight_decay=0.01, parameters=jm.parameters(),
            fused_kernel=True))
        jloss, jlogits, applied = jeng.train_batch_accum([ids], [labels],
                                                         False)
        assert not applied
        jgrads = {k: np.asarray(v) for k, v in jeng._acc_grads.items()}
        jeng.reset_accum_window()
        jstep = float(jeng.train_batch([ids], [labels])[0])
        pm.train()
        plogits = pm(torch.from_numpy(ids))
        ploss = GPTPretrainingCriterion()(plogits, torch.from_numpy(labels))
        ploss.backward()
        pgrads = {n: p.grad.numpy().copy() for n, p in pm.named_parameters()}
        pm.zero_grad(set_to_none=True)
        peng = Engine(pm, loss=GPTPretrainingCriterion(), optimizer=AdamW(
            learning_rate=_LR, weight_decay=0.01, fused_kernel=True))
        pstep = float(peng.train_batch([ids], [labels])[0])
        _RUNS[fused_ln] = {
            "jax": (np.asarray(jlogits), float(jloss), jgrads, jstep,
                    numpy_state(jm)),
            "port": (plogits.detach().numpy(), ploss.item(), pgrads, pstep,
                     {k: v.detach().numpy()
                      for k, v in pm.state_dict().items()})}
    return _RUNS[fused_ln]


@_FUSED
def test_forward_and_gradients(start, fused_ln):
    got = _run(start, fused_ln)
    (jlogits, jloss, jgrads), (plogits, ploss, pgrads) = \
        got["jax"][:3], got["port"][:3]
    np.testing.assert_allclose(plogits, jlogits, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ploss, jloss, rtol=1e-5)
    assert set(pgrads) == set(jgrads)
    for n, want in jgrads.items():
        scale = max(1.0, float(np.abs(want).max()))
        err = float(np.abs(pgrads[n] - want).max()) / scale
        assert err <= 1e-5, (n, err)


@_FUSED
def test_engine_step(start, fused_ln):
    """Adam's first step moves an element by lr * g / (|g| + eps): flat
    where |g| >= 1e-6 = 100 eps on both sides, held there to 1e-5, but a
    step function of g near eps, where gradients that agree to 1e-5 can
    move it by different fractions of lr: held there to 2 * lr (the bar of
    PERF.md section 2 for a training step)."""
    state = start[0]
    got = _run(start, fused_ln)
    _, _, jgrads, jl, jp = got["jax"]
    _, _, pgrads, pl, pp = got["port"]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert list(pp) == list(jp) and set(jp) == set(jgrads)
    for k in jp:
        diff = np.abs(pp[k] - jp[k])
        steep = (np.abs(jgrads[k]) < 1e-6) | (np.abs(pgrads[k]) < 1e-6)
        assert diff[~steep].max(initial=0.0) <= 1e-5, k
        assert diff[steep].max(initial=0.0) <= 2 * _LR, k
        assert not np.array_equal(pp[k], state[k]), k
