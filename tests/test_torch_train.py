"""Training GPT with the PyTorch port vs the JAX package.

A 2-layer, hidden-128, 2-head GPT (head_dim 64) is built and seeded in the
JAX package; its ``state_dict`` crosses into the port through numpy
(``load_numpy_state``). Three ``Engine.train_batch`` steps of AdamW (lr
1e-4, weight decay 0.01, ``fused_kernel=True``) on the same numpy batch
(2 x 128 tokens, dropout 0) must give the same losses (1e-5 relative) and
the same parameters (1e-5) in f32; with bf16 AMP, within 1e-2. Eager
``loss.backward(); opt.step(); opt.clear_grad()`` must give what
``train_batch`` gives, and a seeded generator must make a run with
dropout repeat exactly. The flash attention the model trains through
is differentiable whichever device branch its forward takes. The same
three steps with ``fused_ln=True`` (GPT's fused block) hold too.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.hapi.engine import Engine as JaxEngine
from paddle_tpu.nlp.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nlp.gpt import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.nlp.gpt import _resolve_config as jax_config
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch import bind_generator, seed
from paddle_tpu_torch.hapi import Engine
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.nlp.gpt import GPTForCausalLM, GPTPretrainingCriterion
from paddle_tpu_torch.nlp.gpt import _resolve_config as port_config
from paddle_tpu_torch.nn import functional as port_F
from paddle_tpu_torch.ops import attention as port_attn
from paddle_tpu_torch.ops.kernels import flash_attention as port_fa
from paddle_tpu_torch.ops.kernels import fused_adamw as port_adamw
from paddle_tpu_torch.optimizer import AdamW
from torch_threads import one_torch_thread  # noqa: F401

_OVR = dict(hidden_size=128, num_attention_heads=2)  # head_dim 64
_B, _S, _STEPS = 2, 128, 3


def numpy_state(jax_model):
    return {k: np.asarray(v._value) for k, v in
            jax_model.state_dict().items()}


@pytest.fixture(scope="module")
def start():
    """The JAX model's initial weights and one fixed batch."""
    paddle.seed(0)
    jm = JaxGPT(jax_config("gpt-tiny", **_OVR))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, (_B, _S)).astype(np.int32)
    labels = rng.integers(0, 256, (_B, _S)).astype(np.int32)
    return numpy_state(jm), ids, labels


def _jax_run(state, ids, labels, amp, **ovr):
    jm = JaxGPT(jax_config("gpt-tiny", **_OVR, **ovr))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    jm.train()
    opt = JaxAdamW(learning_rate=1e-4, weight_decay=0.01,
                   parameters=jm.parameters(), fused_kernel=True)
    eng = JaxEngine(jm, loss=JaxCriterion(), optimizer=opt,
                    amp_dtype=jnp.bfloat16 if amp else None)
    losses = [float(eng.train_batch([jnp.asarray(ids)],
                                    [jnp.asarray(labels)])[0])
              for _ in range(_STEPS)]
    return losses, numpy_state(jm)


def _port_model(state, **ovr):
    pm = GPTForCausalLM(port_config("gpt-tiny", **_OVR, **ovr),
                        device="cpu", generator=seed(0, device="cpu"))
    return load_numpy_state(pm, state).train()


def _port_run(state, ids, labels, amp, **ovr):
    pm = _port_model(state, **ovr)
    eng = Engine(pm, loss=GPTPretrainingCriterion(),
                 optimizer=AdamW(learning_rate=1e-4, weight_decay=0.01,
                                 fused_kernel=True),
                 amp_dtype=torch.bfloat16 if amp else None)
    losses = [float(eng.train_batch([ids], [labels])[0])
              for _ in range(_STEPS)]
    assert eng._step == eng._opt_step == _STEPS
    return losses, {k: v.detach().numpy() for k, v in
                    pm.state_dict().items()}


@pytest.mark.parametrize("amp,tol", [(False, 1e-5), (True, 1e-2)])
def test_engine_matches_jax_engine(start, amp, tol):
    state, ids, labels = start
    jl, jp = _jax_run(state, ids, labels, amp)
    pl, pp = _port_run(state, ids, labels, amp)
    np.testing.assert_allclose(pl, jl, rtol=tol, atol=0)
    assert pl[-1] < pl[0]
    assert list(pp) == list(jp)
    for k in jp:
        np.testing.assert_allclose(pp[k], jp[k], atol=tol, rtol=0,
                                   err_msg=k)
        # every leaf moved, the tied embedding included
        assert not np.array_equal(pp[k], state[k]), k


@pytest.mark.parametrize("amp,tol", [(False, 1e-5), (True, 1e-2)])
def test_engine_fused_ln_matches_jax_engine(start, amp, tol):
    """GPT's fused block (``fused_ln=True``: the fused residual-add +
    LayerNorm with the sum, kernels #6/#7, in interpret mode on the JAX
    side) trains as the JAX Engine does."""
    state, ids, labels = start
    jl, jp = _jax_run(state, ids, labels, amp, fused_ln=True)
    pl, pp = _port_run(state, ids, labels, amp, fused_ln=True)
    np.testing.assert_allclose(pl, jl, rtol=tol, atol=0)
    assert pl[-1] < pl[0]
    for k in jp:
        np.testing.assert_allclose(pp[k], jp[k], atol=tol, rtol=0,
                                   err_msg=k)


def test_eager_step_equals_train_batch(start):
    state, ids, labels = start
    ids_t, labels_t = torch.from_numpy(ids), torch.from_numpy(labels)
    eng_model = _port_model(state)
    eng = Engine(eng_model, loss=GPTPretrainingCriterion(),
                 optimizer=AdamW(1e-4, weight_decay=0.01, fused_kernel=True))
    eager = _port_model(state)
    opt = AdamW(1e-4, parameters=eager.named_parameters(),
                weight_decay=0.01, fused_kernel=True)
    crit = GPTPretrainingCriterion()
    for _ in range(2):
        le, _ = eng.train_batch([ids_t], [labels_t])
        loss = crit(eager(ids_t), labels_t)
        loss.backward()
        opt.step()
        opt.clear_grad()
        torch.testing.assert_close(loss.detach(), le, atol=0, rtol=0)
    for (k, a), b in zip(eng_model.state_dict().items(),
                         eager.state_dict().values()):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=k)


def test_criterion_loss_mask_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 16, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) > 0.3).astype(np.float32)
    for m in (None, mask):
        jkw = {} if m is None else dict(loss_mask=paddle.to_tensor(m))
        want = float(JaxCriterion()(paddle.to_tensor(logits),
                                    paddle.to_tensor(labels), **jkw))
        pkw = {} if m is None else dict(loss_mask=torch.from_numpy(m))
        got = float(GPTPretrainingCriterion()(torch.from_numpy(logits),
                                              torch.from_numpy(labels),
                                              **pkw))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_jax(reduction):
    """F.cross_entropy with ignored positions, as GPT's criterion uses it
    through ParallelCrossEntropy (reduction 'none')."""
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((3, 7, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (3, 7)).astype(np.int64)
    labels[0, :3] = -100
    want = paddle.nn.functional.cross_entropy(
        paddle.to_tensor(logits), paddle.to_tensor(labels),
        reduction=reduction)
    got = port_F.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels), reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._value),
                               rtol=1e-6, atol=1e-6)


def _dropout_run(state, ids, labels, gen_seed):
    pm = _port_model(state, hidden_dropout_prob=0.1,
                     attention_probs_dropout_prob=0.1)
    eng = Engine(pm, loss=GPTPretrainingCriterion(),
                 optimizer=AdamW(1e-3, weight_decay=0.01),
                 generator=seed(gen_seed, device="cpu"))
    return [float(eng.train_batch([ids], [labels])[0]) for _ in range(2)]


def test_seeded_dropout_run_repeats(start):
    """Hidden and attention dropout draw only from the Engine's generator:
    the same seed repeats a run exactly, another seed gives another."""
    state, ids, labels = start
    ids, labels = ids[:, :32], labels[:, :32]
    a = _dropout_run(state, ids, labels, 5)
    assert a == _dropout_run(state, ids, labels, 5)
    assert a != _dropout_run(state, ids, labels, 6)


def test_dropout_without_generator_raises(start):
    state, ids, _ = start
    pm = _port_model(state, hidden_dropout_prob=0.1)
    bind_generator(pm, None)
    with pytest.raises(ValueError, match="Generator"):
        pm(torch.from_numpy(ids[:, :8]))
    pm.eval()
    pm(torch.from_numpy(ids[:, :8]))  # eval draws nothing


def test_cpu_training_launches_nothing(start):
    state, ids, labels = start
    w = port_adamw.fused_adamw_multi_update
    before = (w.launches, w.leaves)
    _port_run(state, ids[:, :16], labels[:, :16], amp=False)
    assert (w.launches, w.leaves) == before


def _qkv():
    rng = np.random.default_rng(5)
    return [rng.standard_normal((1, 16, 2, 64)).astype(np.float32)
            for _ in range(3)]


def test_output_carries_the_autograd_function(monkeypatch):
    """The CUDA branch once returned an output with no autograd node: the
    output of flash_attention must carry the one autograd function, and
    its backward must go through the backward entry, whichever forward
    the device picks. The kernel entry is replaced by its twin here, as
    no card is present."""
    calls = []

    def fwd_entry(*args):
        calls.append("fwd")
        return port_fa.flash_attention_fwd_plain(*args)

    bwd = port_fa.flash_attention_bwd

    def bwd_entry(*args):
        calls.append("bwd")
        return bwd(*args)

    monkeypatch.setattr(port_fa, "flash_attention_fwd", fwd_entry)
    monkeypatch.setattr(port_fa, "flash_attention_bwd", bwd_entry)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv())
    o = port_attn.flash_attention(q, k, v, causal=True)
    nodes, seen = [o.grad_fn], []
    while nodes:  # the fold/unfold transposes sit around the function
        node = nodes.pop()
        seen.append(type(node).__name__)
        nodes += [f for f, _ in node.next_functions if f is not None]
    assert "_FlashAttentionBackward" in seen, seen
    o.sum().backward()
    assert calls == ["fwd", "bwd"]
    assert all(x.grad is not None and x.grad.abs().sum() > 0
               for x in (q, k, v))
