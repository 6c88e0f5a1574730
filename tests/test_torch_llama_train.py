"""Llama training in the PyTorch port against the JAX package.

``llama-tiny`` (2 layers, hidden 64, 4 heads of 16 over 2 kv heads (GQA
2:1), SwiGLU 128, vocabulary 256) is built and seeded in the JAX package
with each option set; its ``state_dict`` crosses into the port through
``load_numpy_state`` (from the per-layer layout where the model is
scanned). At batch 2 x 24 in f32, with labels of -100 in both rows:

- the pretraining loss and every gradient (the JAX Engine's gradient
  program, ``train_batch_accum`` without an update, against the port's
  ``autograd.grad``) within 1e-5; the kv projections' gradients sum each
  kv head's repeats over its query heads;
- two ``Engine.train_batch`` steps of AdamW (lr 1e-4, weight decay 0.01):
  losses 1e-5 relative, parameters 1e-5, and 2 * lr a step where a
  gradient is within 1e-6 of 0 (Adam's step is then a step function of
  rounding noise).

Option sets: none; ``recompute``; ``scan_layers`` with ``recompute``;
``chunked_ce`` (a chunk of 7, which does not divide the 48 tokens) with
the tied and with the untied head. ``Model.fit`` passes a chunked model's
``_loss_only_aux`` output to the loss only.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.hapi.engine import Engine as JaxEngine
from paddle_tpu.nlp import llama as jax_llama
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch import seed
from paddle_tpu_torch.hapi import Engine, Model
from paddle_tpu_torch.io import Dataset
from paddle_tpu_torch.nlp import llama as port_llama
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.nn.scan_stack import unstack_layer_state
from paddle_tpu_torch.optimizer import AdamW
from torch_threads import one_torch_thread  # noqa: F401

_B, _S = 2, 24
_LR = 1e-4
_OPTION_SETS = {
    "plain": {},
    "recompute": dict(recompute=True),
    "scan_recompute": dict(scan_layers=True, recompute=True),
    "chunked_tied": dict(chunked_ce=7, tie_word_embeddings=True),
    "chunked_untied": dict(chunked_ce=7),
}
_RUNS = {}


def numpy_state(jax_model):
    return {k: np.asarray(v._value) for k, v in
            jax_model.state_dict().items()}


def _batch(seed_=0):
    rng = np.random.default_rng(seed_)
    ids = rng.integers(0, 256, (_B, _S)).astype(np.int64)
    labels = rng.integers(0, 256, (_B, _S)).astype(np.int64)
    labels[0, :4] = -100
    labels[1, -2:] = -100
    return ids, labels


def _run(key):
    """Both packages' loss, gradients and two Engine steps of one option
    set from the reference's weights, once a set."""
    if key in _RUNS:
        return _RUNS[key]
    ovr = _OPTION_SETS[key]
    paddle.seed(11)
    jm = jax_llama.LlamaForCausalLM(
        jax_llama._resolve_config("llama-tiny", **ovr))
    state = numpy_state(jm)
    ids, labels = _batch()
    jeng = JaxEngine(jm, loss=jax_llama.LlamaPretrainingCriterion(),
                     optimizer=JaxAdamW(learning_rate=_LR, weight_decay=0.01,
                                        parameters=jm.parameters()))
    jloss, _, _ = jeng.train_batch_accum([ids], [labels], False)
    jgrads = {k: np.asarray(v) for k, v in jeng._acc_grads.items()}
    jeng.reset_accum_window()
    jsteps = [float(jeng.train_batch([ids], [labels])[0]) for _ in range(2)]
    pm = port_llama.LlamaForCausalLM.from_config_name(
        "llama-tiny", device="cpu", generator=seed(0, device="cpu"), **ovr)
    load_numpy_state(pm, unstack_layer_state(state, 2, "llama.layers.")
                     if ovr.get("scan_layers") else state)
    pm.train()
    loss = port_llama.LlamaPretrainingCriterion()(
        pm(torch.from_numpy(ids)), torch.from_numpy(labels))
    names, params = zip(*pm.named_parameters())
    pgrads = dict(zip(names, (g.numpy() for g in
                              torch.autograd.grad(loss, params))))
    peng = Engine(pm, loss=port_llama.LlamaPretrainingCriterion(),
                  optimizer=AdamW(learning_rate=_LR, weight_decay=0.01,
                                  fused_kernel=True))
    psteps = [float(peng.train_batch([ids], [labels])[0]) for _ in range(2)]
    _RUNS[key] = dict(
        jax=(float(jloss), jgrads, jsteps, numpy_state(jm)),
        port=(loss.item(), pgrads, psteps,
              {k: v.detach().numpy() for k, v in pm.state_dict().items()}))
    return _RUNS[key]


@pytest.mark.parametrize("key", list(_OPTION_SETS))
def test_loss_and_gradients_match_the_reference(key):
    (jloss, jgrads, _, _), (ploss, pgrads, _, _) = (_run(key)["jax"],
                                                    _run(key)["port"])
    np.testing.assert_allclose(ploss, jloss, rtol=1e-5)
    assert set(pgrads) == set(jgrads)
    for n, want in jgrads.items():
        np.testing.assert_allclose(pgrads[n], want, atol=1e-5, rtol=0,
                                   err_msg=n)
        assert np.abs(want).max() > 0 or "k_proj" in n, n


@pytest.mark.parametrize("key", list(_OPTION_SETS))
def test_engine_steps_match_the_reference(key):
    jloss, jgrads, jsteps, jstate = _run(key)["jax"]
    _, pgrads, psteps, pstate = _run(key)["port"]
    np.testing.assert_allclose(psteps, jsteps, rtol=1e-5)
    assert psteps[1] < psteps[0]
    assert set(pstate) == set(jstate)
    for n, want in jstate.items():
        diff = np.abs(pstate[n] - want)
        steep = (np.abs(jgrads[n]) < 1e-6) | (np.abs(pgrads[n]) < 1e-6)
        assert diff[~steep].max(initial=0.0) <= 1e-5, n
        assert diff[steep].max(initial=0.0) <= 2 * _LR * len(jsteps), n


def test_untied_head_trains_through_its_transpose():
    """The untied chunked head's weight is the lm_head's [in, out] weight
    transposed: its gradient reaches lm_head.weight (and the embedding
    gets only the lookup's), as with the plain head."""
    _, pgrads, _, _ = _run("chunked_untied")["port"]
    _, plain, _, _ = _run("plain")["port"]
    assert pgrads["lm_head.weight"].shape == plain["lm_head.weight"].shape
    assert np.abs(pgrads["lm_head.weight"]).max() > 0


class _Tokens(Dataset):
    def __init__(self, n=4):
        rng = np.random.default_rng(2)
        self.ids = rng.integers(0, 256, (n, _S)).astype(np.int64)
        self.labels = rng.integers(0, 256, (n, _S)).astype(np.int64)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return self.ids[i], self.labels[i]


def test_model_fit_passes_the_loss_only_output():
    """``Model.fit`` of a chunked model: the ``_loss_only_aux`` dict goes
    to the loss only, the loss falls, and the same steps through the
    Engine give the same parameters."""
    def build():
        return port_llama.LlamaForCausalLM.from_config_name(
            "llama-tiny", device="cpu", generator=seed(4, device="cpu"),
            chunked_ce=16)
    net = build()
    model = Model(net)
    model.prepare(AdamW(1e-3, parameters=net.named_parameters()),
                  port_llama.LlamaPretrainingCriterion())
    ds = _Tokens()
    out = model.train_batch([torch.from_numpy(ds.ids[:2])],
                            [torch.from_numpy(ds.labels[:2])])
    assert len(out) == 1 and isinstance(out[0], float)
    model.fit(ds, batch_size=2, epochs=2, verbose=0, shuffle=False)
    ref = build().train()
    eng = Engine(ref, loss=port_llama.LlamaPretrainingCriterion(),
                 optimizer=AdamW(1e-3))
    losses = [float(eng.train_batch([torch.from_numpy(ds.ids[:2])],
                                    [torch.from_numpy(ds.labels[:2])])[0])]
    for _ in range(2):
        for i in (0, 2):
            losses.append(float(eng.train_batch(
                [torch.from_numpy(ds.ids[i:i + 2])],
                [torch.from_numpy(ds.labels[i:i + 2])])[0]))
    assert losses[-1] < losses[0]
    for (n, a), b in zip(net.state_dict().items(), ref.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
