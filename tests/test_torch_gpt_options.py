"""GPT's training options in the PyTorch port: ``recompute``,
``scan_layers``, ``fused_qkv``, ``chunked_ce``, against the port without
them and against the JAX package.

``gpt-tiny`` (2 layers, hidden 64, 4 heads of 16, vocabulary 256) at batch
2 x 24. In the port alone, at dropout 0.1 from one generator seed:

- recompute on against off: loss and every gradient equal bit for bit,
  over two steps (the rerun layers see the forward's dropout draws, and
  the generator moves as far);
- scan_layers against the unrolled blocks: bit for bit, the stacked
  gradients the per-layer ones stacked;
- fused_qkv against the separate projections from the fused state
  (``fuse_qkv_state``): 1e-6;
- chunked_ce against the plain head and criterion, with labels of -100
  and a chunk of 7 that does not divide the 48 tokens: 1e-6.

Against the JAX package (dropout 0, f32), each option set's loss and
gradients (the JAX Engine's gradient program, ``train_batch_accum``
without an update) and two Engine steps of AdamW (loss, parameters),
1e-5, and 2 * lr a step where a gradient is within 1e-6 of 0 (Adam's step
is then a step function of rounding noise); the weights cross through
``load_numpy_state`` from a state in another layout than the model's.
The state conversions (``fuse_qkv_state``, ``split_qkv_state``,
``stack_layer_state``, ``unstack_layer_state``) give the reference's
arrays exactly, and refuse what the reference's refuse.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.hapi.engine import Engine as JaxEngine
from paddle_tpu.nlp import gpt as jax_gpt
from paddle_tpu.nn import scan_stack as jax_scan
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch import seed
from paddle_tpu_torch.hapi import Engine
from paddle_tpu_torch.nlp import gpt as port_gpt
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.nn import scan_stack as port_scan
from paddle_tpu_torch.optimizer import AdamW
from torch_threads import one_torch_thread  # noqa: F401

_B, _S = 2, 24
_DROP = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
_LR = 1e-4


def numpy_state(jax_model):
    return {k: np.asarray(v._value) for k, v in
            jax_model.state_dict().items()}


def _batch(seed_=0, ignored=True):
    rng = np.random.default_rng(seed_)
    ids = rng.integers(0, 256, (_B, _S)).astype(np.int64)
    labels = rng.integers(0, 256, (_B, _S)).astype(np.int64)
    if ignored:
        labels[0, :5] = -100
        labels[1, -3:] = -100
    return torch.from_numpy(ids), torch.from_numpy(labels)


def _port(weights_seed=0, **ovr):
    return port_gpt.GPTForCausalLM.from_config_name(
        "gpt-tiny", device="cpu", generator=seed(weights_seed, device="cpu"),
        **ovr).train()


def _loss_grads(model, ids, labels):
    loss = port_gpt.GPTPretrainingCriterion()(model(ids), labels)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), dict(zip(names, grads))


def _same_run(a, b, steps=2):
    """Both models' losses and gradients equal bit for bit over ``steps``
    forward/backward passes from one generator seed each."""
    seed(7, generator=a.gpt.embeddings.dropout.generator)
    seed(7, generator=b.gpt.embeddings.dropout.generator)
    for i in range(steps):
        ids, labels = _batch(i)
        la, ga = _loss_grads(a, ids, labels)
        lb, gb = _loss_grads(b, ids, labels)
        assert torch.equal(la, lb), (i, la, lb)
        yield ga, gb


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scanned"])
def test_recompute_is_bit_for_bit_with_dropout(scan):
    off = _port(scan_layers=scan, **_DROP)
    on = _port(scan_layers=scan, recompute=True, **_DROP)
    on.load_state_dict(off.state_dict())
    for ga, gb in _same_run(off, on):
        assert ga.keys() == gb.keys()
        for n in ga:
            assert torch.equal(ga[n], gb[n]), n


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scanned"])
def test_recompute_under_the_amp_engine_is_bit_for_bit(scan):
    """Through the Engine with bf16 AMP (the parameters cast inside its
    functional_call, gone from the modules when the backward reruns a
    layer), at dropout 0.1: two steps' losses and parameters equal."""
    runs = []
    for recompute in (False, True):
        model = _port(scan_layers=scan, recompute=recompute, **_DROP)
        eng = Engine(model, loss=port_gpt.GPTPretrainingCriterion(),
                     optimizer=AdamW(learning_rate=_LR, weight_decay=0.01,
                                     fused_kernel=True),
                     amp_dtype=torch.bfloat16, generator=seed(9, "cpu"))
        losses = [eng.train_batch(list(_batch(i)[:1]),
                                  list(_batch(i)[1:]))[0] for i in range(2)]
        runs.append((losses, model.state_dict()))
    (la, sa), (lb, sb) = runs
    assert all(torch.equal(a, b) for a, b in zip(la, lb)), (la, lb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_scanned_is_the_unrolled_model():
    """The scanned model from the unrolled one's stacked state: the same
    losses and gradients at dropout 0.1 (the generator draws in the same
    order), its state key for key the reference's scanned layout."""
    unrolled = _port(**_DROP)
    scanned = _port(scan_layers=True, recompute=True, **_DROP)
    state = {k: v.numpy() for k, v in unrolled.state_dict().items()}
    stacked = port_scan.stack_layer_state(state, 2, prefix="gpt.h.")
    assert set(stacked) == set(scanned.state_dict())
    load_numpy_state(scanned, stacked)
    for ga, gb in _same_run(unrolled, scanned):
        flat = port_scan.stack_layer_state(
            {k: v.numpy() for k, v in ga.items()}, 2, prefix="gpt.h.")
        for n, g in gb.items():
            np.testing.assert_array_equal(g.numpy(), flat[n], err_msg=n)
    with pytest.raises(NotImplementedError, match="scan_layers"):
        scanned.eval().generate(_batch()[0][:, :4], max_new_tokens=2)


def test_fused_qkv_is_the_separate_model():
    sep = _port()
    fused = _port(fused_qkv=True)
    load_numpy_state(fused, port_gpt.fuse_qkv_state(
        {k: v.numpy() for k, v in sep.state_dict().items()}, 4))
    ids, labels = _batch()
    la, ga = _loss_grads(sep, ids, labels)
    lb, gb = _loss_grads(fused, ids, labels)
    torch.testing.assert_close(lb, la, rtol=1e-6, atol=1e-6)
    back = port_gpt.split_qkv_state({k: v.numpy() for k, v in gb.items()}, 4)
    for n, g in ga.items():
        np.testing.assert_allclose(back[n], g.numpy(), atol=1e-6, err_msg=n)


def test_chunked_ce_is_the_plain_head():
    """Per-token losses, the mean and the gradients (the tied weight's
    summed over the chunks) of the chunked head against the plain head
    and criterion; -100 rows give exactly 0."""
    plain = _port()
    chunked = _port(chunked_ce=7)
    chunked.load_state_dict(plain.state_dict())
    ids, labels = _batch()
    out = chunked(ids)
    assert out["_loss_only_aux"] and out["chunked_ce"] == 7
    per_tok = port_gpt.GPTPretrainingCriterion._chunked_head_ce(
        out["hidden"], out["lm_weight"], labels, 7)
    want = port_gpt.GPTPretrainingCriterion().ce(plain(ids), labels)
    torch.testing.assert_close(per_tok, want, rtol=1e-6, atol=1e-6)
    assert not per_tok[labels == -100].any()
    la, ga = _loss_grads(plain, ids, labels)
    lb, gb = _loss_grads(chunked, ids, labels)
    torch.testing.assert_close(lb, la, rtol=1e-6, atol=1e-6)
    for n in ga:
        torch.testing.assert_close(gb[n], ga[n], rtol=1e-5, atol=1e-6,
                                   msg=n)
    assert not isinstance(chunked.eval()(ids), dict)


# -- against the JAX package ------------------------------------------------

_OPTION_SETS = {
    "fused_qkv": dict(fused_qkv=True),
    "scan_recompute": dict(scan_layers=True, recompute=True),
    "chunked_ce": dict(chunked_ce=7),
    "all": dict(fused_qkv=True, scan_layers=True, recompute=True,
                chunked_ce=7),
}
_RUNS = {}


def _reference_run(key):
    """Both packages' loss, gradients and two Engine steps of one option
    set from the reference's weights, once a set."""
    if key in _RUNS:
        return _RUNS[key]
    ovr = _OPTION_SETS[key]
    paddle.seed(3)
    jm = jax_gpt.GPTForCausalLM(jax_gpt._resolve_config("gpt-tiny", **ovr))
    state = numpy_state(jm)
    ids, labels = (t.numpy() for t in _batch(0))
    jeng = JaxEngine(jm, loss=jax_gpt.GPTPretrainingCriterion(),
                     optimizer=JaxAdamW(learning_rate=_LR,
                                        weight_decay=0.01,
                                        parameters=jm.parameters()))
    jloss, _, _ = jeng.train_batch_accum([ids], [labels], False)
    jgrads = {k: np.asarray(v) for k, v in jeng._acc_grads.items()}
    jeng.reset_accum_window()
    jsteps = [float(jeng.train_batch([ids], [labels])[0]) for _ in range(2)]
    # the port model from the state in the other layout
    other = port_scan.unstack_layer_state(state, 2, prefix="gpt.h.") \
        if ovr.get("scan_layers") else state
    if ovr.get("fused_qkv"):
        other = port_gpt.split_qkv_state(other, 4)
    pm = _port(**ovr)
    load_numpy_state(pm, other)
    ploss, pgrads = _loss_grads(pm, torch.from_numpy(ids),
                                torch.from_numpy(labels))
    peng = Engine(pm, loss=port_gpt.GPTPretrainingCriterion(),
                  optimizer=AdamW(learning_rate=_LR, weight_decay=0.01,
                                  fused_kernel=True))
    psteps = [float(peng.train_batch([ids], [labels])[0]) for _ in range(2)]
    _RUNS[key] = dict(
        jax=(float(jloss), jgrads, jsteps, numpy_state(jm)),
        port=(ploss.item(), {k: v.numpy() for k, v in pgrads.items()},
              psteps, {k: v.detach().numpy()
                       for k, v in pm.state_dict().items()}))
    return _RUNS[key]


@pytest.mark.parametrize("key", sorted(_OPTION_SETS))
def test_options_match_the_reference(key):
    got = _reference_run(key)
    jloss, jgrads, jsteps, jstate = got["jax"]
    ploss, pgrads, psteps, pstate = got["port"]
    np.testing.assert_allclose(ploss, jloss, rtol=1e-5)
    assert set(pgrads) == set(jgrads) == set(jstate) == set(pstate)
    for n, want in jgrads.items():
        np.testing.assert_allclose(pgrads[n], want, atol=1e-5, rtol=0,
                                   err_msg=n)
    np.testing.assert_allclose(psteps, jsteps, rtol=1e-5)
    for n, want in jstate.items():
        # Adam moves an element whose gradient is within rounding of 0 (the
        # key bias's, 0 in exact arithmetic) by up to lr a step either way
        diff = np.abs(pstate[n] - want)
        steep = (np.abs(jgrads[n]) < 1e-6) | (np.abs(pgrads[n]) < 1e-6)
        assert diff[~steep].max(initial=0.0) <= 1e-5, n
        assert diff[steep].max(initial=0.0) <= 2 * _LR * len(jsteps), n


def test_state_conversions_are_the_reference_functions():
    paddle.seed(5)
    jm = jax_gpt.GPTForCausalLM(jax_gpt._resolve_config("gpt-tiny"))
    state = numpy_state(jm)
    fused = port_gpt.fuse_qkv_state(state, 4)
    want = jax_gpt.fuse_qkv_state(state, 4)
    assert fused.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(fused[k], np.asarray(want[k]))
    back = port_gpt.split_qkv_state(fused, 4)
    for k, v in jax_gpt.split_qkv_state(want, 4).items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
        np.testing.assert_array_equal(back[k], state[k])
    stacked = port_scan.stack_layer_state(fused, 2, prefix="gpt.h.")
    for k, v in jax_scan.stack_layer_state(want, 2, prefix="gpt.h.").items():
        np.testing.assert_array_equal(stacked[k], np.asarray(v))
    for k, v in port_scan.unstack_layer_state(stacked, 2,
                                              prefix="gpt.h.").items():
        np.testing.assert_array_equal(v, fused[k])
    # the reference's refusals
    for fn, arg in ((port_gpt.fuse_qkv_state, {"a.b": 1}),
                    (port_gpt.fuse_qkv_state, stacked),
                    (port_gpt.split_qkv_state, state)):
        with pytest.raises(ValueError, match="converted 0"):
            fn(arg, 4)
    partial = {k: v for k, v in state.items() if "v_proj" not in k}
    with pytest.raises(ValueError, match="incomplete"):
        port_gpt.fuse_qkv_state(partial, 4)
    with pytest.raises(ValueError, match="missing indices"):
        port_scan.stack_layer_state(state, 3, prefix="gpt.h.")
    with pytest.raises(ValueError, match="leading dim"):
        port_scan.unstack_layer_state(stacked, 3, prefix="gpt.h.")


def test_scanned_stack_refuses_buffers_and_keeps_the_names():
    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(3, 3)
            self.register_buffer("stat", torch.zeros(3))

        def forward(self, x):
            return self.lin(x)

    with pytest.raises(ValueError, match="buffers"):
        port_scan.ScannedLayerStack([Block(), Block()])
    stack = port_scan.ScannedLayerStack(
        [torch.nn.Sequential(torch.nn.Linear(3, 3)) for _ in range(4)])
    assert [n for n, _ in stack.named_parameters()] == ["0__weight",
                                                        "0__bias"]
    assert stack.get_parameter("0__weight").shape == (4, 3, 3)
    # eager training sees through the loop (the reference's eager tape
    # cannot, and refuses it)
    stack(torch.randn(2, 3)).sum().backward()
    assert stack.get_parameter("0__weight").grad.shape == (4, 3, 3)
