"""ERNIE and BERT pretraining with the PyTorch port vs the JAX package.

Models are built and seeded in the JAX package at tiny size (2 layers,
hidden 128, 2 heads: head_dim 64, as the card's kernels take) and their
``state_dict`` crosses into the port through numpy (``load_numpy_state``).
Forward outputs must agree within 1e-5 with ``fused_ln`` off and on (on:
the y-only fused residual-add + LayerNorm twins, twice a layer), the
pretraining criterion within 1e-6, and three ``Engine.train_batch`` steps
of ERNIE with ``fused_ln=True`` and ``AdamW(fused_kernel=True)`` within
1e-5 in f32 and 1e-2 with bf16 AMP — the JAX side runs the Pallas
LayerNorm kernels in interpret mode off the TPU, so this holds the port
against the kernels themselves. ERNIE-3.0-base has the reference's 207
keys and sends 77 leaves to the AdamW kernel. The eight task heads give
the reference's outputs on a padded batch; ``from_pretrained`` of a bare
name raises the reference's download recipe. What the slice leaves out
raises.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.hapi.engine import Engine as JaxEngine
from paddle_tpu.nlp import bert as jax_bert
from paddle_tpu.nlp import ernie as jax_ernie
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch import seed
from paddle_tpu_torch.hapi import Engine
from paddle_tpu_torch.nlp import bert as port_bert
from paddle_tpu_torch.nlp import ernie as port_ernie
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.ops.kernels import fused_ln as port_ln
from paddle_tpu_torch.ops.kernels.fused_adamw import fused_adamw_supported
from paddle_tpu_torch.optimizer import AdamW
from torch_threads import one_torch_thread  # noqa: F401

_OVR = dict(hidden_size=128, num_attention_heads=2)  # head_dim 64
_B, _S, _STEPS = 2, 64, 3
_FAMILIES = {
    "ernie": (jax_ernie, port_ernie, "ernie-tiny", "ErnieForPretraining",
              "ErniePretrainingCriterion"),
    "bert": (jax_bert, port_bert, "bert-tiny", "BertForPretraining",
             "BertPretrainingCriterion"),
}


def numpy_state(jax_model):
    return {k: np.asarray(v._value) for k, v in
            jax_model.state_dict().items()}


def _models(family, **ovr):
    """(JAX model, port model with the JAX weights), both in eval mode."""
    jmod, pmod, name, cls, _ = _FAMILIES[family]
    paddle.seed(0)
    jm = getattr(jmod, cls)(jmod._resolve_config(name, **_OVR, **ovr))
    jm.eval()
    pm = getattr(pmod, cls)(pmod._resolve_config(name, **_OVR, **ovr),
                            device="cpu", generator=seed(0, device="cpu"))
    load_numpy_state(pm, numpy_state(jm))
    return jm, pm.eval()


def _batch(vocab=512, b=_B, s=_S, seed_=0):
    rng = np.random.default_rng(seed_)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = np.where(rng.random((b, s)) < 0.15,
                      rng.integers(0, vocab, (b, s)), -100).astype(np.int32)
    nsp = rng.integers(0, 2, (b,)).astype(np.int32)
    return ids, labels, nsp


@pytest.mark.parametrize("family", ["ernie", "bert"])
def test_state_dict_keys_match(family):
    jm, pm = _models(family)
    assert list(numpy_state(jm)) == list(pm.state_dict())


@pytest.mark.parametrize("fused_ln", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("family", ["ernie", "bert"])
def test_pretraining_forward_matches_jax(family, fused_ln):
    """Prediction scores, NSP scores and the backbone's (sequence,
    pooled) outputs; token types given for half the positions."""
    jm, pm = _models(family, fused_ln=fused_ln)
    ids, _, _ = _batch(seed_=1)
    tt = (np.arange(_S)[None, :] >= _S // 2).astype(np.int32).repeat(_B, 0)
    want = jm(paddle.to_tensor(ids), paddle.to_tensor(tt))
    backbone = getattr(jm, family)
    want_bb = backbone(paddle.to_tensor(ids), paddle.to_tensor(tt))
    with torch.no_grad():
        got = pm(torch.from_numpy(ids), torch.from_numpy(tt))
        got_bb = getattr(pm, family)(torch.from_numpy(ids),
                                     torch.from_numpy(tt))
    for g, w in zip(got + got_bb, tuple(want) + tuple(want_bb)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w._value),
                                   atol=1e-5, rtol=0)


def test_padding_mask_matches_jax():
    """A 0/1 padding attention_mask: the reference's dense path against
    the port's flash path with the mask (its twins here; the kernels on
    the card)."""
    jm, pm = _models("ernie", fused_ln=True)
    ids, _, _ = _batch(seed_=2)
    mask = (np.arange(_S)[None, :] < np.array([[40], [64]])).astype(np.int32)
    want = jm(paddle.to_tensor(ids), attention_mask=paddle.to_tensor(mask))
    with torch.no_grad():
        got = pm(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w._value),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["labels", "weights", "mlm_only"])
def test_criterion_matches_jax(case):
    """The masked-mean MLM loss (-100 positions ignored, or weighted by
    masked_lm_weights) plus the NSP cross entropy."""
    rng = np.random.default_rng(4)
    scores = rng.standard_normal((_B, 16, 50)).astype(np.float32)
    nsp_scores = rng.standard_normal((_B, 2)).astype(np.float32)
    labels = np.where(rng.random((_B, 16)) < 0.3,
                      rng.integers(0, 50, (_B, 16)), -100).astype(np.int32)
    nsp = rng.integers(0, 2, (_B,)).astype(np.int32)
    weights = (rng.random((_B, 16)) * (labels != -100)).astype(np.float32)
    args = [scores, nsp_scores, labels, None if case == "mlm_only" else nsp]
    kw = {"masked_lm_weights": weights} if case == "weights" else {}
    want = jax_ernie.ErniePretrainingCriterion()(
        *[None if a is None else paddle.to_tensor(a) for a in args],
        **{k: paddle.to_tensor(v) for k, v in kw.items()})
    got = port_ernie.ErniePretrainingCriterion()(
        *[None if a is None else torch.from_numpy(a) for a in args],
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def start():
    """A 2-layer ERNIE with fused_ln in the JAX package: its initial
    weights and one pretraining batch."""
    jm, _ = _models("ernie", fused_ln=True)
    return numpy_state(jm), _batch()


def _jax_run(state, batch, amp):
    ids, labels, nsp = batch
    jm = jax_ernie.ErnieForPretraining(jax_ernie._resolve_config(
        "ernie-tiny", **_OVR, fused_ln=True))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    jm.train()
    eng = JaxEngine(jm, loss=jax_ernie.ErniePretrainingCriterion(),
                    optimizer=JaxAdamW(learning_rate=1e-4, weight_decay=0.01,
                                       parameters=jm.parameters(),
                                       fused_kernel=True),
                    amp_dtype=jnp.bfloat16 if amp else None)
    losses = [float(eng.train_batch([jnp.asarray(ids)],
                                    [jnp.asarray(labels),
                                     jnp.asarray(nsp)])[0])
              for _ in range(_STEPS)]
    return losses, numpy_state(jm)


def _port_run(state, batch, amp):
    ids, labels, nsp = batch
    pm = port_ernie.ErnieForPretraining(
        port_ernie._resolve_config("ernie-tiny", **_OVR, fused_ln=True),
        device="cpu", generator=seed(0, device="cpu"))
    load_numpy_state(pm, state).train()
    eng = Engine(pm, loss=port_ernie.ErniePretrainingCriterion(),
                 optimizer=AdamW(learning_rate=1e-4, weight_decay=0.01,
                                 fused_kernel=True),
                 amp_dtype=torch.bfloat16 if amp else None)
    calls = port_ln.fused_add_layer_norm_y_fwd.launches
    losses = [float(eng.train_batch([ids], [labels, nsp])[0])
              for _ in range(_STEPS)]
    assert port_ln.fused_add_layer_norm_y_fwd.launches == calls  # CPU: twins
    return losses, {k: v.detach().numpy() for k, v in
                    pm.state_dict().items()}


@pytest.mark.parametrize("amp,tol", [(False, 1e-5), (True, 1e-2)])
def test_engine_matches_jax_engine(start, amp, tol):
    state, batch = start
    jl, jp = _jax_run(state, batch, amp)
    pl, pp = _port_run(state, batch, amp)
    np.testing.assert_allclose(pl, jl, rtol=tol, atol=0)
    assert pl[-1] < pl[0]
    assert list(pp) == list(jp)
    for k in jp:
        np.testing.assert_allclose(pp[k], jp[k], atol=tol, rtol=0,
                                   err_msg=k)


def test_ernie_base_keys_and_adamw_leaves():
    """ERNIE-3.0-base: the reference's 207 state-dict keys, and 77 f32
    leaves of at least 16384 elements for the AdamW kernel (6 matrices a
    layer, the word and position embeddings, the pooler's dense weight,
    cls.transform.weight and cls.decoder_bias)."""
    pm = port_ernie.ErnieForPretraining.from_config_name(
        "ernie-3.0-base-zh", device="cpu", generator=seed(0, device="cpu"))
    sd = pm.state_dict()
    assert len(sd) == 207
    assert sum(1 for k in sd if k.startswith("ernie.")) == 200
    big = sorted(n for n, p in pm.named_parameters()
                 if fused_adamw_supported(p, p, p))
    assert len(big) == 77
    assert {"ernie.embeddings.word_embeddings.weight",
            "ernie.embeddings.position_embeddings.weight",
            "ernie.pooler.dense.weight", "cls.transform.weight",
            "cls.decoder_bias"} <= set(big)


@pytest.mark.parametrize("flag", [
    dict(scan_layers=True), dict(fused_qkv=True),
    dict(mlm_gather_capacity=0.25), dict(use_flash_attention=False)])
@pytest.mark.parametrize("family", ["ernie", "bert"])
def test_unported_options_raise(family, flag):
    _, pmod, name, _, _ = _FAMILIES[family]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pmod._resolve_config(name, **flag)


@pytest.mark.parametrize("head", [
    "ForSequenceClassification", "ForTokenClassification",
    "ForQuestionAnswering", "ForMaskedLM"])
@pytest.mark.parametrize("family", ["Ernie", "Bert"])
def test_task_heads_raise(family, head):
    """Item 4.1 landed: each task head, built in the JAX package and
    carried across by its state dict (the reference's keys), gives the
    reference's outputs on a padded batch within 1e-5 in eval mode."""
    jmod, pmod, name = ((jax_ernie, port_ernie, "ernie-tiny")
                        if family == "Ernie" else
                        (jax_bert, port_bert, "bert-tiny"))
    paddle.seed(0)
    jm = getattr(jmod, family + head)(jmod._resolve_config(name, **_OVR))
    jm.eval()
    pm = getattr(pmod, family + head)(pmod._resolve_config(name, **_OVR),
                                      device="cpu",
                                      generator=seed(0, device="cpu"))
    assert list(pm.state_dict()) == list(numpy_state(jm))
    load_numpy_state(pm, numpy_state(jm)).eval()
    ids, _, _ = _batch(seed_=3)
    mask = (np.arange(_S)[None, :] < np.array([[_S], [21]])).astype(np.int64)
    want = jm(paddle.to_tensor(ids), attention_mask=paddle.to_tensor(mask))
    with torch.no_grad():
        got = pm(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w._value),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("cls", [port_bert.BertModel,
                                 port_bert.BertForPretraining,
                                 port_ernie.ErnieModel,
                                 port_ernie.ErnieForPretraining])
def test_from_pretrained_raises(cls):
    """Item 4.4 landed: a bare config name needs a download, and raises
    the reference's recipe before anything is built (the reference's text:
    save the state dict there, pass pretrained_path=)."""
    name = "ernie-3.0-base-zh" if "Ernie" in cls.__name__ else \
        "bert-base-uncased"
    with pytest.raises(NotImplementedError, match="needs a weights download"
                       ) as info:
        cls.from_pretrained(name)
    assert f"pretrained_path='{name}.pdparams'" in str(info.value)
