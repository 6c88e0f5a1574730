"""ERNIE/BERT fine-tuning on padded batches with the port vs the JAX
package: the task heads' weights crossing, ``Engine`` steps of a
sequence classifier, ``from_pretrained`` of every family and
``paddle.Model`` with three input specs.

Models are built in the JAX package at 2 layers, hidden 64 (4 heads of
16) and cross into the port by their state dicts. The batch is padded on
the right with ``pad_token_id`` 0 and carries the tokenizer's 0/1
``attention_mask`` (int64), labelled as ``examples/finetune_bert.py``
labels (token 7 in the unpadded part). Three ``Engine.train_batch`` steps
of ``ErnieForSequenceClassification`` at dropout 0 (AdamW with the fused
kernel, as the card's fine-tune builds it) match the JAX Engine: losses
and parameters at 1e-5 in f32, 1e-2 with bf16 AMP. Every head's weights
cross bit for bit in f32, bf16 and float16 (``load_numpy_state``).
``from_pretrained`` reads a file the reference's ``paddle.save`` wrote,
in both of the reference's forms, into a plain or (GPT, Llama) scanned
model, and refuses what the reference refuses.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.hapi.engine import Engine as JaxEngine
from paddle_tpu.nlp import bert as jax_bert
from paddle_tpu.nlp import ernie as jax_ernie
from paddle_tpu.nlp import gpt as jax_gpt
from paddle_tpu.nlp import llama as jax_llama
from paddle_tpu.optimizer import AdamW as JaxAdamW
import paddle_tpu_torch as pt
from paddle_tpu_torch import seed
from paddle_tpu_torch.hapi import Engine
from paddle_tpu_torch.nlp import bert as port_bert
from paddle_tpu_torch.nlp import ernie as port_ernie
from paddle_tpu_torch.nlp import gpt as port_gpt
from paddle_tpu_torch.nlp import llama as port_llama
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.optimizer import AdamW
from torch_threads import one_torch_thread  # noqa: F401

_OVR = dict(hidden_size=64, num_attention_heads=4)
_HEADS = ("ForSequenceClassification", "ForTokenClassification",
          "ForQuestionAnswering", "ForMaskedLM")
_FAMILIES = {"Ernie": (jax_ernie, port_ernie, "ernie-tiny"),
             "Bert": (jax_bert, port_bert, "bert-tiny")}
_B, _S, _STEPS = 4, 24, 3


def numpy_state(jax_model):
    return {k: np.asarray(v._value) for k, v in
            jax_model.state_dict().items()}


def _padded_batch(seed_=0, vocab=512, b=_B, s=_S):
    """(input_ids, token_type_ids, attention_mask, labels) as int64 numpy:
    lengths uniform in [8, s], right padding with 0, label 1 where token 7
    appears in the unpadded part."""
    rng = np.random.default_rng(seed_)
    lens = rng.integers(8, s + 1, b)
    keep = np.arange(s)[None, :] < lens[:, None]
    ids = np.where(keep, rng.integers(1, vocab, (b, s)), 0)
    ids[0, 3] = 7  # one positive at least
    labels = ((ids == 7) & keep).any(axis=1).astype(np.int64)
    return ids, np.zeros_like(ids), keep.astype(np.int64), labels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_head_weights_cross_bit_for_bit(dtype):
    """Every head of both families: the reference's state cast to dtype
    loads into a port head built in that dtype with the same bits, key
    for key (``load_numpy_state``)."""
    tdt = getattr(torch, dtype)
    for family, (jmod, pmod, name) in _FAMILIES.items():
        for head in _HEADS:
            paddle.seed(0)
            jm = getattr(jmod, family + head)(jmod._resolve_config(
                name, **_OVR))
            state = {k: np.asarray(v._value.astype(getattr(jnp, dtype)))
                     for k, v in jm.state_dict().items()}
            pm = getattr(pmod, family + head)(
                pmod._resolve_config(name, **_OVR), device="cpu",
                dtype=tdt, generator=seed(0, device="cpu"))
            load_numpy_state(pm, state)
            got = pm.state_dict()
            assert list(got) == list(state), family + head
            for k, v in state.items():
                bits = np.dtype(f"uint{8 * v.dtype.itemsize}")
                assert got[k].dtype == tdt
                width = {1: torch.int8, 2: torch.int16, 4: torch.int32}
                np.testing.assert_array_equal(
                    got[k].view(width[v.dtype.itemsize]).numpy().view(bits),
                    v.view(bits), err_msg=f"{family}{head} {k}")


@pytest.fixture(scope="module")
def classifier_start():
    """A 2-layer ERNIE sequence classifier built in the JAX package (its
    weights) and a padded batch."""
    paddle.seed(0)
    jm = jax_ernie.ErnieForSequenceClassification(
        jax_ernie._resolve_config("ernie-tiny", **_OVR), num_labels=2)
    return numpy_state(jm), _padded_batch()


@pytest.mark.parametrize("amp,tol", [(False, 1e-5), (True, 1e-2)])
def test_engine_steps_match_reference(classifier_start, amp, tol):
    """Three Engine steps on the padded batch (three inputs, one label),
    examples/finetune_bert.py's loop: losses and every parameter."""
    state, (ids, tt, mask, labels) = classifier_start
    jm = jax_ernie.ErnieForSequenceClassification(
        jax_ernie._resolve_config("ernie-tiny", **_OVR), num_labels=2)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    jm.train()
    jeng = JaxEngine(jm, loss=paddle.nn.CrossEntropyLoss(),
                     optimizer=JaxAdamW(1e-3, weight_decay=0.01,
                                        parameters=jm.parameters(),
                                        fused_kernel=True),
                     amp_dtype=jnp.bfloat16 if amp else None)
    jl = [float(jeng.train_batch([jnp.asarray(a) for a in (ids, tt, mask)],
                                 [jnp.asarray(labels)])[0])
          for _ in range(_STEPS)]
    pm = port_ernie.ErnieForSequenceClassification(
        port_ernie._resolve_config("ernie-tiny", **_OVR), num_labels=2,
        device="cpu", generator=seed(0, device="cpu"))
    load_numpy_state(pm, state).train()
    peng = Engine(pm, loss=pt.nn.CrossEntropyLoss(),
                  optimizer=AdamW(1e-3, weight_decay=0.01,
                                  fused_kernel=True),
                  amp_dtype=torch.bfloat16 if amp else None)
    pl = [float(peng.train_batch([torch.from_numpy(a)
                                  for a in (ids, tt, mask)],
                                 [torch.from_numpy(labels)])[0])
          for _ in range(_STEPS)]
    np.testing.assert_allclose(pl, jl, rtol=tol, atol=0)
    assert pl[-1] < pl[0]
    jp = numpy_state(jm)
    for k, v in pm.state_dict().items():
        np.testing.assert_allclose(v.detach().float().numpy(), jp[k],
                                   atol=tol, rtol=0, err_msg=k)


def test_model_fit_takes_three_input_specs():
    """paddle.Model with three named InputSpecs and one label: fit,
    evaluate and predict bind input_ids, token_type_ids and attention_mask
    to the head's parameters of those names (position_ids between them
    keeps its default; in order, as the reference binds them, the mask
    would land in position_ids), predict too (the reference hands a
    multi-input network only the first field); predict's logits are the
    network's."""
    from paddle_tpu_torch.io import DataLoader, Dataset
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.static import InputSpec
    ids, tt, mask, labels = _padded_batch(seed_=1, b=8)

    class Padded(Dataset):
        def __len__(self):
            return len(ids)

        def __getitem__(self, i):
            return ids[i], tt[i], mask[i], labels[i]

    net = port_ernie.ErnieForSequenceClassification(
        port_ernie._resolve_config("ernie-tiny", **_OVR), device="cpu",
        generator=seed(0, device="cpu"))
    calls = []
    net.register_forward_pre_hook(lambda m, args: calls.append(args))
    specs = [InputSpec([None, _S], "int64", n) for n in
             ("input_ids", "token_type_ids", "attention_mask")]
    model = pt.Model(net, inputs=specs,
                     labels=[InputSpec([None, 1], "int64", "label")])
    model.prepare(AdamW(3e-5, weight_decay=0.01, fused_kernel=True),
                  pt.nn.CrossEntropyLoss(), Accuracy())
    loader = DataLoader(Padded(), batch_size=4)
    model.fit(loader, epochs=1, verbose=0)
    res = model.evaluate(loader, verbose=0)
    assert set(res) >= {"loss", "acc"}
    pred = model.predict(loader, stack_outputs=True, verbose=0)[0]
    assert len(calls) == 6
    for i, args in enumerate(calls):
        rows = slice(4 * (i % 2), 4 * (i % 2) + 4)
        assert len(args) == 4 and args[2] is None
        assert torch.equal(args[0].cpu(), torch.from_numpy(ids[rows]))
        assert torch.equal(args[3].cpu(), torch.from_numpy(mask[rows]))
    net.eval()
    with torch.no_grad():
        want = net(torch.from_numpy(ids), torch.from_numpy(tt),
                   attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(pred, want.numpy(), atol=1e-6, rtol=0)


_PRETRAINED = {
    "bert": (jax_bert.BertForSequenceClassification,
             port_bert.BertForSequenceClassification, "bert-tiny", {}),
    "ernie": (jax_ernie.ErnieModel, port_ernie.ErnieModel, "ernie-tiny",
              {}),
    "gpt": (jax_gpt.GPTForCausalLM, port_gpt.GPTForCausalLM, "gpt-tiny",
            dict(scan_layers=True, fused_qkv=True)),
    "llama": (jax_llama.LlamaForCausalLM, port_llama.LlamaForCausalLM,
              "llama-tiny", dict(scan_layers=True)),
}


@pytest.mark.parametrize("family", sorted(_PRETRAINED))
def test_from_pretrained_loads_reference_checkpoint(family, tmp_path):
    """A checkpoint the reference's paddle.save wrote loads through both
    forms (name + pretrained_path=, path + config_name=) with its bits, and
    the model gives the reference's outputs on a padded batch; GPT and
    Llama also load it into a scanned (GPT: fused q/k/v) model, whose
    logits agree too."""
    jcls, pcls, name, layout = _PRETRAINED[family]
    paddle.seed(0)
    jm = jcls(_resolve(family)(name, **_width(family)))
    jm.eval()
    path = str(tmp_path / f"{name}.pdparams")
    paddle.save(jm.state_dict(), path)
    kw = dict(device="cpu", generator=seed(0, device="cpu"),
              **_width(family))
    pm = pcls.from_pretrained(name, pretrained_path=path, **kw).eval()
    same = pcls.from_pretrained(path, config_name=name, **kw)
    want_state = numpy_state(jm)
    for m in (pm, same):
        got = m.state_dict()
        assert list(got) == list(want_state)
        for k, v in want_state.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    ids, _, mask, _ = _padded_batch(seed_=2, vocab=256)
    args = ((ids,) if family in ("gpt", "llama") else (ids, None, None))
    want = jm(*[None if a is None else paddle.to_tensor(a) for a in args],
              attention_mask=paddle.to_tensor(mask))
    want = want[0] if isinstance(want, tuple) else want
    models = [pm]
    if layout:
        models.append(pcls.from_pretrained(name, pretrained_path=path,
                                           **kw, **layout).eval())
    for m in models:
        with torch.no_grad():
            got = m(*[None if a is None else torch.from_numpy(a)
                      for a in args], attention_mask=torch.from_numpy(mask))
        got = got[0] if isinstance(got, tuple) else got
        ok = ~np.isnan(np.asarray(want._value))
        assert np.array_equal(np.isnan(got.numpy()), ~ok)
        np.testing.assert_allclose(got.numpy()[ok],
                                   np.asarray(want._value)[ok], atol=1e-5,
                                   rtol=0)


def _resolve(family):
    return {"bert": jax_bert, "ernie": jax_ernie, "gpt": jax_gpt,
            "llama": jax_llama}[family]._resolve_config


def _width(family):
    """The test's width: hidden 64 over 4 heads for every family (the
    tiny GPT and Llama configs are that already)."""
    return _OVR if family in ("bert", "ernie") else {}


def test_from_pretrained_refusals(tmp_path):
    """The reference's refusals: a path together with pretrained_path=, a
    path without config_name=, a checkpoint missing a parameter (nothing
    is loaded), an unknown config name."""
    paddle.seed(0)
    jm = jax_ernie.ErnieModel(jax_ernie._resolve_config("ernie-tiny", **_OVR))
    state = jm.state_dict()
    path = str(tmp_path / "ernie.pdparams")
    paddle.save(state, path)
    kw = dict(device="cpu", **_OVR)
    cls = port_ernie.ErnieForSequenceClassification
    with pytest.raises(ValueError, match="exactly one weights source"):
        cls.from_pretrained(path, pretrained_path=path, **kw)
    with pytest.raises(ValueError, match="config_name"):
        cls.from_pretrained(path, **kw)
    # a backbone's checkpoint lacks the head's classifier
    with pytest.raises(ValueError, match="missing parameters"):
        cls.from_pretrained("ernie-tiny", pretrained_path=path, **kw)
    short = str(tmp_path / "short.pdparams")
    paddle.save({k: v for k, v in list(state.items())[1:]}, short)
    with pytest.raises(ValueError, match="missing parameters"):
        port_ernie.ErnieModel.from_pretrained("ernie-tiny",
                                              pretrained_path=short, **kw)
    with pytest.raises(KeyError):
        port_ernie.ErnieModel.from_pretrained("ernie-0.0", pretrained_path=path)
