"""Four faults of the PyTorch port against the reference, each repaired
and held here (ROADMAP.md §3):

1. ``nlp.convert.load_numpy_state`` carries a bf16 reference state (numpy's
   ``ml_dtypes.bfloat16``) bit for bit; a bf16 llama-tiny state here, a
   bf16 ResNet-50 state in test_torch_resnet.py.
2. ``GPTConfig`` has the reference's fields ``use_flash_attention`` (False
   raises: no plain attention path on the card) and
   ``num_virtual_pipeline_stages`` (> 1 raises naming item 10), so a
   reference config's fields construct it.
3. ``ServingEngine`` and ``submit`` take every keyword of the reference's;
   a value other than the reference's default raises NotImplementedError
   naming item 7, as do the engine methods not ported.
4. The optimizer's and the Engine's NotImplementedErrors name their queue
   1 items (1.1, 1.3, 1.8, 10).
5. ``nn.functional.scaled_dot_product_attention``'s two refusals of a
   dense ``attn_mask`` (on the card; with attention dropout) name item 1.7.
6. The transformer layers draw their dropout from their ``generator``:
   a ``Transformer(..., generator=g)`` trains with dropout 0.1, every
   deep-copied layer shares ``g``, a step repeats bit for bit from the
   same seed, and different layers draw different masks.
"""
import dataclasses
import inspect

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp import llama as jax_llama
from paddle_tpu.nlp.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.nlp.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch import seed
from paddle_tpu_torch.hapi import Engine
from paddle_tpu_torch.nlp import llama as port_llama
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.nlp.gpt import GPTConfig, GPTForCausalLM, \
    _resolve_config
from paddle_tpu_torch.nlp.modeling_utils import coerce_config
from paddle_tpu_torch.nlp.serving import ServingEngine
from paddle_tpu_torch.nn import Dropout, Transformer
from paddle_tpu_torch.optimizer import AdamW
from torch_threads import one_torch_thread  # noqa: F401


def test_bf16_reference_state_loads_bit_for_bit():
    paddle.seed(0)
    jm = jax_llama.LlamaForCausalLM.from_config_name("llama-tiny")
    jm.to(dtype="bfloat16")
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    assert {a.dtype.name for a in state.values()} == {"bfloat16"}
    pm = port_llama.LlamaForCausalLM.from_config_name(
        "llama-tiny", device="cpu", dtype="bfloat16")
    load_numpy_state(pm, state)
    for k, v in pm.state_dict().items():
        assert v.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(v.view(torch.int16).numpy(),
                                      state[k].view(np.int16), err_msg=k)


def test_bf16_state_into_an_f32_model_widens_exactly():
    a = np.asarray(jnp.asarray([1.0, -2.5, 3.140625, 1e-3], jnp.bfloat16))
    lin = torch.nn.Linear(4, 1, bias=False)
    load_numpy_state(lin, {"weight": a.reshape(1, 4)})
    np.testing.assert_array_equal(lin.weight.detach().numpy()[0],
                                  a.astype(np.float32))


def test_gpt_config_takes_the_reference_fields():
    ref = dataclasses.asdict(JaxGPTConfig())
    cfg = coerce_config(GPTConfig, ref, {})
    assert cfg.use_flash_attention is True
    assert cfg.num_virtual_pipeline_stages == 1
    assert set(ref) == {f.name for f in dataclasses.fields(GPTConfig)}
    with pytest.raises(NotImplementedError, match="no fallback"):
        GPTConfig(use_flash_attention=False)
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        GPTConfig(num_virtual_pipeline_stages=2)


def _engine(**kw):
    cfg = _resolve_config("gpt-tiny")
    model = GPTForCausalLM(cfg, device="cpu")
    return ServingEngine(model, device="cpu", max_seq_len=64, **kw)


_NON_DEFAULT = dict(
    donate=False, admission_policy="reject", watchdog_timeout=5.0,
    dispatch_retries=0, registry=object(), tenant_capacity=8,
    prefix_cache=True, min_prefix_pages=2, prefix_max_entries=16,
    spec_decode=True, spec_k=4, spec_draft="ngram", profile=True,
    profile_hz=7, mem_ledger=True, mem_admission="hard",
    mem_capacity_bytes=1 << 30)


def test_serving_engine_takes_the_reference_keywords():
    for fn in ("__init__", "submit"):
        ref = set(inspect.signature(getattr(JaxServingEngine, fn)).parameters)
        own = set(inspect.signature(getattr(ServingEngine, fn)).parameters)
        assert ref <= own, (fn, ref - own)
    ref_defaults = {n: p.default for n, p in inspect.signature(
        JaxServingEngine.__init__).parameters.items() if n in _NON_DEFAULT}
    eng = _engine(use_flash=True, **ref_defaults)
    rid = eng.submit([1, 2, 3], 2, deadline_ms=None, priority=0, trace=None,
                     tenant=None)
    eng.run_to_completion()
    assert rid == 0


@pytest.mark.parametrize("name", sorted(_NON_DEFAULT))
def test_serving_engine_refuses_what_is_not_ported(name):
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        _engine(**{name: _NON_DEFAULT[name]})


def test_serving_engine_submit_and_methods_not_ported_raise():
    with pytest.raises(NotImplementedError, match="no fallback"):
        _engine(use_flash=False)
    eng = _engine()
    for kw in (dict(deadline_ms=100), dict(priority=1), dict(trace={}),
               dict(tenant="acme")):
        with pytest.raises(NotImplementedError, match="queue 1 item 7"):
            eng.submit([1, 2], 2, **kw)
    for call in (lambda: eng.cancel(0), eng.drain, eng.resume, eng.health,
                 lambda: eng.warmup(buckets=(8,)), eng.close):
        with pytest.raises(NotImplementedError, match="queue 1 item 7"):
            call()


def test_optimizer_and_engine_name_their_items():
    p = torch.nn.Parameter(torch.zeros(4))
    # item 1.1 (bf16 moments, master weights) is ported
    AdamW(1e-3, parameters=[p], multi_precision=True)
    AdamW(1e-3, parameters=[p], moment_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="queue 1 item 1.8"):
        AdamW(1e-3, parameters=[{"params": [p]}])
    net = torch.nn.Linear(2, 2)
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        Engine(net, mesh=object())
    # item 1.3 (TrainGuard) is ported: an Engine takes a guard
    from paddle_tpu_torch.resilience import TrainGuard
    guard = TrainGuard()
    assert Engine(net, guard=guard).guard is guard


def test_dense_mask_refusals_name_their_item():
    """Item 1.7 landed: attention dropout with a dense mask runs on the
    CPU (the kernels' hash, drawn from the generator: the same seed
    repeats, a masked key gets no weight); a dense mask with kv_lens
    raises, on the CPU and before any kernel on another device (the meta
    device stands in for the card)."""
    from paddle_tpu_torch.nn import functional as F
    q = torch.ones(1, 4, 2, 8)
    mask = torch.ones(1, 1, 4, 4, dtype=torch.bool)
    mask[..., 3] = False
    v = torch.randn(1, 4, 2, 8, generator=torch.Generator().manual_seed(0))
    outs = [F.scaled_dot_product_attention(
        q, q, v, attn_mask=mask, dropout_p=0.1, training=True,
        generator=seed(5, device="cpu")) for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    nokey = v.clone()
    nokey[:, 3] = 1e4  # the masked key's value never reaches the output
    again = F.scaled_dot_product_attention(
        q, q, nokey, attn_mask=mask, dropout_p=0.1, training=True,
        generator=seed(5, device="cpu"))
    assert torch.equal(again, outs[0])
    lens = torch.tensor([3])
    with pytest.raises(ValueError, match="kv_lens"):
        F.scaled_dot_product_attention(q, q, q, attn_mask=mask,
                                       kv_lens=lens)
    qm = q.to("meta")
    with pytest.raises(ValueError, match="kv_lens"):
        F.scaled_dot_product_attention(qm, qm, qm, attn_mask=mask.to("meta"),
                                       kv_lens=lens)


def _transformer_step(seed_value):
    """One Engine step of a 2 + 2-layer Transformer with dropout 0.1 on the
    CPU, its weights and dropout both from ``seed(seed_value)``: (loss, the
    hidden dropouts' masks in call order, the state after the step)."""
    g = seed(seed_value, device="cpu")
    m = Transformer(32, 2, 2, 2, 64, dropout=0.1, device="cpu",
                    generator=g)
    drawers = [mod for mod in m.modules() if hasattr(mod, "generator")]
    # an encoder layer: its attention and 3 Dropouts; a decoder layer: 2
    # attentions and 4 Dropouts
    assert len(drawers) == 2 * 4 + 2 * 6
    assert all(mod.generator is g for mod in drawers)
    masks = []
    for mod in m.modules():
        if isinstance(mod, Dropout):
            mod.register_forward_hook(
                lambda mod, inp, out: masks.append(out == 0))
    rng = np.random.default_rng(0)
    src, tgt, y = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((2, 6, 32), (2, 5, 32), (2, 5, 32)))
    eng = Engine(m, lambda out, want: ((out - want) ** 2).mean(),
                 AdamW(1e-3, parameters=m.named_parameters()))
    loss, _ = eng.train_batch([src, tgt], [y])
    return loss, masks, {k: v.clone() for k, v in m.state_dict().items()}


def test_transformer_dropout_draws_from_its_generator():
    loss, masks, state = _transformer_step(7)
    assert torch.isfinite(loss)
    # encoder: dropout1, dropout, dropout2 a layer; decoder: dropout1,
    # dropout2, dropout, dropout3
    assert len(masks) == 2 * 3 + 2 * 4
    # every Dropout dropped something (after the feed-forward's ReLU the
    # zeros are its own too)
    assert all(mk.any() for mk in masks)
    assert 0.05 < masks[0].float().mean() < 0.15
    assert not torch.equal(masks[0], masks[3])    # encoder 0 vs 1
    assert not torch.equal(masks[6], masks[10])   # decoder 0 vs 1
    loss2, masks2, state2 = _transformer_step(7)
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(masks, masks2))
    assert all(torch.equal(v, state2[k]) for k, v in state.items())
    loss3, masks3, _ = _transformer_step(8)
    assert not torch.equal(masks[0], masks3[0])
