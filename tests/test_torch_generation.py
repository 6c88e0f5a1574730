"""generate() of the PyTorch port vs the JAX package, with GPT.

A 2-layer GPT (hidden 64, 4 heads, head_dim 16 — gpt-tiny with weights
drawn at std 0.5 so greedy streams vary) is built and seeded in the JAX
package; its ``state_dict`` crosses into the port through numpy. Checked:

- the static-cache prefill and one decode step (logits and the written
  buffers) within 1e-5 of the reference's ``_cache_fwd``, of max(1, |the
  reference's largest value|): at gpt-tiny's own init (std 0.02) that is
  1e-5 absolute; at std 0.5 the logits reach ~10 and f32 round-off grows
  with them;
- greedy tokens exact against both the reference's eager
  ``GPTForCausalLM.generate`` and ``nlp.generation.generate``, and exact
  for eos with pad-filled tails, repetition penalty and beam search
  (num_beams 1, 3 and 4, with and without eos, length_penalty);
- a bf16 cache's greedy tokens, exact against the reference with its
  decode through the Pallas ``flash_decode`` kernel in interpret mode.
  The reference's CPU decode path (``reference_attention``) takes a bf16
  cache's scores in bf16, its TPU kernel in f32; the port's kernel and
  twin follow the TPU kernel;
- sampling by its own properties (the streams of two packages cannot
  match): a seeded run repeats, top_k=1 is greedy, every token lies in
  the top-k set or the nucleus of the port's own logits;
- the reference's argument errors, and that every decode step reaches
  ``ops.attention.flash_decode``.
"""
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as paddle
import paddle_tpu.ops.attention as jax_attn
from paddle_tpu.nlp import generation as jax_gen
from paddle_tpu.nlp.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nlp.gpt import _resolve_config as jax_config
from paddle_tpu_torch.nlp import generation as port_gen
from paddle_tpu_torch.nlp import modeling_utils
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.nlp.gpt import GPTForCausalLM
from paddle_tpu_torch.nlp.gpt import _resolve_config as port_config
from torch_threads import one_torch_thread  # noqa: F401

# the package exports a function named like the kernel module
jax_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

_S0, _NEW = 12, 10


@pytest.fixture(scope="module")
def ids():
    return np.random.default_rng(0).integers(0, 256, (3, _S0)).astype(
        np.int32)


def _jax(jm, ids, **kw):
    return np.asarray(jax_gen.generate(jm, paddle.to_tensor(ids),
                                       max_new_tokens=_NEW, **kw)._value)


def _port(pm, ids, **kw):
    out = pm.generate(torch.from_numpy(ids), max_new_tokens=_NEW, **kw)
    assert out.shape == (ids.shape[0], _S0 + _NEW)
    assert out.dtype == torch.int32
    return out.numpy()


@pytest.fixture(scope="module")
def greedy(models, ids):
    return _port(models[1], ids)


def _pair(std):
    paddle.seed(0)
    jm = JaxGPT(jax_config("gpt-tiny", initializer_range=std))
    jm.eval()
    pm = GPTForCausalLM(port_config("gpt-tiny", initializer_range=std),
                        device="cpu")
    load_numpy_state(pm, {k: np.asarray(v._value)
                          for k, v in jm.state_dict().items()})
    return jm, pm.eval()


@pytest.fixture(scope="module")
def models():
    return _pair(0.5)


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize("std", [0.02, 0.5])
def test_static_cache_prefill_and_step_logits(models, ids, std):
    jm, pm = models if std == 0.5 else _pair(std)
    cfg = jm.config
    params, buffers = jm.raw_state()
    s_max = _S0 + 4
    jc = jax_gen._alloc_cache(cfg, 3, s_max, jnp.float32)
    jl, jc = jax_gen._cache_fwd(jm, params, buffers, jnp.asarray(ids), jc, 0)
    pc = port_gen._alloc_cache(pm.config, 3, s_max, torch.float32, "cpu")
    with torch.no_grad():
        pl, pc = pm(torch.from_numpy(ids), cache=pc, cache_index=0)
    _close(pl.numpy(), jl)
    tok = ids[:, -1:]
    jl, jc = jax_gen._cache_fwd(jm, params, buffers, jnp.asarray(tok), jc,
                                _S0)
    with torch.no_grad():
        pl, pc = pm(torch.from_numpy(tok), cache=pc, cache_index=_S0)
    _close(pl.numpy(), jl)
    for (jk, jv), (pk, pv) in zip(jc, pc):
        _close(pk.numpy(), jk)
        _close(pv.numpy(), jv)


def test_greedy_matches_jax_eager_and_jit(models, ids, greedy):
    jm, _ = models
    # the eager loop compiles anew at every step: 5 tokens of it
    eager = np.asarray(jm.generate(paddle.to_tensor(ids),
                                   max_new_tokens=5)._value)
    np.testing.assert_array_equal(greedy[:, :_S0 + 5], eager)
    np.testing.assert_array_equal(greedy, _jax(jm, ids))
    # not a degenerate stream: the rows differ and vary along the decode
    assert len({tuple(r) for r in greedy[:, _S0:]}) == 3
    assert all(len(set(r)) > 3 for r in greedy[:, _S0:])


def test_eos_pads_the_tail(models, ids, greedy):
    jm, pm = models
    eos = int(greedy[0, _S0 + 3])   # row 0 emits it mid-stream
    kw = dict(eos_token_id=eos, pad_token_id=7)
    got = _port(pm, ids, **kw)
    np.testing.assert_array_equal(got, _jax(jm, ids, **kw))
    tail = got[0, _S0:]
    first = int(np.argmax(tail == eos))
    assert first <= 3 and (tail[first + 1:] == 7).all()


@pytest.mark.parametrize("penalty", [1.3, 0.8])
def test_repetition_penalty_greedy(models, ids, penalty):
    jm, pm = models
    kw = dict(repetition_penalty=penalty, pad_token_id=int(ids[0, 0]))
    np.testing.assert_array_equal(_port(pm, ids, **kw), _jax(jm, ids, **kw))


@pytest.mark.parametrize("beams,use_eos,lp", [
    (1, False, 1.0), (3, False, 1.0), (4, False, 1.5), (3, True, 1.0),
    (4, True, 0.7)])
def test_beam_search_matches_jax(models, ids, greedy, beams, use_eos, lp):
    jm, pm = models
    kw = dict(num_beams=beams, length_penalty=lp)
    if use_eos:
        kw.update(eos_token_id=int(greedy[1, _S0 + 2]), pad_token_id=3)
    got = _port(pm, ids, **kw)
    np.testing.assert_array_equal(got, _jax(jm, ids, **kw))
    if beams == 1:
        np.testing.assert_array_equal(got, greedy)


def test_beam_search_with_penalty_and_temperature(models, ids):
    jm, pm = models
    kw = dict(num_beams=3, repetition_penalty=1.2, temperature=0.7)
    np.testing.assert_array_equal(_port(pm, ids, **kw), _jax(jm, ids, **kw))


def test_bf16_cache_greedy_matches_pallas_decode(models, ids, monkeypatch):
    """The reference's decode step through its TPU kernel (interpret mode),
    as it runs on the TPU: f32 scores over the bf16 cache."""
    jm, pm = models
    calls = []

    def pallas_decode(q, k, v, kv_lens, sm_scale=None):
        calls.append(q.dtype)
        return jax_fa.flash_decode(q, k, v, kv_lens, sm_scale=sm_scale,
                                   interpret=True)

    monkeypatch.setattr(jax_attn, "flash_decode", pallas_decode)
    kw = dict(cache_dtype="bfloat16", decode_strategy="greedy_search")
    want = _jax(jm, ids, **kw)
    assert calls and calls[-1] == jnp.bfloat16
    np.testing.assert_array_equal(_port(pm, ids, **kw), want)


def test_sampling_seeded_repeats_and_differs(models, ids, greedy):
    _, pm = models
    kw = dict(decode_strategy="sampling", temperature=1.5, top_k=20)
    a = _port(pm, ids, seed=3, **kw)
    np.testing.assert_array_equal(a, _port(pm, ids, seed=3, **kw))
    others = [_port(pm, ids, seed=s, **kw) for s in (4, 5)]
    assert any(not np.array_equal(a, o) for o in others)
    assert not np.array_equal(a, greedy)
    np.testing.assert_array_equal(
        _port(pm, ids, top_k=1, seed=9, temperature=0.7), greedy)


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.6), (8, 0.7)])
def test_sampled_tokens_lie_in_the_filtered_set(models, ids, top_k, top_p):
    """Each sampled token is in the top-k set and/or the nucleus of the
    port's own logits at that step (teacher-forced over the stream)."""
    _, pm = models
    temp = 0.8
    out = _port(pm, ids, top_k=top_k, top_p=top_p, temperature=temp, seed=1)
    with torch.no_grad():
        logits = pm(torch.from_numpy(out)).float() / temp
    for t in range(_NEW):
        last = logits[:, _S0 + t - 1]
        allowed = torch.ones_like(last, dtype=torch.bool)
        if top_k:
            kth = torch.topk(last, top_k, dim=-1).values[:, -1:]
            allowed &= last >= kth
            if top_p < 1.0:
                vals = torch.where(allowed, last,
                                   torch.full_like(last, -float("inf")))
                allowed &= port_gen._mask_top_p(vals, top_p) > -float("inf")
        elif top_p < 1.0:
            allowed &= port_gen._mask_top_p(last, top_p) > -float("inf")
        tok = torch.from_numpy(out[:, _S0 + t]).long()
        assert allowed.gather(1, tok[:, None]).all(), t


def test_mask_top_p_matches_jax():
    x = np.random.default_rng(2).standard_normal((4, 50)).astype(np.float32)
    for p in (0.1, 0.5, 0.9):
        want = np.asarray(jax_gen._mask_top_p(jnp.asarray(x), p))
        got = port_gen._mask_top_p(torch.from_numpy(x), p).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_array_equal(got[~np.isinf(got)],
                                      want[~np.isinf(want)])


def test_argument_errors(models, ids):
    _, pm = models
    x = torch.from_numpy(ids)
    with pytest.raises(ValueError, match="decode_strategy"):
        pm.generate(x, decode_strategy="contrastive")
    for kw in (dict(top_k=5), dict(top_p=0.9)):
        with pytest.raises(ValueError, match="beam_search"):
            pm.generate(x, num_beams=3, **kw)
    with pytest.raises(ValueError, match="beam_search"):
        port_gen.generate(pm, x, decode_strategy="beam_search", top_k=2)


def test_every_decode_step_reaches_flash_decode(models, ids, monkeypatch):
    """Each of the max_new_tokens steps runs one single-token forward, and
    each layer's attention in it goes through ops.attention.flash_decode
    (the kernel on the card), with the cache dtype; the prefill does
    not."""
    _, pm = models
    seen = []
    real = modeling_utils.flash_decode

    def spy(q, k_cache, v_cache, kv_lens, sm_scale=None):
        seen.append((q.shape[1], q.dtype, k_cache.dtype, int(kv_lens[0])))
        return real(q, k_cache, v_cache, kv_lens, sm_scale)

    monkeypatch.setattr(modeling_utils, "flash_decode", spy)
    _port(pm, ids, cache_dtype="bfloat16")
    layers = pm.config.num_hidden_layers
    assert len(seen) == layers * _NEW
    assert {s[:3] for s in seen} == {(1, torch.bfloat16, torch.bfloat16)}
    assert [s[3] for s in seen[::layers]] == list(range(_S0 + 1,
                                                        _S0 + _NEW + 1))


def test_cached_dense_decode_and_bad_index_raise(models, ids):
    _, pm = models
    x = torch.from_numpy(ids)
    cache = port_gen._alloc_cache(pm.config, 3, _S0, torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue 1 "
                       "item 2.1"):
        pm(x, cache=cache)
    with pytest.raises(ValueError, match="without cache"):
        pm(x, cache_index=0)
    with pytest.raises(ValueError, match="one cache_index"):
        pm(x, cache=cache, cache_index=torch.zeros(3, dtype=torch.int32))


def test_generate_restores_train_mode_and_clear_cache(models, ids):
    _, pm = models
    pm.train()
    try:
        _port(pm, ids)
        assert pm.training
    finally:
        pm.eval()
    assert port_gen.clear_decode_cache(pm) is None
