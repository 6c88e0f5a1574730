"""Llama of the PyTorch port vs the JAX package.

Two 2-layer models at llama-tiny's widths (hidden 64, 4 heads, head_dim
16, SwiGLU 128): the config's GQA 4:2 and an MHA variant
(num_key_value_heads=4), built and seeded in the JAX package with weights
drawn at std 0.5 so greedy streams vary; the ``state_dict`` crosses into
the port through numpy (``load_numpy_state``, strictly). Checked:
``apply_rope`` (positions [S] and [B, S]), ``rms_norm``/``RMSNorm``, the
no-cache forward and the static-cache prefill/step logits within 1e-5 of
max(1, |the reference's largest value|) in f32; greedy ``generate``
token-exact for both variants (and a bf16 cache for MHA, against the
reference's decode through the Pallas kernel in interpret mode); the MHA
decode reaching ``ops.attention.flash_decode`` at every step and the GQA
decode never (a spy on the CPU path); the options not ported raise.
"""
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as jax_F
import paddle_tpu.ops.attention as jax_attn
from paddle_tpu.nlp import generation as jax_gen
from paddle_tpu.nlp import llama as jax_llama
from paddle_tpu_torch.nlp import generation as port_gen
from paddle_tpu_torch.nlp import llama as port_llama
from paddle_tpu_torch.nlp import modeling_utils
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.nlp.paged_cache import PagedLayerCache
from paddle_tpu_torch.nn import RMSNorm
from paddle_tpu_torch.nn import functional as port_F
from torch_threads import one_torch_thread  # noqa: F401

jax_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

_S0, _NEW = 10, 8
VARIANTS = {"gqa": {}, "mha": dict(num_key_value_heads=4)}


def _close(got, want, tol=1e-5):
    want = np.asarray(want, dtype=np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), want,
                               atol=tol * scale, rtol=0)


def _numpy_state(jm):
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def models(request):
    ovr = dict(VARIANTS[request.param], initializer_range=0.5)
    paddle.seed(0)
    jm = jax_llama.LlamaForCausalLM.from_config_name("llama-tiny", **ovr)
    jm.eval()
    pm = port_llama.LlamaForCausalLM.from_config_name("llama-tiny",
                                                      device="cpu", **ovr)
    load_numpy_state(pm, _numpy_state(jm))
    return request.param, jm, pm.eval()


@pytest.fixture(scope="module")
def ids():
    return np.random.default_rng(1).integers(0, 256, (3, _S0)).astype(
        np.int32)


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos_s = np.arange(5, 12, dtype=np.int32)
    pos_bs = rng.integers(0, 100, (2, 7)).astype(np.int32)
    for pos in (pos_s, pos_bs):
        for theta in (10000.0, 500000.0):
            want = jax_llama.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                        theta)
            got = port_llama.apply_rope(torch.from_numpy(x),
                                        torch.from_numpy(pos), theta)
            _close(got.numpy(), want)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-2)])
def test_rms_norm_matches_jax(dtype, tol):
    rng = np.random.default_rng(3)
    x = (3 * rng.standard_normal((4, 5, 32))).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    want = jax_F.rms_norm(paddle.to_tensor(x).astype(dtype),
                          paddle.to_tensor(w).astype(dtype), epsilon=1e-6)
    got = port_F.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                          torch.from_numpy(w).to(getattr(torch, dtype)),
                          epsilon=1e-6)
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), np.asarray(want._value.astype(jnp.float32)),
           tol)
    layer = RMSNorm(32, epsilon=1e-5, device="cpu")
    assert layer._epsilon == 1e-5 and bool((layer.weight == 1).all())
    _close(layer(torch.from_numpy(x)).detach().numpy(),
           np.asarray(jax_F.rms_norm(paddle.to_tensor(x), None,
                                     epsilon=1e-5)._value))


def test_state_dict_keys_and_strict_load(models):
    _, jm, pm = models
    state = _numpy_state(jm)
    assert list(state) == list(pm.state_dict())
    layers = pm.config.num_hidden_layers
    assert {"llama.embed_tokens.weight", "llama.norm.weight",
            "lm_head.weight"} <= set(state)
    for n in range(layers):
        for leaf in ("self_attn.q_proj", "self_attn.k_proj",
                     "self_attn.v_proj", "self_attn.o_proj", "mlp.gate_proj",
                     "mlp.up_proj", "mlp.down_proj", "input_layernorm",
                     "post_attention_layernorm"):
            assert f"llama.layers.{n}.{leaf}.weight" in state
    fresh = port_llama.LlamaForCausalLM(pm.config, device="cpu")
    with pytest.raises(KeyError, match="missing"):
        load_numpy_state(fresh, {k: v for k, v in state.items()
                                 if k != "lm_head.weight"})
    with pytest.raises(KeyError, match="unexpected"):
        load_numpy_state(fresh, dict(state, extra=np.zeros(2)))
    bad = dict(state)
    bad["llama.norm.weight"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_numpy_state(fresh, bad)


def test_forward_logits_match_jax(models, ids):
    _, jm, pm = models
    want = jm(paddle.to_tensor(ids))._value
    with torch.no_grad():
        got = pm(torch.from_numpy(ids)).numpy()
    _close(got, want)


def test_static_cache_prefill_and_step_match_jax(models, ids):
    _, jm, pm = models
    params, buffers = jm.raw_state()
    s_max = _S0 + 2
    jc = jax_gen._alloc_cache(jm.config, 3, s_max, jnp.float32)
    pc = port_gen._alloc_cache(pm.config, 3, s_max, torch.float32, "cpu")
    assert pc[0][0].shape == jc[0][0].shape
    for tok, idx in ((ids, 0), (ids[:, :1], _S0)):
        jl, jc = jax_gen._cache_fwd(jm, params, buffers, jnp.asarray(tok),
                                    jc, idx)
        with torch.no_grad():
            pl, pc = pm(torch.from_numpy(tok), cache=pc, cache_index=idx)
        _close(pl.numpy(), jl)
    for (jk, jv), (pk, pv) in zip(jc, pc):
        _close(pk.numpy(), jk)
        _close(pv.numpy(), jv)


def _spy(monkeypatch):
    seen = []
    real = modeling_utils.flash_decode

    def spy(q, k_cache, v_cache, kv_lens, sm_scale=None):
        seen.append(q.dtype)
        return real(q, k_cache, v_cache, kv_lens, sm_scale)

    monkeypatch.setattr(modeling_utils, "flash_decode", spy)
    return seen


def test_greedy_generate_matches_jax(models, ids, monkeypatch):
    name, jm, pm = models
    seen = _spy(monkeypatch)
    want = np.asarray(jm.generate(paddle.to_tensor(ids),
                                  max_new_tokens=_NEW)._value)
    got = pm.generate(torch.from_numpy(ids), max_new_tokens=_NEW).numpy()
    np.testing.assert_array_equal(got, want)
    assert all(len(set(r)) > 2 for r in got[:, _S0:])
    # MHA decodes through ops.attention.flash_decode (the dense decode
    # kernel on the card) in every layer of every step; GQA never does
    layers = pm.config.num_hidden_layers
    assert len(seen) == (layers * _NEW if name == "mha" else 0)


@pytest.mark.parametrize("models", ["mha"], indirect=True)
def test_mha_bf16_cache_matches_pallas_decode(models, ids, monkeypatch):
    _, jm, pm = models

    def pallas_decode(q, k, v, kv_lens, sm_scale=None):
        return jax_fa.flash_decode(q, k, v, kv_lens, sm_scale=sm_scale,
                                   interpret=True)

    monkeypatch.setattr(jax_attn, "flash_decode", pallas_decode)
    seen = _spy(monkeypatch)
    kw = dict(max_new_tokens=_NEW, cache_dtype="bfloat16")
    want = np.asarray(jm.generate(paddle.to_tensor(ids), **kw)._value)
    got = pm.generate(torch.from_numpy(ids), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert seen and set(seen) == {torch.bfloat16}


def test_beam_and_eos_match_jax(models, ids):
    _, jm, pm = models
    greedy = pm.generate(torch.from_numpy(ids), max_new_tokens=_NEW).numpy()
    for kw in (dict(num_beams=3),
               dict(eos_token_id=int(greedy[0, _S0 + 2]), pad_token_id=1),
               dict(repetition_penalty=1.3)):
        want = np.asarray(jm.generate(paddle.to_tensor(ids),
                                      max_new_tokens=_NEW, **kw)._value)
        got = pm.generate(torch.from_numpy(ids), max_new_tokens=_NEW,
                          **kw).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flag", [
    dict(scan_layers=True), dict(recompute=True), dict(chunked_ce=64),
    dict(sequence_parallel="ring"), dict(use_flash_attention=False)])
def test_unported_options_raise(flag):
    """sequence_parallel and use_flash_attention=False still raise; the
    training options of item 1.2 are ported
    (tests/test_torch_llama_train.py) and construct."""
    if "scan_layers" in flag or "recompute" in flag or "chunked_ce" in flag:
        cfg = port_llama.LlamaConfig(**flag)
        (key, value), = flag.items()
        assert getattr(cfg, key) == value
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_llama.LlamaConfig(**flag)


def test_unported_paths_raise(ids):
    pm = port_llama.LlamaForCausalLM.from_config_name("llama-tiny",
                                                      device="cpu")
    x = torch.from_numpy(ids)
    paged = PagedLayerCache(None, None, None, None)
    scanned = port_llama.LlamaForCausalLM.from_config_name(
        "llama-tiny", device="cpu", scan_layers=True)
    with pytest.raises(NotImplementedError, match="scan_layers"):
        scanned(x, cache=[paged] * 2,
                cache_index=torch.zeros(3, dtype=torch.int32))
    cache = port_gen._alloc_cache(pm.config, 3, _S0, torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 2.1"):
        pm(x, cache=cache)
    with pytest.raises(ValueError, match="without cache"):
        pm(x, cache_index=0)
    # a bare name needs a download: the reference's recipe (item 4.4)
    with pytest.raises(NotImplementedError, match="needs a weights download"):
        port_llama.LlamaForCausalLM.from_pretrained("llama-tiny")


def test_tied_head_and_use_cache(ids):
    """tie_word_embeddings=True has no lm_head and reads the embedding;
    use_cache=True returns each layer's (k, v) as the static prefill
    writes them."""
    pm = port_llama.LlamaForCausalLM.from_config_name(
        "llama-tiny", device="cpu", tie_word_embeddings=True)
    assert "lm_head.weight" not in pm.state_dict()
    x = torch.from_numpy(ids)
    with torch.no_grad():
        logits, kv = pm(x, use_cache=True)
        cache = port_gen._alloc_cache(pm.config, 3, _S0, torch.float32,
                                      "cpu")
        sl, cache = pm(x, cache=cache, cache_index=0)
    torch.testing.assert_close(sl, logits, atol=1e-5, rtol=0)
    for (k, v), (kb, vb) in zip(kv, cache):
        torch.testing.assert_close(kb, k, atol=1e-6, rtol=0)
        torch.testing.assert_close(vb, v, atol=1e-6, rtol=0)
