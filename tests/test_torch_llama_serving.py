"""Llama serving of the PyTorch port vs the JAX package.

The reference's serving Llama (``tests/test_serving.py``'s ``llama_model``:
vocab 256, hidden 128, 2 layers, 4 query heads over 2 kv heads, so G = 2
and head_dim 32), built and seeded in the JAX package; its ``state_dict``
crosses into the port through numpy (``load_numpy_state``). Checked:

- (a) ``paged_update_and_attend(rope_theta=...)`` at G = 1, 2 and 4 over
  f32, bf16 and int8 pools against the reference's (its Pallas kernel in
  interpret mode, head_dim 64): outputs within 1e-5 in f32 and int8 and
  1e-2 in bf16; every page row the step did not write equal, the rows it
  wrote within one rounding of the rotation (1e-6 relative in f32, one
  bf16 ulp, one int8 step: the two packages' sin, cos and pow differ in
  the last f32 bit here and there);
- (b) the port's ``ServingEngine`` greedy tokens equal to the reference
  ``ServingEngine``'s and the reference ``generate()``'s (the prompts of
  ``test_llama_gqa_token_exact``), with an f32 cache;
- (c) bf16 and int8 caches agree with the f32 reference on at least 0.75
  of the tokens, the reference's own bar;
- (d) the prefill with ``kv_lens`` (what the port's engine runs) against
  the reference's padded-mask prefill: logits and every layer's post-RoPE
  K and V within 1e-5 of max(1, |the reference's largest value|);
- (e) the model cast to float16 (the reference's ``Layer.to(dtype=
  "float16")``; the port's weights loaded from its float16 state bit for
  bit) served by both engines over an f32 and an int8 cache (the bf16
  pool's float16 q is the kernel tests'): the prefill logits within
  2e-2 of max(1, |ref|) (float16 products in two frameworks' orders, ten
  mantissa bits), the first token of every request equal and at least
  0.75 of the tokens, the bar of (c).

``load_numpy_state`` carries the reference's weights in float32, bfloat16
and float16 bit for bit.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp import paged_cache as jpc
from paddle_tpu.nlp.generation import generate as jax_generate
from paddle_tpu.nlp.llama import LlamaConfig as JaxConfig
from paddle_tpu.nlp.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.nlp.serving import ServingEngine as JaxEngine
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch.nlp import paged_cache as ppc
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.nlp.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nlp.serving import ServingEngine
from torch_threads import one_torch_thread  # noqa: F401

_CFG = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=128, max_position_embeddings=128)
# test_llama_gqa_token_exact's engine and prompts
_ENGINE = dict(max_slots=2, page_size=16, max_seq_len=48,
               steps_per_dispatch=4)
_NEW = 8
_THETA = 10000.0


def _prompts(lens=(6, 20), seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,)).astype(np.int32) for n in lens]


def _numpy_state(jm):
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def _jax_model(dtype=None):
    paddle.seed(0)
    jm = JaxLlama(JaxConfig(**_CFG))
    jm.eval()
    if dtype is not None:
        jm.to(dtype=dtype)
    return jm


def _port_model(jm, dtype=torch.float32):
    pm = LlamaForCausalLM(LlamaConfig(**_CFG), device="cpu", dtype=dtype)
    return load_numpy_state(pm, _numpy_state(jm)).eval()


@pytest.fixture(scope="module")
def models():
    jm = _jax_model()
    return jm, _port_model(jm)


@pytest.fixture(scope="module")
def jax_refs(models):
    """The reference's greedy tokens: generate() a prompt at a time and
    its ServingEngine (f32 cache)."""
    jm, _ = models
    gen = []
    for p in _prompts():
        ids = jax_generate(jm, jnp.asarray(p)[None, :],
                           max_new_tokens=_NEW, temperature=0.0)
        gen.append(np.asarray(ids._value)[0, len(p):].tolist())
    eng = JaxEngine(jm, prefix_cache=False, **_ENGINE)
    return gen, eng.generate(_prompts(), max_new_tokens=_NEW)


def _agreement(outs, refs):
    agree = sum(a == b for r, o in zip(refs, outs) for a, b in zip(r, o))
    return agree / sum(len(r) for r in refs)


def _jax_prefill(jm, ids, mask):
    """The reference's padded-mask prefill (its engine's call) under
    jax.jit, as the engine runs it: logits and each layer's (k, v)."""
    def fwd(ids, mask):
        logits, kv = jm(Tensor(ids), attention_mask=Tensor(mask),
                        use_cache=True)
        return logits._value, [(k._value, v._value) for k, v in kv]
    return jax.jit(fwd)(ids, mask)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=tol * scale, rtol=0)


# -- (a) the RoPE branch of the paged step -----------------------------------

def _pools(dtype, hkv, d, p, ps, rng):
    kp = rng.standard_normal((hkv, p, ps, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, p, ps, d)).astype(np.float32)
    if dtype == "int8":
        kq, ks = jpc.quantize_rows(jnp.asarray(kp))
        vq, vs = jpc.quantize_rows(jnp.asarray(vp))
        return [np.asarray(x) for x in (kq, vq, ks, vs)]
    if dtype == "bfloat16":
        return [np.asarray(jnp.asarray(kp, jnp.bfloat16)),
                np.asarray(jnp.asarray(vp, jnp.bfloat16)), None, None]
    return [kp, vp, None, None]


def _to_torch(x):
    if x is None:
        return None
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))   # a writable copy


@functools.partial(jax.jit, static_argnames="g")
def _jax_step(q, k, v, kp, vp, ks, vs, pt, pos, g):
    cache = jpc.PagedLayerCache(kp, vp, pt, pos, k_scale=ks, v_scale=vs,
                                use_flash=True)
    return jpc.paged_update_and_attend(q, k, v, cache, groups=g,
                                       rope_theta=_THETA)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_paged_step_with_rope_matches_jax(g, dtype):
    rng = np.random.default_rng(10 * g + len(dtype))
    b, hkv, d, ps, p, mp = 3, 2, 64, 16, 9, 3
    pools = _pools(dtype, hkv, d, p, ps, rng)
    q = rng.standard_normal((b, 1, hkv * g, d)).astype(np.float32)
    k = rng.standard_normal((b, 1, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, 1, hkv, d)).astype(np.float32)
    pt = np.array([[1, 2, 3], [4, 5, 0], [6, 7, 8]], np.int32)
    # a first token, one on a page edge, one deep in the third page
    pos = np.array([0, 16, 40], np.int32)
    want, jpages = _jax_step(
        *(None if a is None else jnp.asarray(a)
          for a in (q, k, v, *pools, pt, pos)), g=g)
    tp = [_to_torch(a) for a in pools]
    pcache = ppc.PagedLayerCache(tp[0], tp[1], torch.from_numpy(pt),
                                 torch.from_numpy(pos), k_scale=tp[2],
                                 v_scale=tp[3])
    got = ppc.paged_update_and_attend(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        pcache, groups=g, rope_theta=_THETA)
    assert got.shape == (b, 1, hkv * g, d) and got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want),
           1e-2 if dtype == "bfloat16" else 1e-5)
    # the rows this step wrote: (page, row) of each slot's position
    written = np.zeros((p, ps), bool)
    written[pt[np.arange(b), pos // ps], pos % ps] = True
    # within them, what one f32 rounding of the rotation allows (the two
    # packages' sin, cos and pow differ in the last bit here and there):
    # 1e-6 relative in f32, one bf16 ulp, one int8 step
    step = {"float32": dict(rtol=1e-6, atol=0),
            "bfloat16": dict(rtol=2 ** -8, atol=0),
            "int8": dict(rtol=0, atol=1)}[dtype]
    for name, p_, j_ in zip(("k", "v", "k_scale", "v_scale"), tp, jpages):
        if p_ is None:
            continue
        pv, jv = p_.float().numpy(), np.asarray(j_).astype(np.float32)
        np.testing.assert_array_equal(pv[:, ~written], jv[:, ~written],
                                      err_msg=name)
        tol = step if name in ("k", "v") else dict(rtol=1e-6, atol=0)
        np.testing.assert_allclose(pv[:, written], jv[:, written],
                                   err_msg=name, **tol)


def test_rope_rows_is_the_prefill_formula():
    """The paged branch rotates with llama.rope_tables/rotate: a row at
    position p equals row p of the prefill's rotation."""
    from paddle_tpu_torch.nlp.llama import apply_rope
    x = torch.randn(1, 7, 2, 32, generator=torch.Generator().manual_seed(0))
    full = apply_rope(x, torch.arange(7), _THETA)
    for p_ in (0, 3, 6):
        row = ppc._rope_rows(x[:, p_], torch.tensor([p_], dtype=torch.int32),
                             _THETA)
        torch.testing.assert_close(row, full[:, p_], rtol=0, atol=0)


# -- (b)-(d) the engine -------------------------------------------------------

def test_greedy_f32_token_exact(models, jax_refs):
    _, pm = models
    gen, jax_eng = jax_refs
    assert gen == jax_eng
    eng = ServingEngine(pm, device="cpu", **_ENGINE)
    assert eng.groups == 2 and eng.kv_heads == 2
    free0 = eng.free_page_count
    assert eng.generate(_prompts(), max_new_tokens=_NEW) == gen
    assert eng.free_page_count == free0, "page leak across recycle"


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_reduced_precision_caches_agree(models, jax_refs, dtype):
    _, pm = models
    gen, _ = jax_refs
    eng = ServingEngine(pm, device="cpu", cache_dtype=dtype, **_ENGINE)
    outs = eng.generate(_prompts(), max_new_tokens=_NEW)
    assert _agreement(outs, gen) >= 0.75, (dtype, gen, outs)


def test_prefill_kv_lens_matches_padded_mask(models):
    """The engine's prefill (bucket 32, kv_lens = the prompt length)
    against the reference engine's (a padding mask): logits at every row
    and each layer's dense (post-RoPE K, V)."""
    jm, pm = models
    p = _prompts()[1]
    bucket = 32
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :len(p)] = p
    mask = (np.arange(bucket)[None] < len(p)).astype(np.int32)
    jl, jkv = _jax_prefill(jm, ids, mask)
    with torch.no_grad():
        pl, pkv = pm(torch.from_numpy(ids), use_cache=True,
                     kv_lens=torch.tensor([len(p)], dtype=torch.int32))
    _close(pl.numpy(), jl, 1e-5)
    for (pk, pv), (jk, jv) in zip(pkv, jkv):
        _close(pk.numpy(), jk, 1e-5)
        _close(pv.numpy(), jv, 1e-5)


def test_model_token_step_reads_no_host_position(models, monkeypatch):
    """The paged step takes the positions as the [B] tensor they are:
    static_index (the static cache's host read) is never called."""
    from paddle_tpu_torch.nlp import llama as port_llama
    _, pm = models

    def no_host_read(idx):
        raise AssertionError("the paged step read its positions back")
    monkeypatch.setattr(port_llama, "static_index", no_host_read)
    eng = ServingEngine(pm, device="cpu", **_ENGINE)
    assert len(eng.generate(_prompts()[:1], max_new_tokens=3)[0]) == 3


# -- (e) a float16 model ------------------------------------------------------

@pytest.fixture(scope="module")
def f16_models():
    jm = _jax_model("float16")
    return jm, _port_model(jm, torch.float16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_load_numpy_state_bit_for_bit(dtype):
    jm = _jax_model(None if dtype == "float32" else dtype)
    state = _numpy_state(jm)
    pm = _port_model(jm, getattr(torch, dtype))
    for name, t in pm.state_dict().items():
        arr = state[name]
        assert str(t.dtype) == f"torch.{dtype}", name
        if dtype == "bfloat16":
            got = t.view(torch.int16).numpy()
            want = np.asarray(arr).view(np.int16)
        else:
            got, want = t.numpy(), np.asarray(arr)
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_float16_model_prefill_matches_jax(f16_models):
    jm, pm = f16_models
    p = _prompts()[1]
    ids = np.zeros((1, 32), np.int32)
    ids[0, :len(p)] = p
    mask = (np.arange(32)[None] < len(p)).astype(np.int32)
    jl, _ = _jax_prefill(jm, ids, mask)
    with torch.no_grad():
        pl = pm(torch.from_numpy(ids),
                kv_lens=torch.tensor([len(p)], dtype=torch.int32))
    assert pl.dtype == torch.float16
    _close(pl.float().numpy()[:, :len(p)],
           np.asarray(jl).astype(np.float32)[:, :len(p)], 2e-2)


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_float16_model_served_on_both(f16_models, cache):
    jm, pm = f16_models
    want = JaxEngine(jm, prefix_cache=False, cache_dtype=cache,
                     **_ENGINE).generate(_prompts(), max_new_tokens=_NEW)
    got = ServingEngine(pm, device="cpu", cache_dtype=cache,
                        **_ENGINE).generate(_prompts(), max_new_tokens=_NEW)
    assert [t[0] for t in got] == [t[0] for t in want], (got, want)
    assert _agreement(got, want) >= 0.75, (cache, got, want)
