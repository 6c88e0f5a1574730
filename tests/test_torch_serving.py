"""ServingEngine of the PyTorch port vs the JAX package's engine.

The same GPT weights (2 layers, hidden 64, 1 head of 64) serve the same
prompts in both packages. With an f32 cache greedy tokens must be exact
against the JAX engine, run with the Pallas paged kernel in interpret
mode (use_flash=True) and with its jnp reference (use_flash=False);
bf16 and int8 caches must agree on >= 95% of tokens with the JAX engine
of the same cache dtype. Prompts straddle the 16-token page and the pow2
prefill buckets, there are more requests than slots and too few pages to
host them at once, and the free list must come back whole.
"""
import numpy as np
import pytest

import torch

import paddle_tpu as paddle
from paddle_tpu.nlp.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nlp.gpt import _resolve_config as jax_config
from paddle_tpu.nlp.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.nlp.gpt import GPTForCausalLM
from paddle_tpu_torch.nlp.gpt import _resolve_config as port_config
from paddle_tpu_torch.nlp.serving import ServingEngine, row_uniforms
from torch_threads import one_torch_thread  # noqa: F401

_OVR = dict(num_attention_heads=1)
# lengths straddle the 16-token page and the pow2 buckets
_LENS = (5, 12, 17, 30, 9, 21)
_NEW = 8
_ENGINE = dict(max_slots=2, page_size=16, max_seq_len=48, num_pages=8,
               steps_per_dispatch=4)


def _prompts(lens=_LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,)).astype(np.int32) for n in lens]


@pytest.fixture(scope="module")
def models():
    paddle.seed(1)
    jm = JaxGPT(jax_config("gpt-tiny", **_OVR))
    jm.eval()
    pm = GPTForCausalLM(port_config("gpt-tiny", **_OVR), device="cpu")
    load_numpy_state(pm, {k: np.asarray(v._value)
                          for k, v in jm.state_dict().items()})
    return jm, pm


@pytest.fixture(scope="module")
def jax_tokens(models):
    """{(cache_dtype, use_flash): greedy tokens} from the JAX engine —
    one engine per dtype (plus the interpret-mode kernel for f32)."""
    jm, _ = models
    out = {}
    for dt, flash in (("float32", True), ("float32", False),
                      ("bfloat16", False), ("int8", False)):
        eng = JaxEngine(jm, cache_dtype=dt, use_flash=flash,
                        prefix_cache=False, **_ENGINE)
        out[dt, flash] = eng.generate(_prompts(), max_new_tokens=_NEW)
    return out


@pytest.mark.parametrize("use_flash", [True, False])
def test_greedy_f32_token_exact(models, jax_tokens, use_flash):
    _, pm = models
    eng = ServingEngine(pm, device="cpu", **_ENGINE)
    free0 = eng.free_page_count
    assert free0 == eng.num_pages - 1
    assert eng.generate(_prompts(), max_new_tokens=_NEW) == \
        jax_tokens["float32", use_flash]
    assert eng.free_page_count == free0, "page leak across recycle"


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_reduced_precision_cache_agreement(models, jax_tokens, dtype):
    _, pm = models
    eng = ServingEngine(pm, device="cpu", cache_dtype=dtype, **_ENGINE)
    outs = eng.generate(_prompts(), max_new_tokens=_NEW)
    refs = jax_tokens[dtype, False]
    agree = sum(a == b for r, o in zip(refs, outs) for a, b in zip(r, o))
    total = sum(len(r) for r in refs)
    assert agree >= 0.95 * total, (dtype, refs, outs)
    assert eng.free_page_count == eng.num_pages - 1


def test_eos_early_stop(models, jax_tokens):
    _, pm = models
    ref = jax_tokens["float32", False][1]
    eos = ref[3]
    first = ref.index(eos)
    eng = ServingEngine(pm, device="cpu", **_ENGINE)
    out = eng.generate([_prompts()[1]], max_new_tokens=_NEW,
                       eos_token_id=eos)[0]
    assert out == ref[:first + 1], "must stop right after emitting eos"


def test_topk_tokens_in_dense_topk(models):
    """Seeded top-k sampling: every emitted token lies in the top-k of the
    JAX model's dense logits for the same prefix."""
    jm, pm = models
    k = 5
    prompt = _prompts((9,), seed=3)[0]
    eng = ServingEngine(pm, device="cpu", max_slots=1, page_size=16,
                        max_seq_len=48, temperature=0.9, top_k=k, seed=7)
    toks = eng.generate([prompt], max_new_tokens=6)[0]
    # causal LM: row i of one forward over prompt + tokens holds the
    # dense logits for the prefix ending at i
    seq = np.asarray(list(prompt) + toks[:-1], np.int64)[None]
    logits = np.asarray(jm(paddle.to_tensor(seq))._value)[0]
    for j, t in enumerate(toks):
        top = set(np.argsort(logits[len(prompt) - 1 + j])[-k:].tolist())
        assert t in top, (j, t, sorted(top))


def test_sampling_is_row_independent():
    """A row's uniforms depend only on (its key, its index), not on the
    batch it rides in — what keeps token streams independent of
    scheduling."""
    kb = torch.tensor([11, 22, 33], dtype=torch.int64)
    idx = torch.tensor([1, 5, 2], dtype=torch.int32)
    u = row_uniforms(kb, idx, 50)
    assert ((u > 0) & (u < 1)).all()
    torch.testing.assert_close(row_uniforms(kb[1:2], idx[1:2], 50), u[1:2])
    assert not torch.equal(row_uniforms(kb[:1], idx[:1] + 1, 50), u[:1])


def test_submit_rejects_oversized(models):
    _, pm = models
    eng = ServingEngine(pm, device="cpu", max_slots=1, page_size=16,
                        max_seq_len=32)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(np.zeros(30, np.int32), max_new_tokens=10)
