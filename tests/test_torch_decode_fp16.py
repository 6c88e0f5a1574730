"""The two decode kernels in float16: the port's plain twins vs the JAX
package's Pallas kernels in interpret mode.

- ``paged_decode_plain`` (kernel #5's twin) with float16 q over f32, bf16
  and int8 pools, and with float16 pools, against the reference
  ``paged_flash_decode(..., interpret=True)``;
- ``flash_decode_plain`` (kernel #2's twin) over a float16 cache against
  the reference Pallas ``flash_decode(..., interpret=True)``;

both within 2 float16 ulps of max(1, |ref|): each computes f32 scores,
softmax and sums and rounds once to float16 (#2 also rounds p to the
cache dtype before p.v), so only the summation order differs. Float16
decode is held against the Pallas kernels, not the reference's CPU
``reference_attention``, which scores a half-precision cache in that
precision. On the card ``chip_smoke.py`` (phase fp16-decode) holds the
CUDA kernels to these twins.

- ``generate(cache_dtype="float16")`` on a 2-layer MHA Llama (llama-tiny
  with 4 kv heads) and on gpt-tiny, weights at std 0.5 so greedy streams
  vary, with the reference's decode step through the Pallas kernel in
  interpret mode: greedy tokens exact, every decode step of every layer
  reaching ``ops.attention.flash_decode`` with float16 q;
- the wrappers' CUDA branch takes float16 (its checks pass and it goes on
  to build the kernel) where it raised before.
"""
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as paddle
import paddle_tpu.ops.attention as jax_attn
from paddle_tpu.nlp import paged_cache as jpc
from paddle_tpu.nlp.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nlp.gpt import _resolve_config as jax_gpt_config
from paddle_tpu.nlp.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops.pallas.flash_decode import \
    paged_flash_decode as jax_paged_flash_decode
from paddle_tpu_torch.nlp import modeling_utils
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.nlp.gpt import GPTForCausalLM
from paddle_tpu_torch.nlp.gpt import _resolve_config as port_gpt_config
from paddle_tpu_torch.nlp.llama import LlamaForCausalLM
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops.kernels import flash_attention as port_fa
from torch_threads import one_torch_thread  # noqa: F401

# the packages export functions named like these kernel modules
jax_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
kpd = importlib.import_module("paddle_tpu_torch.ops.kernels.flash_decode")

_ULPS = 2
_S0, _NEW = 10, 8


def _f16_ulps(got, want):
    """max |got - want| in float16 ulps of max(1, |want|)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(1.0, np.abs(want)))) - 10)
    return float((np.abs(got - want) / ulp).max())


def _f16(x):
    return torch.from_numpy(np.asarray(x, np.float16))


# -- #5's twin ------------------------------------------------------------------

@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8", "float16"])
@pytest.mark.parametrize("g", [1, 4])
def test_paged_plain_float16_matches_pallas(pool, g):
    rng = np.random.default_rng(g + len(pool))
    b, hkv, d, ps, p, mp = 3, 2, 64, 16, 8, 3
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float16)
    kf = rng.standard_normal((hkv, p, ps, d)).astype(np.float32)
    vf = rng.standard_normal((hkv, p, ps, d)).astype(np.float32)
    pt = np.array([[1, 2, 3], [4, 5, 0], [6, 7, 0]], np.int32)
    # a full table, one on a page edge, one slot with no key
    lens = np.array([48, 16, 0], np.int32)
    ks = vs = None
    if pool == "int8":
        kq, ksj = jpc.quantize_rows(jnp.asarray(kf))
        vq, vsj = jpc.quantize_rows(jnp.asarray(vf))
        jk, jv, jks, jvs = kq, vq, ksj, vsj
        tk, tv = (torch.from_numpy(np.array(x)) for x in (kq, vq))
        ks, vs = (torch.from_numpy(np.array(x)) for x in (ksj, vsj))
    else:
        jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
               "float16": jnp.float16}[pool]
        jk, jv = jnp.asarray(kf, jdt), jnp.asarray(vf, jdt)
        jks = jvs = None
        tk, tv = (torch.from_numpy(np.array(x, np.float32)).to(
            getattr(torch, pool)) for x in (jk, jv))
    want = jax_paged_flash_decode(jnp.asarray(q), jk, jv, jnp.asarray(pt),
                                  jnp.asarray(lens), k_scale=jks,
                                  v_scale=jvs, interpret=True)
    assert want.dtype == jnp.float16
    got = kpd.paged_decode_plain(_f16(q), tk, tv, torch.from_numpy(pt),
                                 torch.from_numpy(lens), k_scale=ks,
                                 v_scale=vs)
    assert got.dtype == torch.float16 and got.shape == (b, hkv, g, d)
    assert not got[2].any(), "a lens-0 slot gives a zero row"
    assert _f16_ulps(got.float().numpy(), want) <= _ULPS


# -- #2's twin ------------------------------------------------------------------

@pytest.mark.parametrize("d,lens", [(64, [40, 1, 0]), (128, [64, 33, 64])])
def test_dense_plain_float16_matches_pallas(d, lens):
    rng = np.random.default_rng(d)
    b, h, s = 3, 4, 64
    q = rng.standard_normal((b, 1, h, d)).astype(np.float16)
    k = rng.standard_normal((b, s, h, d)).astype(np.float16)
    v = rng.standard_normal((b, s, h, d)).astype(np.float16)
    lens = np.array(lens, np.int32)
    want = jax_fa.flash_decode(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(lens),
                               interpret=True)
    got = port_fa.flash_decode_plain(_f16(q), _f16(k), _f16(v),
                                     torch.from_numpy(lens))
    assert got.dtype == torch.float16 and got.shape == (b, 1, h, d)
    assert _f16_ulps(got.float().numpy(), want) <= _ULPS


# -- generate(cache_dtype="float16") ------------------------------------------

def _numpy_state(jm):
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


@pytest.fixture(scope="module", params=["llama-mha", "gpt-tiny"])
def models(request):
    paddle.seed(0)
    if request.param == "gpt-tiny":
        jm = JaxGPT(jax_gpt_config("gpt-tiny", initializer_range=0.5))
        pm = GPTForCausalLM(port_gpt_config("gpt-tiny",
                                            initializer_range=0.5),
                            device="cpu")
    else:
        ovr = dict(num_key_value_heads=4, initializer_range=0.5)
        jm = JaxLlama.from_config_name("llama-tiny", **ovr)
        pm = LlamaForCausalLM.from_config_name("llama-tiny", device="cpu",
                                               **ovr)
    jm.eval()
    load_numpy_state(pm, _numpy_state(jm))
    return jm, pm.eval()


def test_float16_cache_greedy_matches_pallas_decode(models, monkeypatch):
    """The reference's decode step through its TPU kernel (interpret
    mode), as it runs on the TPU: f32 scores over the float16 cache."""
    jm, pm = models
    calls = []

    def pallas_decode(q, k, v, kv_lens, sm_scale=None):
        calls.append(q.dtype)
        return jax_fa.flash_decode(q, k, v, kv_lens, sm_scale=sm_scale,
                                   interpret=True)

    monkeypatch.setattr(jax_attn, "flash_decode", pallas_decode)
    seen = []
    real = modeling_utils.flash_decode

    def spy(q, k_cache, v_cache, kv_lens, sm_scale=None):
        seen.append(q.dtype)
        return real(q, k_cache, v_cache, kv_lens, sm_scale)

    monkeypatch.setattr(modeling_utils, "flash_decode", spy)
    ids = np.random.default_rng(1).integers(0, 256, (3, _S0)).astype(
        np.int32)
    kw = dict(max_new_tokens=_NEW, cache_dtype="float16",
              decode_strategy="greedy_search")
    from paddle_tpu.nlp import generation as jax_gen
    want = np.asarray(jax_gen.generate(jm, paddle.to_tensor(ids),
                                       **kw)._value)
    assert calls and calls[-1] == jnp.float16
    got = pm.generate(torch.from_numpy(ids), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert all(len(set(r)) > 2 for r in got[:, _S0:])
    assert seen == [torch.float16] * (pm.config.num_hidden_layers * _NEW)


# -- the CUDA branches take float16 -------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


class _Built(Exception):
    pass


def test_cuda_branches_take_float16(monkeypatch):
    """float16 q, pools and caches pass every check of the CUDA branches
    and go on to build their kernel (the meta device stands in for CUDA
    past the device test)."""
    def reached(name, *args):
        raise _Built(name)
    monkeypatch.setattr(_build, "load", reached)
    monkeypatch.setattr(kpd, "_on_cuda", lambda q: None)
    monkeypatch.setattr(port_fa, "_on_cuda", lambda fn, q: None)
    h = torch.float16
    pt = _meta(2, 4, dtype=torch.int32)
    lens = _meta(2, dtype=torch.int32)
    for q, pool in ((_meta(2, 4, 1, 64, dtype=h), _meta(4, 9, 16, 64)),
                    (_meta(2, 4, 4, 128, dtype=h),
                     _meta(4, 9, 16, 128, dtype=torch.bfloat16)),
                    (_meta(2, 4, 1, 64), _meta(4, 9, 16, 64, dtype=h)),
                    (_meta(2, 4, 6, 64, dtype=h),
                     _meta(4, 9, 16, 64, dtype=h))):
        with pytest.raises(_Built, match="paged_flash_decode"):
            kpd.paged_flash_decode(q, pool, pool, pt, lens)
    cache = _meta(2, 32, 4, 64, dtype=h)
    with pytest.raises(_Built, match="flash_decode"):
        port_fa.flash_decode(_meta(2, 1, 4, 64, dtype=h), cache, cache,
                             lens)
