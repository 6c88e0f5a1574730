"""Paged KV cache and paged decode of the PyTorch port vs the JAX package.

The port's plain twin of the paged decode kernel is held against the
Pallas kernel in interpret mode and against ``paged_attention_ref``, on
the same numpy inputs: f32/bf16/int8 pools, G in {1, 4}, a slot with
lens 0 and lens exactly on a page boundary. The page writes and int8
row quantization must agree with the JAX package bit for bit.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.nlp import paged_cache as jpc
from paddle_tpu.ops.pallas.flash_decode import \
    paged_flash_decode as jax_paged_flash_decode
from paddle_tpu_torch.nlp import paged_cache as ppc
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops.kernels.flash_decode import paged_flash_decode
from torch_threads import one_torch_thread  # noqa: F401

_TOL = {"float32": 1e-5, "bfloat16": 1e-2, "int8": 1e-5}


def _case(dtype, g, b=4, hkv=2, d=64, ps=16, p=11, mp=4, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    kp = rng.standard_normal((hkv, p, ps, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, p, ps, d)).astype(np.float32)
    pt = rng.integers(1, p, (b, mp)).astype(np.int32)
    # a zero-length slot, one ending exactly on a page boundary, one
    # mid-page, one full
    lens = np.array([0, 2 * ps, 2 * ps + 5, mp * ps], np.int32)[:b]
    pt[0] = jpc.TRASH_PAGE   # the inactive slot's all-trash row
    ks = vs = None
    if dtype == "int8":
        kq, ks = jpc.quantize_rows(jnp.asarray(kp))
        vq, vs = jpc.quantize_rows(jnp.asarray(vp))
        kp, vp, ks, vs = (np.asarray(x) for x in (kq, vq, ks, vs))
    elif dtype == "bfloat16":
        kp = np.asarray(jnp.asarray(kp, jnp.bfloat16))
        vp = np.asarray(jnp.asarray(vp, jnp.bfloat16))
    return q, kp, vp, pt, lens, ks, vs


def _to_torch(x):
    if x is None:
        return None
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))   # a writable copy


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_plain_decode_matches_pallas_and_ref(dtype, g):
    args = _case(dtype, g, seed=g)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    q, kp, vp, pt, lens, ks, vs = jargs
    want_k = np.asarray(jax_paged_flash_decode(
        q, kp, vp, pt, lens, k_scale=ks, v_scale=vs, interpret=True))
    want_r = np.asarray(jpc.paged_attention_ref(
        q, kp, vp, pt, lens, k_scale=ks, v_scale=vs))
    t = [_to_torch(a) for a in args]
    got = paged_flash_decode(t[0], t[1], t[2], t[3], t[4],
                             k_scale=t[5], v_scale=t[6]).numpy()
    np.testing.assert_allclose(got, want_k, atol=_TOL[dtype], rtol=0)
    np.testing.assert_allclose(got, want_r, atol=_TOL[dtype], rtol=0)
    assert not got[0].any(), "lens 0 -> zero row"
    ref = ppc.paged_attention_ref(t[0], t[1], t[2], t[3], t[4],
                                  k_scale=t[5], v_scale=t[6])
    np.testing.assert_array_equal(ref.numpy(), got)


def test_cpu_decode_never_builds(monkeypatch):
    def no_build(name, *args):
        raise AssertionError(f"CPU call reached the kernel build ({name})")
    monkeypatch.setattr(_build, "load", no_build)
    before = paged_flash_decode.launches
    t = [_to_torch(a) for a in _case("float32", 2)]
    paged_flash_decode(*t[:5])
    assert paged_flash_decode.launches == before


def test_quantize_rows_bit_exact():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3.0
    x[1, 2] = 0.0                       # an all-zero row: scale 0
    x[2, 0, :4] = [127.0, -63.5, 0.5, 1.5]  # exact halves round to even
    jq, js = jpc.quantize_rows(jnp.asarray(x))
    pq, ps_ = ppc.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps_.numpy(), np.asarray(js))


def _pools(dtype, seed, hkv=2, p=7, ps=16, d=64):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((hkv, p, ps, d)).astype(np.float32)
    v = rng.standard_normal((hkv, p, ps, d)).astype(np.float32)
    if dtype == "int8":
        kq, ks = jpc.quantize_rows(jnp.asarray(k))
        vq, vs = jpc.quantize_rows(jnp.asarray(v))
        return [np.asarray(a) for a in (kq, vq, ks, vs)]
    dt = jnp.dtype(dtype)
    return [np.asarray(jnp.asarray(k, dt)), np.asarray(jnp.asarray(v, dt)),
            None, None]


def _assert_pools_equal(port, jax_):
    for p_, j_ in zip(port, jax_):
        if j_ is None:
            assert p_ is None
            continue
        np.testing.assert_array_equal(p_.float().numpy(),
                                      np.asarray(j_).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_write_token_kv_matches_jax(dtype):
    pools = _pools(dtype, seed=1)
    rng = np.random.default_rng(2)
    b = 4
    k_new = rng.standard_normal((b, 2, 64)).astype(np.float32)
    v_new = rng.standard_normal((b, 2, 64)).astype(np.float32)
    pt = np.array([[1, 2], [3, 4], [5, 6], [0, 0]], np.int32)
    pos = np.array([0, 15, 16, 3], np.int32)   # page edges included
    live = np.array([True, True, True, False])
    jcache = jpc.PagedLayerCache(
        *(jnp.asarray(a) for a in pools[:2]), jnp.asarray(pt),
        jnp.asarray(pos), k_scale=None if pools[2] is None
        else jnp.asarray(pools[2]), v_scale=None if pools[3] is None
        else jnp.asarray(pools[3]))
    want = jpc.write_token_kv(jcache, jnp.asarray(k_new),
                              jnp.asarray(v_new), jnp.asarray(live))
    tp = [_to_torch(a) for a in pools]
    pcache = ppc.PagedLayerCache(tp[0], tp[1], torch.from_numpy(pt),
                                 torch.from_numpy(pos), k_scale=tp[2],
                                 v_scale=tp[3])
    got = ppc.write_token_kv(pcache, torch.from_numpy(k_new),
                             torch.from_numpy(v_new),
                             torch.from_numpy(live))
    _assert_pools_equal(got, want)
    assert got[0] is tp[0], "the port writes the pool in place"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_write_prompt_kv_matches_jax(dtype):
    pools = _pools(dtype, seed=4)
    rng = np.random.default_rng(5)
    k_full = rng.standard_normal((1, 48, 2, 64)).astype(np.float32)
    v_full = rng.standard_normal((1, 48, 2, 64)).astype(np.float32)
    pages_vec = np.array([3, 5, 0], np.int32)   # tail block -> trash
    want = jpc.write_prompt_kv(
        *(None if a is None else jnp.asarray(a) for a in pools),
        jnp.asarray(k_full), jnp.asarray(v_full), jnp.asarray(pages_vec))
    tp = [_to_torch(a) for a in pools]
    got = ppc.write_prompt_kv(*tp, torch.from_numpy(k_full),
                              torch.from_numpy(v_full),
                              torch.from_numpy(pages_vec))
    _assert_pools_equal(got, want)


def test_alloc_pages_layout():
    k, v, ks, vs = ppc.alloc_pages(9, 16, 2, 64, "int8", "cpu")
    assert k.shape == (2, 9, 16, 64) and k.dtype == torch.int8
    assert ks.shape == (2, 9, 16, 1) and ks.dtype == torch.float32
    assert ks is not vs
    assert ppc.alloc_pages(9, 16, 2, 64, "bfloat16", "cpu")[2] is None
