"""Dense single-query flash-decode of the PyTorch port vs the JAX package.

The port's plain twin of the CUDA kernel (what the CPU runs) is held
against the reference's ``flash_decode`` Pallas kernel run in interpret
mode, on the same numpy inputs: f32 (1e-5) and bf16 (2e-2), head_dim 64
and 128, key lengths including 1 and S, S a multiple of 128 as the Pallas
side needs. At ragged S, and with a zero-length row, it is held against
``reference_attention`` (1e-5). A CPU call builds nothing; the CUDA
branch's checks raise on what the kernel does not take (the meta device
stands in for the card, so nothing launches).
"""
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.ops.attention import reference_attention as jax_ref
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import attention as port_attn
from torch_threads import one_torch_thread  # noqa: F401

# both packages export a function named like the kernel module
jax_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
port_fa = importlib.import_module(
    "paddle_tpu_torch.ops.kernels.flash_attention")

_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 1, h, d)).astype(np.float32),
            rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, h, d)).astype(np.float32))


def _port(q, k, v, lens, dtype):
    dt = getattr(torch, dtype)
    args = [torch.from_numpy(x).to(dt) for x in (q, k, v)]
    out = port_attn.flash_decode(*args, torch.tensor(lens, dtype=torch.int32))
    assert out.dtype == dt and out.shape == args[0].shape
    return out.float().numpy()


CASES = [
    # b, s, h, d, lens
    (3, 128, 2, 64, [1, 128, 77]),
    (2, 256, 2, 128, [256, 129]),
    (4, 128, 1, 128, [1, 64, 100, 128]),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "b{}s{}h{}d{}".format(
    *c[:4]))
def test_twin_matches_pallas_decode(case, dtype):
    b, s, h, d, lens = case
    q, k, v = _inputs(b, s, h, d, seed=s + d)
    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    want = np.asarray(jax_fa.flash_decode(
        *args, jnp.asarray(lens, jnp.int32),
        interpret=True).astype(jnp.float32))
    got = _port(q, k, v, lens, dtype)
    np.testing.assert_allclose(got, want, atol=_TOL[dtype], rtol=0)


@pytest.mark.parametrize("s,lens", [(77, [0, 77, 13]), (200, [199, 1, 0]),
                                    (5, [5, 2, 3])])
def test_twin_matches_reference_attention_ragged(s, lens):
    """S not a multiple of anything, and rows with no key (which give 0,
    as the kernel's do): against the reference's jnp path."""
    q, k, v = _inputs(len(lens), s, 2, 64, seed=s)
    want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              kv_lens=jnp.asarray(lens)))
    got = _port(q, k, v, lens, "float32")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for i, n in enumerate(lens):
        if n == 0:
            assert not got[i].any()


def test_cache_read_in_place_through_strides():
    """A cache viewed out of a larger buffer (strided batch and sequence)
    gives the same output as its contiguous copy."""
    q, k, v = _inputs(2, 96, 2, 64, seed=5)
    big_k = torch.zeros(4, 128, 2, 64)
    big_v = torch.zeros(4, 128, 2, 64)
    big_k[::2, :96] = torch.from_numpy(k)
    big_v[::2, :96] = torch.from_numpy(v)
    lens = torch.tensor([96, 40], dtype=torch.int32)
    a = port_attn.flash_decode(torch.from_numpy(q), big_k[::2, :96],
                               big_v[::2, :96], lens)
    b = port_attn.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), lens)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_cpu_dispatch_never_builds(monkeypatch):
    def no_build(name, *args):
        raise AssertionError(f"CPU dispatch reached the kernel build "
                             f"({name})")
    monkeypatch.setattr(_build, "load", no_build)
    before = port_fa.flash_decode.launches
    q, k, v = _inputs(2, 64, 2, 64, seed=1)
    _port(q, k, v, [64, 3], "float32")
    assert port_fa.flash_decode.launches == before


@pytest.mark.parametrize("b,s", [(8, 576), (4, 576), (1, 10), (128, 4096),
                                 (1, 4096)])
@pytest.mark.parametrize("h", [16, 32, 2])
def test_decode_split_covers_the_cache(b, s, h):
    """Every key lies in exactly one chunk: the chunks cover S and the last
    one is not empty; each is a multiple of the most keys a block takes in
    one round (64), and the call puts at least the card's SM count of
    blocks to work when S allows it."""
    splits, chunk = port_fa.decode_split(b, h, s)
    assert splits * chunk >= s > (splits - 1) * chunk
    assert chunk % 64 == 0
    assert b * h * splits >= min(132, b * h * -(-s // 64))


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_cuda_branch_checks_raise(monkeypatch):
    """The kernel branch raises on an unsupported D, dtype, head mismatch,
    a mismatched cache or bad lens; the checks run before any build (the
    meta device stands in for CUDA past the device test)."""
    def no_build(name, *args):
        raise AssertionError(f"reached the kernel build ({name})")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(port_fa, "_on_cuda", lambda fn, q: None)
    lens = _meta(2, dtype=torch.int32)
    ok = (_meta(2, 1, 4, 64), _meta(2, 32, 4, 64), _meta(2, 32, 4, 64))
    bad = [
        ((_meta(2, 1, 4, 96), _meta(2, 32, 4, 96), _meta(2, 32, 4, 96)),
         lens, ValueError, "head_dim"),
        ((_meta(2, 1, 4, 64, dtype=torch.float64),
          _meta(2, 32, 4, 64, dtype=torch.float64),
          _meta(2, 32, 4, 64, dtype=torch.float64)), lens, TypeError,
         "dtype"),
        ((_meta(2, 1, 4, 64, dtype=torch.float16), ok[1], ok[2]), lens,
         TypeError, "k_cache"),
        ((ok[0], _meta(2, 32, 4, 64, dtype=torch.bfloat16), ok[2]), lens,
         TypeError, "k_cache"),
        ((ok[0], _meta(2, 32, 2, 64), _meta(2, 32, 2, 64)), lens,
         ValueError, "heads"),
        ((_meta(2, 2, 4, 64), ok[1], ok[2]), lens, ValueError, r"\[B, 1"),
        ((ok[0], ok[1], _meta(2, 16, 4, 64)), lens, ValueError, "v_cache"),
        (ok, _meta(2, dtype=torch.int64), ValueError, "int32"),
        (ok, _meta(3, dtype=torch.int32), ValueError, "kv_lens"),
    ]
    for (q, k, v), ln, exc, match in bad:
        with pytest.raises(exc, match=match):
            port_fa.flash_decode(q, k, v, ln)


def test_off_cpu_without_kernel_raises(monkeypatch):
    """A tensor on neither the CPU nor CUDA never reaches the twin."""
    def no_build(name, *args):
        raise AssertionError(f"reached the kernel build ({name})")
    monkeypatch.setattr(_build, "load", no_build)
    t = _meta(2, 1, 4, 64)
    c = _meta(2, 32, 4, 64)
    with pytest.raises(ValueError, match="unsupported device"):
        port_fa.flash_decode(t, c, c, _meta(2, dtype=torch.int32))
