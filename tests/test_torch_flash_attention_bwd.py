"""Flash-attention backward and attention dropout of the PyTorch port vs the
JAX package.

``torch.autograd.grad`` through the port's differentiable
``flash_attention`` on the CPU (the autograd function's plain backward,
the same math the CUDA kernels run) is held against ``jax.grad`` of the
Pallas kernel run in interpret mode, on the same numpy inputs and the same
output cotangent: causal and not, sq != sk (bottom-right causal), kv_lens
including 0, head_dim 64 and 128, f32 (1e-5) and bf16 (1e-2, absolute
below 1 and relative above: the grads reach magnitudes of 2-4, where one
bf16 ulp is 1.6e-2). Dropout
uses the kernels' murmur3 hash, which the port reproduces bit for bit: the
keep mask is held against the Pallas hash mask for mask, and, with V the
identity, the zeros of the dropped-out output must sit exactly where the
Pallas kernel's do.
"""
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu_torch.ops import attention as port_attn
from torch_threads import one_torch_thread  # noqa: F401

jax_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
port_fa = importlib.import_module(
    "paddle_tpu_torch.ops.kernels.flash_attention")

# (atol, rtol)
_TOL = {"float32": (1e-5, 0), "bfloat16": (1e-2, 1e-2)}


def _arrays(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(b, sq, h, d), f(b, sk, h, d), f(b, sk, h, d), f(b, sq, h, d)


def _jax_grads(q, k, v, do, dtype, **kw):
    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    o, vjp = jax.vjp(lambda *a: jax_fa.flash_attention(
        *a, interpret=True, **kw), *args)
    grads = vjp(jnp.asarray(do).astype(dtype))
    return [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)]


def _port_grads(q, k, v, do, dtype, **kw):
    dt = getattr(torch, dtype)
    args = [torch.from_numpy(x).to(dt).requires_grad_() for x in (q, k, v)]
    o = port_attn.flash_attention(*args, **kw)
    grads = torch.autograd.grad(o, args, torch.from_numpy(do).to(dt))
    return [x.float().numpy() for x in (o.detach(), *grads)]


CASES = [
    # b, sq, sk, h, d, causal, kv_lens
    (2, 64, 64, 2, 64, False, None),
    (2, 64, 64, 2, 64, True, None),
    (1, 32, 96, 2, 64, True, None),        # sq < sk: bottom-right causal
    (1, 96, 32, 1, 64, True, None),        # sq > sk: leading rows see nothing
    (2, 64, 64, 2, 64, True, [40, 64]),
    (2, 48, 48, 1, 64, False, [0, 17]),    # a batch with no visible key
    (1, 64, 64, 2, 128, True, [33]),
    (1, 40, 72, 1, 128, False, [72]),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,d,causal,kv_lens", CASES)
def test_grads_match_pallas_interpret(dtype, b, sq, sk, h, d, causal,
                                      kv_lens):
    q, k, v, do = _arrays(b, sq, sk, h, d, seed=sq * 5 + sk + d)
    kw = dict(causal=causal, kv_lens=kv_lens)
    want = _jax_grads(q, k, v, do, getattr(jnp, dtype), **kw)
    got = _port_grads(q, k, v, do, dtype, **kw)
    atol, rtol = _TOL[dtype]
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=name)
    if kv_lens is not None and 0 in kv_lens:
        i = kv_lens.index(0)
        assert not got[1][i].any(), "no visible key -> dq = 0"


def _folded(b, sq, sk, h, d, seed):
    q, k, v, do = _arrays(b, sq, sk, h, d, seed)
    fold = lambda x: x.transpose(0, 2, 1, 3).reshape(  # noqa: E731
        b * h, x.shape[1], d).copy()
    return [fold(x) for x in (q, k, v, do)]


@pytest.mark.parametrize("causal,lens,dropout", [
    (True, None, 0.0), (False, [64, 9, 0], 0.0), (True, [50, 64, 20], 0.1)])
def test_bwd_plain_matches_pallas_bwd_call(causal, lens, dropout):
    """flash_attention_bwd_plain (and the dq/dk-dv pair of plain twins the
    kernels are held against on the card) == the reference's _bwd_call,
    given the same forward residuals."""
    q, k, v, do = _folded(1, 64, 64, 3, 64, seed=11)
    lens_np = None if lens is None else np.asarray(lens, np.int32)
    seed_np = np.asarray([1234], np.int32) if dropout else None
    jx = [jnp.asarray(x) for x in (q, k, v)]
    jl = None if lens is None else jnp.asarray(lens_np)
    js = None if seed_np is None else jnp.asarray(seed_np)
    o, lse = jax_fa._fwd_call(*jx, jl, js, causal, 0.125, dropout, 64, 64,
                              True)
    want = jax_fa._bwd_call((*jx, o, lse, jl, js), jnp.asarray(do), causal,
                            0.125, dropout, 64, 64, True)
    t = lambda x: None if x is None else torch.from_numpy(  # noqa: E731
        np.asarray(x))
    args = (t(q), t(k), t(v), t(o), t(np.asarray(lse)[..., 0]), t(do),
            t(lens_np), t(seed_np), causal, 0.125, dropout)
    got = port_fa.flash_attention_bwd_plain(*args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)
    # the two halves the CUDA kernels compute, with delta passed between
    tq, tk, tv, to, tlse, tdo, tl, ts = args[:8]
    dq, delta = port_fa.flash_attention_bwd_dq(
        tq, tk, tv, to, tdo, tlse, tl, ts, causal, 0.125, dropout)
    dk, dv = port_fa.flash_attention_bwd_dkv(
        tq, tk, tv, tdo, tlse, delta, tl, ts, causal, 0.125, dropout)
    for g, w in zip((dq, dk, dv), got):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    np.testing.assert_allclose(
        delta.numpy(), (do * np.asarray(o)).sum(-1), atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed,bh,sq,sk,rate", [
    (0, 2, 64, 64, 0.1), (1234, 3, 40, 72, 0.1), (2 ** 31 - 2, 1, 33, 257,
                                                  0.5)])
def test_keep_mask_is_the_pallas_hash(seed, bh, sq, sk, rate):
    want = np.stack([np.asarray(jax_fa._dropout_keep(
        jnp.int32(seed), b, 0, 0, (sq, sk), sq, sk, sk, rate))
        for b in range(bh)])
    got = port_fa.dropout_keep(torch.tensor([seed], dtype=torch.int32), bh,
                               sq, sk, rate, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_mask_for_mask(causal):
    """With V the identity (sk = D = 64), o is the dropped-out probability
    matrix itself: its zeros are the dropped (or masked) entries and must
    sit exactly where the Pallas kernel's do; the values and the grads
    agree within the f32 tolerance."""
    b, s, h, d, rate, seed = 2, 64, 2, 64, 0.1, 77
    q, k, _, do = _arrays(b, s, s, h, d, seed=3)
    v = np.broadcast_to(np.eye(s, dtype=np.float32)[None, :, None, :],
                        (b, s, h, d)).copy()
    kw = dict(causal=causal, dropout_p=rate, dropout_seed=seed)
    want = _jax_grads(q, k, v, do, jnp.float32, **kw)
    got = _port_grads(q, k, v, do, "float32", **kw)
    np.testing.assert_array_equal(got[0] == 0, want[0] == 0)
    assert 0.05 < (got[0] == 0).mean() < 0.6
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_grads_match_pallas(dtype):
    q, k, v, do = _arrays(2, 64, 64, 2, 64, seed=21)
    kw = dict(causal=True, kv_lens=[64, 30], dropout_p=0.1,
              dropout_seed=4242)
    want = _jax_grads(q, k, v, do, getattr(jnp, dtype), **kw)
    got = _port_grads(q, k, v, do, dtype, **kw)
    atol, rtol = _TOL[dtype]
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=name)
