"""Flash attention in float16: the port's twins vs the Pallas kernels.

The CUDA kernels #1, #3 and #4 take float16 on the card; on the CPU the
port's differentiable ``flash_attention`` runs their plain twins, which
round p, ds and the dropped p to float16 before each product and o, dq,
dk and dv on store, as the reference's kernel rounds them to its input
dtype. Held against the Pallas kernel in interpret mode on the same numpy
inputs, the forward and ``jax.grad`` through its custom_vjp: causal and
not, sq != sk, ``kv_lens`` (a row with no visible key included), dropout
(the keep mask bit for bit), head dims 64 and 128. The bars: o within
2e-3 of max(1, |ref|) (measured 4.9e-4 at most: a float16 ulp at 1 is
9.8e-4), dq, dk and dv within 5e-3 of it (measured 7.9e-4 at most).

An overflow case: dO scaled up to 1.5e4 makes ds pass float16's top
(65504) in 64 rows. Both round it to inf, as ``astype`` does (a
saturating conversion would hide the overflow a GradScaler exists to
catch): dq and dk hold inf and NaN at exactly the same places in both
(dv, from the dropped p, stays finite), and their finite values agree
within the gradient bar (measured 1.1e-3).
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

_O_TOL, _GRAD_TOL = 2e-3, 5e-3


def _arrays(b, sq, sk, h, d, seed, do_scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float16)  # noqa: E731
    q, k, v, do = f(b, sq, h, d), f(b, sk, h, d), f(b, sk, h, d), \
        f(b, sq, h, d)
    return q, k, v, (do.astype(np.float32) * do_scale).astype(np.float16)


def _jax(q, k, v, do, **kw):
    args = [jnp.asarray(x) for x in (q, k, v)]
    o, vjp = jax.vjp(lambda *a: jax_fa.flash_attention(
        *a, interpret=True, **kw), *args)
    out = (o, *vjp(jnp.asarray(do)))
    assert all(x.dtype == jnp.float16 for x in out)
    return [np.asarray(x.astype(jnp.float32)) for x in out]


def _port(q, k, v, do, **kw):
    args = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = port_attn.flash_attention(*args, **kw)
    out = (o.detach(), *torch.autograd.grad(o, args, torch.from_numpy(do)))
    assert all(x.dtype == torch.float16 for x in out)
    return [x.float().numpy() for x in out]


def _rel(got, want):
    return float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())


CASES = [
    # b, sq, sk, h, d, causal, kv_lens, dropout
    (2, 64, 64, 2, 64, False, None, 0.0),
    (2, 64, 64, 2, 64, True, None, 0.0),
    (1, 32, 96, 2, 64, True, None, 0.0),      # sq < sk: bottom-right
    (1, 96, 32, 1, 64, True, None, 0.0),      # leading rows see nothing
    (2, 64, 64, 2, 64, True, [40, 64], 0.0),
    (2, 48, 48, 1, 64, False, [0, 17], 0.0),  # a batch with no visible key
    (2, 64, 64, 2, 64, True, [64, 30], 0.1),
    (1, 64, 64, 2, 64, False, None, 0.1),
    (1, 64, 64, 2, 128, True, [33], 0.1),
    (1, 40, 72, 1, 128, False, [72], 0.0),
]


@pytest.mark.parametrize("b,sq,sk,h,d,causal,kv_lens,dropout", CASES)
def test_fp16_matches_pallas_interpret(b, sq, sk, h, d, causal, kv_lens,
                                       dropout):
    q, k, v, do = _arrays(b, sq, sk, h, d, seed=sq * 5 + sk + d)
    kw = dict(causal=causal, kv_lens=kv_lens, dropout_p=dropout,
              dropout_seed=4242)
    want = _jax(q, k, v, do, **kw)
    got = _port(q, k, v, do, **kw)
    for name, g, w, tol in zip(("o", "dq", "dk", "dv"), got, want,
                               (_O_TOL,) + (_GRAD_TOL,) * 3):
        assert np.isfinite(g).all() and np.isfinite(w).all(), name
        assert _rel(g, w) <= tol, (name, _rel(g, w))
    if kv_lens is not None and 0 in kv_lens:
        assert not got[1][kv_lens.index(0)].any(), "no visible key: dq = 0"


@pytest.mark.parametrize("causal", [False, True])
def test_fp16_dropout_mask_for_mask(causal):
    """With V the identity (sk = D = 64), o is the dropped probability
    matrix: its zeros sit exactly where the Pallas kernel's do."""
    b, s, h, d = 2, 64, 2, 64
    q, k, _, do = _arrays(b, s, s, h, d, seed=3)
    v = np.broadcast_to(np.eye(s, dtype=np.float16)[None, :, None, :],
                        (b, s, h, d)).copy()
    kw = dict(causal=causal, dropout_p=0.1, dropout_seed=77)
    want = _jax(q, k, v, do, **kw)
    got = _port(q, k, v, do, **kw)
    np.testing.assert_array_equal(got[0] == 0, want[0] == 0)
    assert 0.05 < (got[0] == 0).mean() < 0.6
    assert _rel(got[0], want[0]) <= _O_TOL


def test_fp16_bwd_call_matches_twins():
    """The dq and dk/dv twins (what the CUDA kernels are held against on
    the card) vs the reference's ``_bwd_call`` from the same forward
    residuals, at float16."""
    b, s, h, d = 1, 64, 3, 64
    q, k, v, do = _arrays(b, s, s, h, d, seed=11)
    fold = lambda x: x.transpose(0, 2, 1, 3).reshape(  # noqa: E731
        b * h, s, d).copy()
    q, k, v, do = (fold(x) for x in (q, k, v, do))
    lens = np.asarray([64, 9, 0], np.int32)
    seed = np.asarray([1234], np.int32)
    jx = [jnp.asarray(x) for x in (q, k, v)]
    o, lse = jax_fa._fwd_call(*jx, jnp.asarray(lens), jnp.asarray(seed),
                              True, 0.125, 0.1, 64, 64, True)
    want = jax_fa._bwd_call((*jx, o, lse, jnp.asarray(lens),
                             jnp.asarray(seed)), jnp.asarray(do), True,
                            0.125, 0.1, 64, 64, True)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    po, plse = port_fa.flash_attention_fwd(
        t(q), t(k), t(v), t(lens), t(seed), True, 0.125, 0.1)
    assert po.dtype == torch.float16
    assert _rel(po.float().numpy(), np.asarray(o, np.float32)) <= _O_TOL
    dq, delta = port_fa.flash_attention_bwd_dq(
        t(q), t(k), t(v), t(o), t(do), t(np.asarray(lse)[..., 0]), t(lens),
        t(seed), True, 0.125, 0.1)
    dk, dv = port_fa.flash_attention_bwd_dkv(
        t(q), t(k), t(v), t(do), t(np.asarray(lse)[..., 0]), delta,
        t(lens), t(seed), True, 0.125, 0.1)
    assert delta.dtype == torch.float32
    for g, w in zip((dq, dk, dv), want):
        assert g.dtype == torch.float16
        assert _rel(g.float().numpy(), np.asarray(w, np.float32)) <= \
            _GRAD_TOL


def test_fp16_overflow_is_inf_where_the_reference_has_it():
    q, k, v, do = _arrays(1, 64, 64, 2, 64, seed=5, do_scale=1.5e4)
    kw = dict(causal=True)
    want = _jax(q, k, v, do, **kw)
    got = _port(q, k, v, do, **kw)
    assert np.isfinite(got[0]).all() and _rel(got[0], want[0]) <= _O_TOL
    assert not np.isfinite(want[1]).all(), "dq: no overflow to hold"
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_array_equal(np.isposinf(g), np.isposinf(w), name)
        np.testing.assert_array_equal(np.isneginf(g), np.isneginf(w), name)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), name)
        ok = np.isfinite(w)
        assert _rel(g[ok], w[ok]) <= _GRAD_TOL, name
