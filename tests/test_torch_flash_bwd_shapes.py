"""The flash-attention backward's plain twins (what the card holds the
bf16 tensor-core kernels to) vs the JAX package's Pallas backward, at the
shapes that cut the kernels' tiles raggedly.

The bf16 kernels own 128 rows a block (64 at D=256) and stream tiles of 64
rows; these cases put sequence lengths and key lengths on either side of
those edges, within what the reference's ``_fit_block`` takes (8-row
blocks dividing S: here the whole sequence as one block, S <= 512 at
D=64 and S <= 256 at D=128):

- ``test_twins_match_pallas_bwd_call``: ``flash_attention_bwd_dq_plain``
  and ``flash_attention_bwd_dkv_plain`` against ``_bwd_call`` in interpret
  mode, both given the reference's own forward residuals (o, lse) —
  bottom-right causal with sq < sk and sq > sk, kv_lens holding 0 and a
  mid-tile length, D=128, bf16 with dropout;
- ``test_autograd_matches_jax_grad``: ``torch.autograd.grad`` through the
  port's ``flash_attention`` against ``jax.grad`` of the reference's, the
  same chain end to end.

Tolerances: f32 1e-5 (the same arithmetic summed in another order); bf16
1e-2 absolute plus 1e-2 relative (both round ds and the dropped p to bf16
before their products; the grads reach 2-4, where one bf16 ulp is 1.6e-2).
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

# bh, sq, sk, d, causal, kv_lens (per bh row), dropout, dtype
TWIN_CASES = [
    (2, 64, 192, 64, True, None, 0.0, "float32"),   # sq < sk
    (2, 192, 64, 64, True, None, 0.0, "float32"),   # sq > sk: rows see none
    (3, 136, 136, 64, False, [0, 70, 136], 0.0, "float32"),
    (3, 72, 200, 64, True, [0, 65, 200], 0.1, "float32"),
    (2, 128, 256, 128, True, [200, 256], 0.0, "float32"),
    (2, 192, 192, 64, True, [0, 130], 0.1, "bfloat16"),
    (2, 64, 256, 128, True, [129, 256], 0.1, "bfloat16"),
    (2, 200, 136, 128, True, None, 0.1, "bfloat16"),
]


def _bhsd(bh, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda s: rng.standard_normal((bh, s, d)).astype(  # noqa: E731
        np.float32)
    return f(sq), f(sk), f(sk), f(sq)


@pytest.mark.parametrize("bh,sq,sk,d,causal,lens,dropout,dtype", TWIN_CASES)
def test_twins_match_pallas_bwd_call(bh, sq, sk, d, causal, lens, dropout,
                                     dtype):
    q, k, v, do = _bhsd(bh, sq, sk, d, seed=sq + 3 * sk + d)
    jdt = getattr(jnp, dtype)
    scale = 1.0 / np.sqrt(d)
    jx = [jnp.asarray(x).astype(jdt) for x in (q, k, v)]
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    js = jnp.asarray([977], jnp.int32) if dropout else None
    bq = jax_fa._fit_block(sq, jax_fa.DEFAULT_BLOCK_Q, d)
    bk = jax_fa._fit_block(sk, jax_fa.DEFAULT_BLOCK_K, d)
    assert sq % bq == sk % bk == bq % 8 == bk % 8 == 0, (bq, bk)
    o, lse = jax_fa._fwd_call(*jx, jl, js, causal, scale, dropout, bq, bk,
                              True)
    want = jax_fa._bwd_call((*jx, o, lse, jl, js),
                            jnp.asarray(do).astype(jdt), causal, scale,
                            dropout, bq, bk, True)

    tdt = getattr(torch, dtype)
    t = lambda x: torch.from_numpy(  # noqa: E731
        np.array(jnp.asarray(x).astype(jnp.float32))).to(tdt)
    tq, tk, tv, to, tdo = (t(x) for x in (*jx, o, jnp.asarray(do)))
    tlse = torch.from_numpy(np.asarray(lse)[..., 0].copy())
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    ts = torch.tensor([977], dtype=torch.int32) if dropout else None
    rest = (tl, ts, causal, scale, dropout)
    dq, delta = port_fa.flash_attention_bwd_dq_plain(tq, tk, tv, to, tdo,
                                                     tlse, *rest)
    dk, dv = port_fa.flash_attention_bwd_dkv_plain(tq, tk, tv, tdo, tlse,
                                                   delta, *rest)
    atol, rtol = _TOL[dtype]
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == tdt, name
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(w.astype(jnp.float32)),
            atol=atol, rtol=rtol, err_msg=name)
    # delta = rowsum(dO * o) in f32, the dq kernel's side output
    want_delta = np.sum(np.asarray(jnp.asarray(do).astype(jdt)
                                   .astype(jnp.float32))
                        * np.asarray(o.astype(jnp.float32)), axis=-1)
    np.testing.assert_allclose(delta.numpy(), want_delta, atol=1e-5,
                               rtol=1e-5)
    if lens is not None and 0 in lens:
        i = lens.index(0)
        assert not dq[i].any() and not dk[i].any() and not dv[i].any()
    if causal and sq > sk:  # the first sq - sk rows see no key
        assert not dq[:, :sq - sk].any()


# b, sq, sk, h, d, causal, kv_lens (per batch row), dropout, dtype
GRAD_CASES = [
    (1, 64, 192, 2, 64, True, None, 0.1, "bfloat16"),
    (2, 136, 72, 1, 64, True, [72, 0], 0.0, "float32"),
    (2, 72, 136, 2, 128, False, [65, 136], 0.1, "bfloat16"),
]


@pytest.mark.parametrize("b,sq,sk,h,d,causal,lens,dropout,dtype",
                         GRAD_CASES)
def test_autograd_matches_jax_grad(b, sq, sk, h, d, causal, lens, dropout,
                                   dtype):
    rng = np.random.default_rng(sq * 7 + sk + d)
    f = lambda s: rng.standard_normal((b, s, h, d)).astype(  # noqa: E731
        np.float32)
    q, k, v, do = f(sq), f(sk), f(sk), f(sq)
    kw = dict(causal=causal, kv_lens=lens, dropout_p=dropout,
              dropout_seed=31)
    jdt = getattr(jnp, dtype)
    args = [jnp.asarray(x).astype(jdt) for x in (q, k, v)]
    o, vjp = jax.vjp(lambda *a: jax_fa.flash_attention(
        *a, interpret=True, **kw), *args)
    want = [np.asarray(x.astype(jnp.float32))
            for x in (o, *vjp(jnp.asarray(do).astype(jdt)))]

    tdt = getattr(torch, dtype)
    targs = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    out = port_attn.flash_attention(*targs, **kw)
    grads = torch.autograd.grad(out, targs, torch.from_numpy(do).to(tdt))
    got = [x.float().numpy() for x in (out.detach(), *grads)]
    atol, rtol = _TOL[dtype]
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=name)
