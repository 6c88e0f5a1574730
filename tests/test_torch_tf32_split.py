"""The 3xTF32 arithmetic of the f32 flash forward kernel, emulated in plain
PyTorch, vs the JAX package's Pallas forward.

The f32 kernel (csrc/flash_attention_fwd.cu) runs both products on the
tensor cores in TF32: every f32 operand x is split as hi = tf32(x), lo =
tf32(x - hi), with tf32 the rounding of ``cvt.rna.tf32.f32`` (round to
nearest, ties away from zero, on 10 mantissa bits), and a.b is taken as
lo.hi + hi.lo + hi.hi in f32. The kernel runs only on the card; here its
arithmetic is emulated tile by tile (64 keys a tile, 32 at D=256; the
online softmax with the scale folded into exp2; P split like any operand)
and held against ``_fwd_call`` in interpret mode at 1e-5 on o and lse:
causal with sq < sk and sq > sk, kv_lens holding 0, D=64 and D=128, and
dropout 0.1 with the keep mask the kernel uses.
"""
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from torch_threads import one_torch_thread  # noqa: F401

jax_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
port_fa = importlib.import_module(
    "paddle_tpu_torch.ops.kernels.flash_attention")


def tf32(x):
    """x (f32) rounded to tf32 as cvt.rna.tf32.f32 rounds it: add half of
    the 13 dropped bits to the magnitude, then drop them (finite x)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a, b):
    """a @ b in 3xTF32: the two small terms first, f32 sums."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def fwd_3xtf32(q, k, v, lens, seed, causal, dropout):
    """The f32 kernel's forward, tile by tile, in plain PyTorch: q [BH, Sq,
    D], k/v [BH, Sk, D] f32 -> (o, lse)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    bk = 32 if d == 256 else 64
    scale_log2 = (1.0 / np.sqrt(d)) * np.log2(np.e)
    ok = port_fa._visible(sq, sk, lens, causal, "cpu").expand(bh, sq, sk)
    keep = None
    if dropout:
        keep = port_fa.dropout_keep(seed, bh, sq, sk, dropout, "cpu")
    m = torch.full((bh, sq, 1), -1e30)
    l = torch.zeros(bh, sq, 1)
    acc = torch.zeros(bh, sq, d)
    for k0 in range(0, sk, bk):
        s = mm3(q, k[:, k0:k0 + bk].transpose(1, 2))
        s = torch.where(ok[:, :, k0:k0 + bk], s,
                        torch.full_like(s, -float("inf")))
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - mx) * scale_log2)
        p = torch.exp2(s * scale_log2 - mx * scale_log2)
        l = l * alpha + p.sum(-1, keepdim=True)
        if keep is not None:
            p = torch.where(keep[:, :, k0:k0 + bk], p / (1 - dropout),
                            torch.zeros_like(p))
        acc = acc * alpha + mm3(p, v[:, k0:k0 + bk])
        m = mx
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    lse = torch.where(l == 0, torch.full_like(l, -1e30),
                      m / np.sqrt(d) + torch.log(safe_l))
    return acc / safe_l, lse[..., 0]


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -12, 1.0, 0.0, -0.0], dtype=torch.float32)
    want = torch.tensor([1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10), 1.0,
                         1.0, 0.0, -0.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    rng = np.random.default_rng(0)
    r = torch.from_numpy(rng.standard_normal(10000).astype(np.float32))
    hi, lo = split(r)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((r - hi).abs() <= hi.abs() * 2.0 ** -11).all()
    # hi + lo carries about 21 bits: within 2^-21 of x
    assert ((r - hi - lo).abs() <= r.abs() * 2.0 ** -21).all()


# bh, sq, sk, d, causal, kv_lens (per bh row), dropout
CASES = [
    (2, 136, 200, 64, True, None, 0.0),            # sq < sk
    (2, 200, 72, 64, True, None, 0.0),             # sq > sk: rows see none
    (3, 72, 264, 64, True, [0, 100, 264], 0.0),
    (3, 136, 136, 64, False, [0, 65, 136], 0.0),
    (2, 136, 200, 128, True, [130, 200], 0.0),
    (2, 136, 136, 64, True, [100, 136], 0.1),
]


@pytest.mark.parametrize("bh,sq,sk,d,causal,lens,dropout", CASES)
def test_3xtf32_forward_matches_pallas(bh, sq, sk, d, causal, lens,
                                       dropout):
    rng = np.random.default_rng(sq + 7 * sk + d)
    q, k, v = (rng.standard_normal((bh, s, d)).astype(np.float32)
               for s in (sq, sk, sk))
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    js = jnp.asarray([4242], jnp.int32) if dropout else None
    bq = jax_fa._fit_block(sq, jax_fa.DEFAULT_BLOCK_Q, d)
    bk = jax_fa._fit_block(sk, jax_fa.DEFAULT_BLOCK_K, d)
    want_o, want_lse = jax_fa._fwd_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jl, js, causal,
        1.0 / np.sqrt(d), dropout, bq, bk, True)
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    ts = torch.tensor([4242], dtype=torch.int32) if dropout else None
    o, lse = fwd_3xtf32(*(torch.from_numpy(x) for x in (q, k, v)), tl, ts,
                        causal, dropout)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=1e-5,
                               rtol=0)
    want_lse = np.asarray(want_lse)[..., 0]   # lanes replicated
    live = want_lse > -1e29
    np.testing.assert_allclose(lse.numpy()[live], want_lse[live], atol=1e-5,
                               rtol=1e-5)
    assert (lse.numpy()[~live] == -1e30).all()
