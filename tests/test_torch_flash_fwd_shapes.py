"""The flash-attention forward's plain twin (what the card holds the bf16
tensor-core forward to) vs the JAX package's Pallas forward, at the shapes
that cut the kernel's tiles raggedly.

The bf16 forward owns 128 query rows a block (64 at D=256) and streams key
tiles of 64; these cases put sequence lengths and key lengths on either
side of those edges, within what the reference's ``_fit_block`` takes
(the whole sequence as one block, 8-row multiples, S <= 512 at D=64,
S <= 256 at D=128, S <= 128 or a multiple of 128 at D=256), plus a
one-row query (one block of one row, which interpret mode runs):
``flash_attention_fwd_plain`` (o and lse) against ``_fwd_call`` in
interpret mode — bottom-right causal with sq < sk and sq > sk, kv_lens
holding 0, a mid-tile length and sk, D=128 and D=256, bf16 with dropout
0.1, and a one-row query.

Tolerances are those of ``test_torch_flash_bwd_shapes.py``: f32 1e-5 (the
same arithmetic summed in another order); bf16 1e-2 absolute plus 1e-2
relative (both round the dropped p to bf16 before its product with V).
lse, f32 in both, to 1e-5 absolute and relative, as that file holds delta.
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

# (atol, rtol)
_TOL = {"float32": (1e-5, 0), "bfloat16": (1e-2, 1e-2)}

# bh, sq, sk, d, causal, kv_lens (per bh row), dropout, dtype
CASES = [
    (2, 136, 200, 64, True, None, 0.0, "float32"),     # sq < sk
    (2, 200, 72, 64, True, None, 0.0, "float32"),      # sq > sk: rows see none
    (3, 136, 136, 64, False, [0, 100, 136], 0.0, "float32"),
    (3, 72, 264, 64, True, [0, 100, 264], 0.0, "float32"),
    (2, 136, 200, 128, True, [130, 200], 0.0, "float32"),
    (2, 72, 128, 256, True, [0, 100], 0.0, "float32"),
    (1, 256, 256, 256, True, None, 0.0, "float32"),    # two 128-row blocks
    (2, 200, 136, 64, True, None, 0.1, "bfloat16"),
    (3, 136, 256, 128, True, [0, 129, 256], 0.1, "bfloat16"),
    (2, 72, 128, 256, False, [65, 128], 0.1, "bfloat16"),
    (4, 1, 200, 64, True, [0, 1, 77, 200], 0.0, "float32"),   # one row
    (2, 1, 136, 128, False, None, 0.1, "bfloat16"),
]


def _bhsd(bh, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda s: rng.standard_normal((bh, s, d)).astype(  # noqa: E731
        np.float32)
    return f(sq), f(sk), f(sk)


@pytest.mark.parametrize("bh,sq,sk,d,causal,lens,dropout,dtype", CASES)
def test_twin_matches_pallas_fwd_call(bh, sq, sk, d, causal, lens, dropout,
                                      dtype):
    q, k, v = _bhsd(bh, sq, sk, d, seed=sq + 5 * sk + d)
    jdt = getattr(jnp, dtype)
    scale = 1.0 / np.sqrt(d)
    jx = [jnp.asarray(x).astype(jdt) for x in (q, k, v)]
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    js = jnp.asarray([4242], jnp.int32) if dropout else None
    bq = jax_fa._fit_block(sq, jax_fa.DEFAULT_BLOCK_Q, d)
    bk = jax_fa._fit_block(sk, jax_fa.DEFAULT_BLOCK_K, d)
    assert sq % bq == sk % bk == bk % 8 == 0 and (bq % 8 == 0 or bq == sq)
    want_o, want_lse = jax_fa._fwd_call(*jx, jl, js, causal, scale, dropout,
                                        bq, bk, True)

    tdt = getattr(torch, dtype)
    t = lambda x: torch.from_numpy(  # noqa: E731
        np.array(x.astype(jnp.float32))).to(tdt)
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    ts = torch.tensor([4242], dtype=torch.int32) if dropout else None
    o, lse = port_fa.flash_attention_fwd_plain(*(t(x) for x in jx), tl, ts,
                                               causal, scale, dropout)
    assert o.dtype == tdt and lse.dtype == torch.float32
    atol, rtol = _TOL[dtype]
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(want_o.astype(jnp.float32)),
                               atol=atol, rtol=rtol, err_msg="o")
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0],
                               atol=1e-5, rtol=1e-5, err_msg="lse")
    # rows with no visible key: o = 0 and the -1e30 sentinel, in both
    if lens is not None and 0 in lens:
        i = lens.index(0)
        assert not o[i].any() and (lse[i] == port_fa.NEG_INF).all()
    if causal and sq > sk:
        assert not o[:, :sq - sk].any()
        assert (lse[:, :sq - sk] == port_fa.NEG_INF).all()
    # the wrapper's CPU branch is the twin
    o2, lse2 = port_fa.flash_attention_fwd(*(t(x) for x in jx), tl, ts,
                                           causal, scale, dropout)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
