"""The 3xTF32 arithmetic of the f32 flash backward kernels, emulated in
plain PyTorch, vs the JAX package's Pallas backward.

The f32 dq and dk/dv kernels (csrc/flash_attention_bwd.cu, D = 32 and 64)
run every product on the tensor cores in TF32: each f32 operand x is split
as hi = tf32(x), lo = tf32(x - hi), with tf32 the rounding of
``cvt.rna.tf32.f32``, and each 8-wide step of a contraction runs lo.hi,
hi.lo and hi.hi (three mma.sync) into a sum of its own, from zero, which
is added to the running sum in f32. An mma.sync adds its eight products
to its accumulator rounded toward zero; the emulation models each one so
(the products summed exactly, the sum truncated to f32). The kernels run
only on the card; here their arithmetic is emulated tile by tile:

- dq: K/V tiles of 64 keys; per tile S = Q.K^T and dP = dO.V^T over D, p =
  exp2(s * scale * log2 e - lse * log2 e) masked, dP dropped by the keep
  mask, dS = p (dP - delta), and dQ += dS.K; dQ * scale at the end;
- dk/dv: Q/dO tiles of 32 queries (16 at D = 64); per tile the same S and
  dP, then dV += P_drop^T.dO and dK += dS^T.Q.

The dq kernel splits each key tile over its four warps (16 keys each, the
four sums added in warp order at the end) where 64-row blocks would leave
the card under-filled; both orders are emulated.

``test_3xtf32_backward_matches_pallas`` holds the emulation against
``_bwd_call`` in interpret mode at 1e-5 on dq, dk and dv, both given the
reference's own forward (o, lse): D = 32 and 64, non-causal with
kv_lens holding 0 and a mid-tile length, causal with sq < sk and sq > sk,
dropout 0 and 0.1 with the kernels' keep mask, and a small decoder-cross
shape (sq = 100, sk = 300). ``test_3xtf32_backward_no_further_from_f64`` holds
it no further from a float64 backward of the same inputs than the f32 twin
(``flash_attention_bwd_plain``) lies, over those cases together (the
relative L2 distance of dq, dk and dv): one case's largest element error
is a tail of ~1e-7 roundings that falls on either side of the twin's.
Without the per-step sums (each product run over its whole contraction in
one truncating accumulator) the same emulation lies 4.5x further from
float64 than the twin over these cases, and the kernels so built lay
1.3-2.5x further than the CUDA-core ones on the card (the largest element
error of dq, dk and dv at DETR's three shapes and GPT's f32 shape).
"""
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from test_torch_tf32_split import split

jax_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
port_fa = importlib.import_module(
    "paddle_tpu_torch.ops.kernels.flash_attention")

BS_DQ = 64  # keys a streamed tile of the dq kernel
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def truncated(x):
    """float64 x to f32 rounded toward zero: an mma.sync's accumulation."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def mm3(a, b):
    """a @ b in 3xTF32 as the kernels run it: per 8-wide step of the
    contraction lo.hi, hi.lo and hi.hi, each an mma.sync (its eight
    products summed exactly, added to the step's sum and truncated), from
    zero; the step's sum added to the running f32 sum."""
    ah, al = split(a)
    bh, bl = split(b)
    out = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        x = slice(k0, k0 + 8)
        step = torch.zeros_like(out, dtype=torch.float64)
        for u, w in ((al, bh), (ah, bl), (ah, bh)):
            step = truncated(step + u[..., x].double()
                             @ w[..., x, :].double()).double()
        out = out + step.float()
    return out


def grad_tile(s, dp, lse2, delta, ok, keep, scale_log2, inv_keep):
    """(dropped p, ds) of one tile from its s and dp [.., rows, cols] (the
    kernels' softmax_grad): p = exp2(fma(s, scale_log2, -lse2)), 0 where
    masked."""
    arg = (s.double() * scale_log2.double() - lse2.double()).float()
    p = torch.where(ok, torch.exp2(arg), torch.zeros_like(arg))
    pd = p
    if keep is not None:
        pd = torch.where(keep, p * inv_keep, torch.zeros_like(p))
        dp = torch.where(keep, dp * inv_keep, torch.zeros_like(dp))
    return pd, p * (dp - delta)


def bwd_3xtf32(q, k, v, o, do, lse, lens, seed, causal, dropout, kw=1):
    """The f32 kernels' backward, tile by tile, in plain PyTorch: q, o, dO
    [BH, Sq, D], k/v [BH, Sk, D], lse [BH, Sq] f32 -> (dq, dk, dv). ``kw``:
    the dq kernel's warps a key tile is split over (each summing its keys
    of every tile, the kw sums added in warp order at the end)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = torch.tensor(1.0 / np.sqrt(d), dtype=torch.float32)
    scale_log2 = scale * LOG2E
    lse2 = (lse * LOG2E)[..., None]
    delta = (do * o).sum(-1)[..., None]
    ok = port_fa._visible(sq, sk, lens, causal, "cpu").expand(bh, sq, sk)
    keep = (port_fa.dropout_keep(seed, bh, sq, sk, dropout, "cpu")
            if dropout else None)
    inv_keep = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(
        1.0 - dropout, dtype=torch.float32)

    parts = [torch.zeros(bh, sq, d) for _ in range(kw)]
    wk = BS_DQ // kw
    for k0 in range(0, sk, wk):
        cols = slice(k0, k0 + wk)
        kt, vt = k[:, cols], v[:, cols]
        _, ds = grad_tile(mm3(q, kt.transpose(1, 2)),
                          mm3(do, vt.transpose(1, 2)), lse2, delta,
                          ok[:, :, cols], None if keep is None
                          else keep[:, :, cols], scale_log2, inv_keep)
        w = k0 // wk % kw
        parts[w] = parts[w] + mm3(ds, kt)
    dq = parts[0]
    for part in parts[1:]:
        dq = dq + part

    dk, dv = torch.zeros(bh, sk, d), torch.zeros(bh, sk, d)
    bs = 32 if d == 32 else 16  # queries a tile of the dk/dv kernel
    for q0 in range(0, sq, bs):
        rows = slice(q0, q0 + bs)
        qt, dot = q[:, rows], do[:, rows]
        # rows keys, columns queries, as the dk/dv kernel holds them
        pd, ds = grad_tile(
            mm3(k, qt.transpose(1, 2)), mm3(v, dot.transpose(1, 2)),
            lse2[:, rows].transpose(1, 2), delta[:, rows].transpose(1, 2),
            ok[:, rows].transpose(1, 2), None if keep is None
            else keep[:, rows].transpose(1, 2), scale_log2, inv_keep)
        dv = dv + mm3(pd, dot)
        dk = dk + mm3(ds, qt)
    return dq * scale, dk * scale, dv


def bwd_f64(q, k, v, o, do, lse, lens, seed, causal, dropout):
    """The backward's function in float64 from the same f32 inputs."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    qd, kd, vd, od, dod = (x.double() for x in (q, k, v, o, do))
    ok = port_fa._visible(sq, sk, lens, causal, "cpu")
    s = qd @ kd.transpose(1, 2) / np.sqrt(d)
    p = torch.where(ok, torch.exp(s - lse.double()[..., None]),
                    torch.zeros_like(s))
    dp = dod @ vd.transpose(1, 2)
    pd = p
    if dropout:
        keep = port_fa.dropout_keep(seed, bh, sq, sk, dropout, "cpu")
        pd = torch.where(keep, p / (1 - dropout), torch.zeros_like(p))
        dp = torch.where(keep, dp / (1 - dropout), torch.zeros_like(dp))
    ds = p * (dp - (dod * od).sum(-1, keepdim=True))
    return (ds @ kd / np.sqrt(d), ds.transpose(1, 2) @ qd / np.sqrt(d),
            pd.transpose(1, 2) @ dod)


def rel_l2(got, want):
    """(sum of squared errors, sum of squares of want) over dq, dk, dv."""
    err = sum(((g.double() - w) ** 2).sum().item()
              for g, w in zip(got, want))
    return err, sum((w ** 2).sum().item() for w in want)


# bh, sq, sk, d, causal, kv_lens (per bh row), dropout
CASES = [
    (3, 136, 200, 32, False, [0, 100, 200], 0.0),   # lens 0 and mid-tile
    (3, 136, 200, 64, False, [0, 70, 200], 0.1),
    (2, 72, 200, 32, True, None, 0.1),              # causal, sq < sk
    (2, 136, 264, 64, True, None, 0.0),
    (2, 200, 72, 32, True, None, 0.0),              # sq > sk: rows see none
    (2, 200, 136, 64, True, None, 0.1),
    (2, 100, 300, 32, False, None, 0.1),            # decoder-cross, small
    (2, 100, 300, 64, False, None, 0.0),
]


def _inputs(bh, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bh, s, d)).astype(np.float32)
            for s in (sq, sk, sk, sq)]


def _torch_args(lens, dropout):
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    ts = torch.tensor([2024], dtype=torch.int32) if dropout else None
    return tl, ts


@pytest.mark.parametrize("bh,sq,sk,d,causal,lens,dropout", CASES)
def test_3xtf32_backward_matches_pallas(bh, sq, sk, d, causal, lens,
                                        dropout):
    q, k, v, do = _inputs(bh, sq, sk, d, sq + 5 * sk + d)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    js = jnp.asarray([2024], jnp.int32) if dropout else None
    scale = 1.0 / np.sqrt(d)
    bq = jax_fa._fit_block(sq, jax_fa.DEFAULT_BLOCK_Q, d)
    bk = jax_fa._fit_block(sk, jax_fa.DEFAULT_BLOCK_K, d)
    jx = [jnp.asarray(x) for x in (q, k, v)]
    o, lse = jax_fa._fwd_call(*jx, jl, js, causal, scale, dropout, bq, bk,
                              True)
    want = jax_fa._bwd_call((*jx, o, lse, jl, js), jnp.asarray(do), causal,
                            scale, dropout, bq, bk, True)

    t = lambda x: torch.from_numpy(np.array(x, np.float32))  # noqa: E731
    tq, tk, tv, to, tdo = (t(x) for x in (q, k, v, o, do))
    tlse = t(np.asarray(lse)[..., 0])   # lanes replicated
    tl, ts = _torch_args(lens, dropout)
    for kw in (1, 4):
        got = bwd_3xtf32(tq, tk, tv, to, tdo, tlse, tl, ts, causal, dropout,
                         kw)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=0, err_msg=f"{name} kw={kw}")
        if lens is not None and 0 in lens:
            i = lens.index(0)
            assert not any(g[i].any() for g in got)
        if causal and sq > sk:  # the first sq - sk rows see no key
            assert not got[0][:, :sq - sk].any()


def test_3xtf32_backward_no_further_from_f64():
    """Over every case and both dq orders, the emulation's dq, dk and dv lie
    no further from a float64 backward of the same inputs (the twin
    forward's o and lse) than the f32 twin's, in relative L2."""
    ours, twin, norm = 0.0, 0.0, 0.0
    for bh, sq, sk, d, causal, lens, dropout in CASES:
        tq, tk, tv, tdo = (torch.from_numpy(x) for x in
                           _inputs(bh, sq, sk, d, sq + 5 * sk + d))
        tl, ts = _torch_args(lens, dropout)
        to, tlse = port_fa.flash_attention_fwd_plain(tq, tk, tv, tl, ts,
                                                     causal, None, dropout)
        want = bwd_f64(tq, tk, tv, to, tdo, tlse, tl, ts, causal, dropout)
        e_twin, n = rel_l2(port_fa.flash_attention_bwd_plain(
            tq, tk, tv, to, tlse, tdo, tl, ts, causal, None, dropout), want)
        for kw in (1, 4):
            ours += rel_l2(bwd_3xtf32(tq, tk, tv, to, tdo, tlse, tl, ts,
                                      causal, dropout, kw), want)[0]
            twin, norm = twin + e_twin, norm + n
    assert ours <= twin, (np.sqrt(ours / norm), np.sqrt(twin / norm))
