"""The fused LayerNorm backward's launch plan and summation order, on the
CPU.

The backward (csrc/fused_ln.cu, #7 and #9) runs one warp a row: lane l
owns the 16-byte chunks l + 32 j of a row (8 bf16 or 4 f32 values each),
warp w of block b takes rows b * 4 + w, then every 4 * blocks rows on, and
the grid is at most one wave of the blocks that reside on the card. Here:
the plan (``bwd_plan``) is a function of (n, h, dtype) that visits every
row and every column exactly once in one wave; a PyTorch f32 emulation of
the kernel's order (a lane's sums over its chunks, the warp's butterfly,
dgamma/dbeta per lane over its warp's rows, the warps in order, the
partial rows by the column sum's 16 strided runs) holds against the
Pallas ``_bwd_call`` and ``_bwd_call_y`` in interpret mode; and the CUDA
branch's checks raise before any build (the meta device stands in for the
card).

Tolerances: dx in f32 within 1e-5, bf16 within 1e-2 of max(1, |ref|).
dgamma/dbeta are f32 sums over 4352 rows of terms near 1, taken in another
order than the Pallas grid's: both orders land ~3e-5 from the float64 sum,
whose largest entries are ~200 (one f32 ulp there is 1.5e-5), and a column
that cancels to near 0 keeps that absolute error. So they are held within
1e-5 (f32 rows) or 1e-2 (bf16 rows) of max(1, the largest |ref| entry),
and the emulated order to at most twice the Pallas order's error against
the float64 sum.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas import fused_ln as pallas_ln
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops.kernels import fused_ln as kln
from torch_threads import one_torch_thread  # noqa: F401

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_SMS = 132


def _warp_rows(n, blocks):
    """Each warp's rows, in the order it visits them (a list a warp)."""
    stride = 4 * blocks
    return [list(range(w, n, stride)) for w in range(stride)]


def _lane_columns(h, dtype):
    """{lane: its columns in the order it adds them up} of a row."""
    per = 16 // (2 if dtype == torch.bfloat16 else 4)
    chunks = kln.bwd_plan(1, h, dtype).chunks
    nch = -(-h // per)
    return {lane: [k * per + e for j in range(chunks)
                   for k in [lane + 32 * j] if k < nch
                   for e in range(per) if k * per + e < h]
            for lane in range(32)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h", [64, 100, 768, 1000, 1024])
@pytest.mark.parametrize("n", [1, 7, 4095, 4097, 8192, 16384])
def test_plan_visits_every_row_and_column_once(n, h, dtype):
    plan = kln.bwd_plan(n, h, dtype)
    assert plan == kln.bwd_plan(n, h, dtype)
    # one wave: at most the resident blocks of the card's SMs, each
    # within an SM's shared memory
    assert 1 <= plan.blocks <= _SMS * plan.blocks_per_sm
    assert plan.blocks_per_sm in (2, 3, 4)
    assert plan.smem <= 232448
    assert plan.blocks_per_sm * (plan.smem + 1024) <= 233472
    rows = _warp_rows(n, plan.blocks)
    assert sorted(r for w in rows for r in w) == list(range(n))
    # the warps share the rows evenly: none runs two more than another
    lens = [len(w) for w in rows]
    assert max(lens) - min(lens) <= 1
    cols = _lane_columns(h, dtype)
    assert sorted(c for lane in cols.values() for c in lane) == \
        list(range(h))


def test_plan_at_the_slice_shapes():
    """ERNIE's (16384 x 768) and GPT's (8192 x 1024) bf16 rows: four
    blocks an SM resident and a grid of two an SM, 264, one wave; f32 rows
    past 512 values reside three or two blocks an SM (shared memory)."""
    bf, f32 = torch.bfloat16, torch.float32
    assert kln.bwd_plan(16384, 768, bf) == (3, 39936, 4, 264)
    assert kln.bwd_plan(8192, 1024, bf) == (4, 53248, 4, 264)
    assert kln.bwd_plan(16384, 768, f32) == (6, 76800, 3, 264)
    assert kln.bwd_plan(16384, 1024, f32) == (8, 102400, 2, 264)
    assert kln.bwd_plan(7, 768, bf).blocks == 2
    for bad in ((0, 768), (8, 0), (8, kln.MAX_H + 1)):
        with pytest.raises(ValueError, match="no plan"):
            kln.bwd_plan(*bad, bf)


def _seq_sum(vals):
    """Sum of a list of f32 tensors, added one by one from the first."""
    out = vals[0].clone()
    for v in vals[1:]:
        out = out + v
    return out


def _emulate_bwd(dy, s32, mu, rstd, gamma, ds, h, dtype):
    """(dx in ``dtype``, dgamma, dbeta) in the kernel's order of f32 adds:
    dy, s32, ds [n, h] f32 (s32 the kernel's s: the saved s, or x + r in
    f32), mu, rstd [n], gamma [h] f32."""
    n = dy.shape[0]
    plan = kln.bwd_plan(n, h, dtype)
    xhat = (s32 - mu[:, None]) * rstd[:, None]
    dxh = dy * gamma
    # a row's two sums: each lane over its columns, then the butterfly
    lanes = _lane_columns(h, dtype)
    p1 = torch.zeros(n, 32)
    p2 = torch.zeros(n, 32)
    for lane, cols in lanes.items():
        if cols:
            p1[:, lane] = _seq_sum([dxh[:, c] for c in cols])
            p2[:, lane] = _seq_sum([dxh[:, c] * xhat[:, c] for c in cols])
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        p1 = p1 + p1[:, idx ^ o]
        p2 = p2 + p2[:, idx ^ o]
    m1, m2 = p1[:, :1] / h, p2[:, :1] / h
    dx = rstd[:, None] * (dxh - m1 - xhat * m2)
    if ds is not None:
        dx = dx + ds
    # dgamma/dbeta: each warp over its rows in order, the block's warps in
    # order, then the partial rows: 16 runs i, i + 16, ... and those in order
    prod = dy * xhat
    parts = []
    for b in range(plan.blocks):
        warps = []
        for w in range(4):
            acc_g, acc_b = torch.zeros(h), torch.zeros(h)
            for r in _warp_rows(n, plan.blocks)[4 * b + w]:
                acc_g = acc_g + prod[r]
                acc_b = acc_b + dy[r]
            warps.append((acc_g, acc_b))
        parts.append((_seq_sum([g for g, _ in warps]),
                      _seq_sum([bb for _, bb in warps])))
    runs = [(_seq_sum([parts[i][0] for i in range(t, plan.blocks, 16)]),
             _seq_sum([parts[i][1] for i in range(t, plan.blocks, 16)]))
            for t in range(min(16, plan.blocks))]
    dg = _seq_sum([g for g, _ in runs])
    db = _seq_sum([bb for _, bb in runs])
    return dx.to(dtype), dg, db


def _inputs(n, h, dtype, seed):
    rng = np.random.default_rng(seed)
    jdt = _DT[dtype][0]
    rnd = lambda a: np.asarray(  # noqa: E731
        jnp.asarray(a, jdt).astype(jnp.float32))
    x = rnd(rng.standard_normal((n, h)) * 2 + 0.5)
    r = rnd(rng.standard_normal((n, h)))
    dy = rnd(rng.standard_normal((n, h)))
    ds = rnd(rng.standard_normal((n, h)))
    g = rnd(rng.standard_normal(h) * 0.1 + 1.0)
    b = rnd(rng.standard_normal(h) * 0.1)
    return x, r, dy, ds, g, b


def _close(got, want, dtype, what, whole=False):
    """Within the dtype's bar; bf16 of max(1, |want|) elementwise, and with
    ``whole`` (a sum over rows) of max(1, max |want|)."""
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    if whole:
        err = err / max(1.0, float(np.abs(want).max()))
    elif dtype == "bfloat16":
        err = err / np.maximum(1.0, np.abs(want))
    bar = 1e-5 if dtype == "float32" else 1e-2
    assert err.max() <= bar, (what, float(err.max()))


# n = 4352 rows is four rows for most warps of a 264-block grid and five
# for 128 of them: the emulation walks multi-row warps and every block
@pytest.mark.parametrize("h", [100, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["sum", "y"])
def test_emulated_order_matches_pallas(variant, dtype, h):
    n, br = 4352, 256
    x, r, dy, ds, g, b = _inputs(n, h, dtype, seed=h)
    j = lambda a: jnp.asarray(a, _DT[dtype][0])  # noqa: E731
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    if variant == "sum":
        _, s, mu, rstd = pallas_ln._fwd_call(j(x), j(r), j(g), j(b), 1e-5,
                                             br, True)
        want = pallas_ln._bwd_call(j(dy), j(ds), s, mu, rstd, j(g), br,
                                   True)
        s32, ds32 = t(np.asarray(jnp.asarray(s, jnp.float32))), t(ds)
    else:
        _, mu, rstd = pallas_ln._fwd_call_y(j(x), j(r), j(g), j(b), 1e-5,
                                            br, True)
        want = pallas_ln._bwd_call_y(j(dy), j(x), j(r), mu, rstd, j(g), br,
                                     True)
        s32, ds32 = t(x) + t(r), None
    mu32 = t(np.asarray(mu)[:, 0])
    rstd32 = t(np.asarray(rstd)[:, 0])
    dx, dg, db = _emulate_bwd(t(dy), s32, mu32, rstd32, t(g), ds32, h,
                              _DT[dtype][1])
    _close(dx, want[0], dtype, "dx")
    xhat = (s32.double() - mu32.double()[:, None]) * rstd32.double()[:, None]
    exact = ((t(dy).double() * xhat).sum(0), t(dy).double().sum(0))
    for name, got, ref, f64 in (("dgamma", dg, want[1][0], exact[0]),
                                ("dbeta", db, want[2][0], exact[1])):
        _close(got, ref, dtype, name, whole=True)
        ref64 = torch.from_numpy(np.asarray(ref, np.float64))
        assert (got.double() - f64).abs().max() <= \
            2 * (ref64 - f64).abs().max(), name


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_cuda_branch_checks_raise(monkeypatch):
    """Both backwards raise on a dtype, width, shape, layout, gamma or row
    statistics the kernel does not take, before any build; a well-formed
    call reaches the build only then."""
    def no_build(name, *args):
        raise AssertionError(f"reached the kernel build ({name})")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(kln, "_on_cuda", lambda fn, t: None)
    n, h = 8, 64
    rows, g = _meta(n, h), _meta(h)
    mu = _meta(n, dtype=torch.float32)
    wide = _meta(n, kln.MAX_H + 8)
    bad = [
        ((_meta(n, h, dtype=torch.float64),) * 3, g, mu, TypeError, "dtype"),
        ((wide, wide, wide), _meta(kln.MAX_H + 8), mu, ValueError, "wider"),
        ((rows, _meta(n + 1, h), rows), g, mu, ValueError, "does not match"),
        ((rows, rows, _meta(n, h, dtype=torch.float32)), g, mu, ValueError,
         "does not match"),
        ((rows, _meta(h, n).t(), rows), g, mu, ValueError, "contiguous"),
        ((_meta(n * h), _meta(n * h), _meta(n * h)), _meta(n * h), mu,
         ValueError, r"\[N, H\]"),
        ((rows, rows, rows), _meta(h + 1), mu, ValueError, "gamma"),
        ((rows, rows, rows), _meta(h, dtype=torch.float16), mu, ValueError,
         "gamma"),
        ((rows, rows, rows), g, _meta(n, dtype=torch.bfloat16), ValueError,
         "mu"),
        ((rows, rows, rows), g, _meta(n + 1, dtype=torch.float32),
         ValueError, "mu"),
    ]
    for fn in (kln.fused_add_layer_norm_bwd, kln.fused_add_layer_norm_y_bwd):
        for (a, b_, c), gamma, stats, exc, match in bad:
            with pytest.raises(exc, match=match):
                fn(a, b_, c, stats, stats, gamma)
        with pytest.raises(AssertionError, match="reached the kernel build"):
            fn(rows, rows, rows, mu, mu, g)


def test_off_cpu_without_kernel_raises(monkeypatch):
    """A tensor on neither the CPU nor CUDA never reaches the twin or the
    build."""
    def no_build(name, *args):
        raise AssertionError(f"reached the kernel build ({name})")
    monkeypatch.setattr(_build, "load", no_build)
    rows, mu = _meta(8, 64), _meta(8, dtype=torch.float32)
    for fn in (kln.fused_add_layer_norm_bwd, kln.fused_add_layer_norm_y_bwd):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(rows, rows, rows, mu, mu, _meta(64))
