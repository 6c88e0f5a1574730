"""The fused residual-add + LayerNorm kernels (#6-#9) on rows wider than
1024 values, on the CPU.

A wide row of h values runs on W = ceil(h / 512) warps, warp w on the
values w * slice up to (w + 1) * slice (``row_split``), in blocks of 16
warps that hold R = 16 // W rows; the row's sums are each warp's
butterfly sum added over the W warps in warp order. Here:

- the four plain twins are held against the Pallas ``_fwd_call``,
  ``_bwd_call``, ``_fwd_call_y`` and ``_bwd_call_y`` in interpret mode at
  H in {2048, 3000, 8192}, N = 16, f32 and bf16 (``block_rows=8`` where
  ``_pick_block_rows`` finds no divisor): y, s and dx within 1e-5 (f32) or
  1e-2 of max(1, |ref|) (bf16); mu and rstd within 1e-5 (rstd of its
  size); dgamma and dbeta, sums over the rows, within 1e-5 / 1e-2 of
  max(1, the largest |ref|);
- the wide plan visits every row and every column once, in one wave, as
  a function of (n, h, dtype), within an H100 block's 232,448 bytes of
  shared memory;
- an f32 emulation of the wide kernels' order of adds (a lane's values in
  order, the warp's butterfly, the W warps in warp order; dgamma/dbeta
  over a row group's rows, the R groups in order, the partial rows by the
  column sum's 16 strided runs) holds against the Pallas kernels: the
  forward's y, mu and rstd and the backward's dx within the bars above,
  dgamma/dbeta within them and no worse than twice the Pallas order's
  error against the float64 sum (the reason is test_torch_ln_plan.py's);
- the CUDA branch takes H = 8192 and raises at MAX_H + 8, naming ROADMAP
  queue 2, before any build (the meta device stands in for the card).
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


def _inputs(n, h, dtype, seed):
    """x, r, dy, ds, gamma, beta as numpy f32, rounded to ``dtype``."""
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


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, dtype, what, whole=False, rel=False):
    """Within the dtype's bar; bf16 of max(1, |want|) elementwise, with
    ``whole`` (a sum over rows) of max(1, max |want|), with ``rel`` of
    |want|."""
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    if rel:
        err = err / np.abs(want)
    elif whole:
        err = err / max(1.0, float(np.abs(want).max()))
    elif dtype == "bfloat16":
        err = err / np.maximum(1.0, np.abs(want))
    bar = 1e-5 if dtype == "float32" or rel else 1e-2
    assert err.max() <= bar, (what, float(err.max()))


def _block_rows(n, h):
    return pallas_ln._pick_block_rows(n, h) or 8


def _pallas(variant, x, r, dy, ds, g, b, dtype, eps=1e-5):
    """The Pallas forward and backward (interpret mode): (y, s or None,
    mu [n], rstd [n]) and (dx, dgamma, dbeta)."""
    n, h = x.shape
    br = _block_rows(n, h)
    j = lambda a: jnp.asarray(a, _DT[dtype][0])  # noqa: E731
    if variant == "sum":
        y, s, mu, rstd = pallas_ln._fwd_call(j(x), j(r), j(g), j(b), eps, br,
                                             True)
        bwd = pallas_ln._bwd_call(j(dy), j(ds), s, mu, rstd, j(g), br, True)
    else:
        y, mu, rstd = pallas_ln._fwd_call_y(j(x), j(r), j(g), j(b), eps, br,
                                            True)
        s = None
        bwd = pallas_ln._bwd_call_y(j(dy), j(x), j(r), mu, rstd, j(g), br,
                                    True)
    mu, rstd = np.asarray(mu)[:, 0], np.asarray(rstd)[:, 0]
    return (y, s, mu, rstd), (bwd[0], bwd[1][0], bwd[2][0])


# -- the twins at wide rows ---------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [2048, 3000, 8192])
@pytest.mark.parametrize("variant", ["sum", "y"])
def test_twins_match_pallas(variant, h, dtype):
    n = 16
    if h == 3000:
        assert pallas_ln._pick_block_rows(n, h) == 0
    x, r, dy, ds, g, b = _inputs(n, h, dtype, seed=h)
    (y, s, mu, rstd), (dx, dg, db) = _pallas(variant, x, r, dy, ds, g, b,
                                             dtype)
    tdt = _DT[dtype][1]
    t = lambda a: torch.from_numpy(np.array(a)).to(tdt)  # noqa: E731
    if variant == "sum":
        py, ps, pmu, prstd = kln.fused_add_layer_norm_fwd(
            t(x), t(r), t(g), t(b), 1e-5)
        _close(ps, s, dtype, "s")
        pdx, pdg, pdb = kln.fused_add_layer_norm_bwd(t(dy), t(ds), ps, pmu,
                                                     prstd, t(g))
    else:
        py, pmu, prstd = kln.fused_add_layer_norm_y_fwd(t(x), t(r), t(g),
                                                        t(b), 1e-5)
        pdx, pdg, pdb = kln.fused_add_layer_norm_y_bwd(t(dy), t(x), t(r),
                                                       pmu, prstd, t(g))
    assert py.dtype == pdx.dtype == tdt
    _close(py, y, dtype, "y")
    _close(pmu, mu, "float32", "mu")
    _close(prstd, rstd, dtype, "rstd", rel=True)
    _close(pdx, dx, dtype, "dx")
    _close(pdg, dg, dtype, "dgamma", whole=True)
    _close(pdb, db, dtype, "dbeta", whole=True)


# -- the wide plan ------------------------------------------------------------

def _group_rows(n, h, dtype):
    """{(block, row group): its rows in the order it visits them}."""
    plan, split = kln.bwd_plan(n, h, dtype), kln.row_split(h, dtype)
    stride = plan.blocks * split.rows
    return {(b, g): list(range(b * split.rows + g, n, stride))
            for b in range(plan.blocks) for g in range(split.rows)}


def _lane_columns(h, dtype):
    """{(warp, lane): its columns of a row in the order it adds them}: the
    backward's chunks (lane l of warp w: chunks l + 32 j of w's slice)."""
    split = kln.row_split(h, dtype)
    per = 16 // (2 if dtype == torch.bfloat16 else 4)
    chunks = kln.bwd_plan(1, h, dtype).chunks
    out = {}
    for w in range(split.warps):
        lo = w * split.slice
        width = min(split.slice, h - lo)
        for lane in range(32):
            out[w, lane] = [lo + k * per + e for j in range(chunks)
                            for k in [lane + 32 * j]
                            for e in range(per) if k * per + e < width]
    return out


_WIDE = [1025, 1536, 2048, 2056, 3000, 4096, 4608, 7000, 8192]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h", _WIDE)
@pytest.mark.parametrize("n", [1, 7, 4095, 4097, 16384])
def test_wide_plan_visits_every_row_and_column_once(n, h, dtype):
    plan, split = kln.bwd_plan(n, h, dtype), kln.row_split(h, dtype)
    assert plan == kln.bwd_plan(n, h, dtype)
    assert split == kln.row_split(h, dtype)
    assert split.warps == -(-h // 512) and split.warps * split.rows <= 16
    # one wave: one block an SM, within a block's shared memory
    assert plan.blocks_per_sm == 1
    assert 1 <= plan.blocks <= _SMS * plan.blocks_per_sm
    assert plan.smem <= 232448
    assert plan.smem + 1024 <= 233472
    # the partial rows reuse the rings: R rows of 2 x W x 32 V floats
    per = 16 // (2 if dtype == torch.bfloat16 else 4)
    rings = split.warps * split.rows * 2 * 3 * plan.chunks * 32 * 16
    assert split.rows * 2 * split.warps * 32 * plan.chunks * per * 4 <= rings
    rows = _group_rows(n, h, dtype)
    assert sorted(r for v in rows.values() for r in v) == list(range(n))
    lens = [len(v) for v in rows.values()]
    assert max(lens) - min(lens) <= 1
    cols = _lane_columns(h, dtype)
    assert sorted(c for v in cols.values() for c in v) == list(range(h))
    # a slice's columns are one warp's, and every slice takes some
    assert all(cols[w, 0] for w in range(split.warps))


def test_wide_plan_at_the_path_shape():
    """GPT-1.3B's rows (4096 x 2048): four warps of 512 values a row, four
    rows a block, one block of 16 warps an SM, a grid of 132."""
    bf, f32 = torch.bfloat16, torch.float32
    assert kln.row_split(2048, bf) == (4, 4, 512)
    assert kln.bwd_plan(4096, 2048, bf) == (2, 106752, 1, 132)
    assert kln.bwd_plan(4096, 2048, f32) == (4, 205056, 1, 132)
    assert kln.row_split(8192, f32) == (16, 1, 512)
    assert kln.bwd_plan(7, 8192, f32) == (4, 229632, 1, 7)
    assert kln.row_split(3000, bf) == (6, 2, 504)
    assert kln.row_split(1024, bf) == (1, 4, 1024)
    for bad in ((8, kln.MAX_H + 1), (8, 0)):
        with pytest.raises(ValueError):
            kln.bwd_plan(*bad, bf)


# -- the wide kernels' order of adds ------------------------------------------

def _seq_sum(vals):
    out = vals[0].clone()
    for v in vals[1:]:
        out = out + v
    return out


def _butterfly(p):
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        p = p + p[:, idx ^ o]
    return p[:, 0]


def _row_sum(vals, split, h, per_lane):
    """A row sum in the kernels' order: [n, h] f32 values; each lane's
    ``per_lane[w, lane]`` columns in order, the warp's butterfly, the W
    warp sums in warp order."""
    n = vals.shape[0]
    warps = []
    for w in range(split.warps):
        p = torch.zeros(n, 32)
        for lane in range(32):
            cols = per_lane[w, lane]
            if cols:
                p[:, lane] = _seq_sum([vals[:, c] for c in cols])
        warps.append(_butterfly(p))
    return _seq_sum(warps)


def _fwd_columns(h, dtype):
    """The forward's lanes: lane l of warp w holds its slice's values
    l + 32 j, j < 16."""
    split = kln.row_split(h, dtype)
    out = {}
    for w in range(split.warps):
        lo = w * split.slice
        width = min(split.slice, h - lo)
        for lane in range(32):
            out[w, lane] = [lo + c for c in range(lane, width, 32)]
    return out


def _emulate_fwd(x, r, g, b, h, dtype, eps=1e-5):
    split = kln.row_split(h, dtype)
    s = x + r
    cols = _fwd_columns(h, dtype)
    mu = _row_sum(s, split, h, cols) / h
    d = s - mu[:, None]
    rstd = torch.rsqrt(_row_sum(d * d, split, h, cols) / h + eps)
    return d * rstd[:, None] * g + b, mu, rstd


def _emulate_bwd(dy, s32, mu, rstd, gamma, ds, h, dtype):
    n = dy.shape[0]
    plan, split = kln.bwd_plan(n, h, dtype), kln.row_split(h, dtype)
    cols = _lane_columns(h, dtype)
    xhat = (s32 - mu[:, None]) * rstd[:, None]
    dxh = dy * gamma
    m1 = _row_sum(dxh, split, h, cols)[:, None] / h
    m2 = _row_sum(dxh * xhat, split, h, cols)[:, None] / h
    dx = rstd[:, None] * (dxh - m1 - xhat * m2)
    if ds is not None:
        dx = dx + ds
    # dgamma/dbeta: each row group over its rows in order, a block's R
    # groups in order, then the column sum's 16 strided runs in order
    prod = dy * xhat
    rows = _group_rows(n, h, dtype)
    parts = []
    for blk in range(plan.blocks):
        groups = []
        for g in range(split.rows):
            acc_g, acc_b = torch.zeros(h), torch.zeros(h)
            for row in rows[blk, g]:
                acc_g = acc_g + prod[row]
                acc_b = acc_b + dy[row]
            groups.append((acc_g, acc_b))
        parts.append((_seq_sum([a for a, _ in groups]),
                      _seq_sum([a for _, a in groups])))
    runs = [(_seq_sum([parts[i][0] for i in range(t, plan.blocks, 16)]),
             _seq_sum([parts[i][1] for i in range(t, plan.blocks, 16)]))
            for t in range(min(16, plan.blocks))]
    return (dx.to(dtype), _seq_sum([a for a, _ in runs]),
            _seq_sum([a for _, a in runs]))


# rows enough that most row groups of the 132 blocks visit two or three
# rows (h 2048: R = 4; h 3000: R = 2); block_rows 8 for the Pallas grid
@pytest.mark.parametrize("h,n", [(2048, 1160), (3000, 600)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["sum", "y"])
def test_emulated_order_matches_pallas(variant, dtype, h, n):
    x, r, dy, ds, g, b = _inputs(n, h, dtype, seed=h + 1)
    (y, s, mu, rstd), want = _pallas(variant, x, r, dy, ds, g, b, dtype)
    tdt = _DT[dtype][1]
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    ey, emu, erstd = _emulate_fwd(t(x), t(r), t(g), t(b), h, tdt)
    _close(ey.to(tdt), y, dtype, "y")
    _close(emu, mu, "float32", "mu")
    _close(erstd, rstd, dtype, "rstd", rel=True)
    mu32, rstd32 = t(mu), t(rstd)
    if variant == "sum":
        s32, ds32 = t(_np(s)), t(ds)
    else:
        s32, ds32 = t(x) + t(r), None
    dx, dg, db = _emulate_bwd(t(dy), s32, mu32, rstd32, t(g), ds32, h, tdt)
    _close(dx, want[0], dtype, "dx")
    xhat = (s32.double() - mu32.double()[:, None]) * rstd32.double()[:, None]
    exact = ((t(dy).double() * xhat).sum(0), t(dy).double().sum(0))
    for name, got, ref, f64 in (("dgamma", dg, want[1], exact[0]),
                                ("dbeta", db, want[2], exact[1])):
        _close(got, ref, dtype, name, whole=True)
        ref64 = torch.from_numpy(np.asarray(ref, np.float64))
        assert (got.double() - f64).abs().max() <= \
            2 * (ref64 - f64).abs().max(), name


# -- the CUDA branch ----------------------------------------------------------

def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_cuda_branch_takes_the_widest_row_and_raises_past_it(monkeypatch):
    """H = MAX_H = 8192 passes every check and reaches the build; MAX_H + 8
    raises ValueError naming ROADMAP queue 2, before any build, in all four
    wrappers."""
    def no_build(name, *args):
        raise AssertionError(f"reached the kernel build ({name})")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(kln, "_on_cuda", lambda fn, t: None)
    assert kln.MAX_H == 8192
    n = 8
    mu = _meta(n, dtype=torch.float32)
    for h, outcome in ((kln.MAX_H, AssertionError),
                       (kln.MAX_H + 8, ValueError)):
        rows, g = _meta(n, h), _meta(h)
        match = "reached the kernel build" if outcome is AssertionError \
            else "queue 2"
        calls = (
            lambda: kln.fused_add_layer_norm_fwd(rows, rows, g, g),
            lambda: kln.fused_add_layer_norm_y_fwd(rows, rows, g, g),
            lambda: kln.fused_add_layer_norm_bwd(rows, rows, rows, mu, mu, g),
            lambda: kln.fused_add_layer_norm_y_bwd(rows, rows, rows, mu, mu,
                                                   g))
        for call in calls:
            with pytest.raises(outcome, match=match):
                call()
