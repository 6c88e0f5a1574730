"""Fused residual-add + LayerNorm: the CUDA kernels' wrappers, their plain
twins and the two autograd functions that join them.

Counterpart of ``paddle_tpu/ops/pallas/fused_ln.py`` (``_fwd_call``,
``_bwd_call``, ``_fwd_call_y``, ``_bwd_call_y`` and the two ``custom_vjp``
functions around them). The wrappers take the kernels' ``[N, H]`` rows;
the autograd functions take ``[..., H]`` and fold.

- ``fused_add_layer_norm_fwd`` -> (y, s, mu, rstd) and
  ``fused_add_layer_norm_bwd`` -> (dx, dgamma, dbeta): s = x + res and
  y = LayerNorm(s) * gamma + beta, and their backward from (dy, ds) and
  the saved s.
- ``fused_add_layer_norm_y_fwd`` -> (y, mu, rstd) and
  ``fused_add_layer_norm_y_bwd`` -> (dx, dgamma, dbeta): the same without
  writing s (post-LN blocks discard it); the backward re-adds x + res.
- ``*_plain`` — each one's twin in plain PyTorch.
- ``fused_add_layer_norm(x, res, gamma, beta, eps) -> (y, s)`` and
  ``fused_add_layer_norm_y(...) -> y`` — the differentiable entries; dx
  goes to both x and res, dgamma and dbeta come back in their parameters'
  dtypes.

A CPU tensor runs the twin; a CUDA tensor launches ``csrc/fused_ln.cu`` or
raises (an unsupported dtype, width or layout, or a failed build or
launch): there is no third branch. The rows are f32, bf16 or float16
(one dtype a call), gamma and beta f32 or the rows' dtype. Each wrapper
counts its launches in ``<wrapper>.launches``.

Rounding, as the Pallas bodies: everything is computed in f32 from the
inputs; y, s and dx are rounded to the input dtype where they are stored
(in float16 a value past 65504 becomes inf, as the reference's astype
makes it); the #7 backward reads s back rounded, while #9 recomputes it
in f32 from x and res. mu and rstd are [N] f32 (the TPU's 128-lane replication is
dropped); dgamma and dbeta are f32 sums over the rows.

Kernel note (details in the .cu): bound by bytes, every element read and
written once, one warp a row of up to 1024 values; a wider row (up to
``MAX_H`` = 8192) is cut into W = ceil(H / 512) slices, one warp a slice
(``row_split``), its sums added over the W warps in warp order. The
forward holds a warp's values in registers; the backward moves them in
16-byte chunks through two shared-memory stages a warp (the next row in
flight while this one is worked on), in one wave of resident blocks
(``bwd_plan``); dgamma/dbeta through per-block partial rows and a
fixed-order column sum, so a run repeats bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

__all__ = ["MAX_H", "RowSplit", "row_split", "BwdPlan", "bwd_plan",
           "bwd_residency",
           "fused_add_layer_norm_fwd", "fused_add_layer_norm_bwd",
           "fused_add_layer_norm_y_fwd", "fused_add_layer_norm_y_bwd",
           "fused_add_layer_norm_fwd_plain", "fused_add_layer_norm_bwd_plain",
           "fused_add_layer_norm_y_fwd_plain",
           "fused_add_layer_norm_y_bwd_plain", "fused_add_layer_norm",
           "fused_add_layer_norm_y"]

MAX_H = 8192  # the widest row: 16 warps of 512 values (kWideMaxH)
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# the C entries' dtype codes (kF32, kBF16, kF16)
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_WARPS = 4               # rows a block works on at once (kWarps in the .cu)
# rows wider than 1024 values (kWarpRow, kWideSlice, kWideWarps)
_WARP_ROW = 1024         # rows up to this run one warp a row
_WIDE_SLICE = 512        # the widest slice a warp takes
_WIDE_WARPS = 16         # warps a block (a thread: 128 registers at most)
_REGS = 65536            # registers an SM
# the backward's launch (csrc/fused_ln.cu: kBwdMinBlocks, kChunk, Bwd<T, C>)
_SMS = 132               # H100 SXM
_BWD_MIN_BLOCKS = 4      # __launch_bounds__(128, 4): 128 registers a thread
_BWD_GRID_PER_SM = 2     # blocks an SM the grid aims at (of those resident)
_CHUNK = 16              # bytes a lane moves a load
_CHUNK_COUNTS = (1, 2, 3, 4, 6, 8)   # chunks a lane, as instantiated
_SMEM_PER_SM = 233472    # 228 KB of shared memory an SM
_SMEM_RESERVED = 1024    # ... of which the runtime keeps 1 KB a block
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
# x, r, gamma, beta, y, s, mu, rstd; n; h; eps; the rows' dtype code;
# gamma/beta's; stream
_FWD_ARGTYPES = [_P] * 8 + [_L, _I, _F, _I, _I, _P]
# dy, ds, a, b, mu, rstd, gamma, dx, part_g, part_b, dg, db; n; h; blocks;
# the rows' dtype code; gamma's; stream
_BWD_ARGTYPES = [_P] * 12 + [_L, _I, _I, _I, _I, _P]
# h; the rows' dtype code; with_sum; out (4 ints)
_RESIDENCY_ARGTYPES = [_I, _I, _I, _P]


# -- the plain twins ----------------------------------------------------------

def _stats(s32, eps):
    mu = s32.mean(-1)
    var = (s32 - mu[:, None]).square().mean(-1)
    return mu, torch.rsqrt(var + eps)


def _fwd_plain(x, res, gamma, beta, eps):
    s32 = x.float() + res.float()
    mu, rstd = _stats(s32, eps)
    y = (s32 - mu[:, None]) * rstd[:, None] * gamma.float() + beta.float()
    return y.to(x.dtype), s32, mu, rstd


def fused_add_layer_norm_fwd_plain(x, res, gamma, beta, eps=1e-5):
    """[N, H] -> (y, s in x's dtype, mu, rstd [N] f32)."""
    y, s32, mu, rstd = _fwd_plain(x, res, gamma, beta, eps)
    return y, s32.to(x.dtype), mu, rstd


def fused_add_layer_norm_y_fwd_plain(x, res, gamma, beta, eps=1e-5):
    """[N, H] -> (y in x's dtype, mu, rstd [N] f32); s is not returned."""
    y, _, mu, rstd = _fwd_plain(x, res, gamma, beta, eps)
    return y, mu, rstd


def _bwd_plain(dy, s32, mu, rstd, gamma):
    """(dx in f32 without ds, dgamma, dbeta in f32) from the f32 sum."""
    dy32 = dy.float()
    xhat = (s32 - mu[:, None]) * rstd[:, None]
    dxhat = dy32 * gamma.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = rstd[:, None] * (dxhat - m1 - xhat * m2)
    return dx, (dy32 * xhat).sum(0), dy32.sum(0)


def fused_add_layer_norm_bwd_plain(dy, ds, s, mu, rstd, gamma):
    """#7's twin: dx = LN backward of dy (from the saved, rounded s) + ds,
    in dy's dtype; dgamma, dbeta [H] f32."""
    dx, dg, db = _bwd_plain(dy, s.float(), mu, rstd, gamma)
    return (dx + ds.float()).to(dy.dtype), dg, db


def fused_add_layer_norm_y_bwd_plain(dy, x, res, mu, rstd, gamma):
    """#9's twin: the LN backward with s = x + res recomputed in f32."""
    dx, dg, db = _bwd_plain(dy, x.float() + res.float(), mu, rstd, gamma)
    return dx.to(dy.dtype), dg, db


# -- the launch plans ---------------------------------------------------------

class RowSplit(NamedTuple):
    """How the kernels cut [*, h] rows: ``warps`` warps a row, ``rows``
    rows a block (of ``warps * rows`` warps) and ``slice`` values a warp.
    Warp w of a row takes its values w * slice up to (w + 1) * slice (the
    last warp up to h); the row's sums are added over its warps in warp
    order."""
    warps: int
    rows: int
    slice: int


def row_split(h, dtype):
    """One warp a row of up to 1024 values, four rows a block; a wider row
    W = ceil(h / 512) warps (3-16) of ceil(h / W) values rounded up to a
    16-byte chunk, 16 // W rows a block of 16 warps (the 16 - W R left
    over take no row). A function of (h, dtype) alone: the forward's and
    the backward's (csrc/fused_ln.cu: wide_geometry)."""
    if h < 1 or h > MAX_H:
        raise ValueError(f"row_split: no split for rows of {h} values")
    if h <= _WARP_ROW:
        return RowSplit(1, _WARPS, h)
    per = _CHUNK // dtype.itemsize                 # values a chunk
    warps = -(-h // _WIDE_SLICE)
    share = -(-h // warps)
    return RowSplit(warps, _WIDE_WARPS // warps, -(-share // per) * per)


class BwdPlan(NamedTuple):
    """How the backward (#7, #9) runs [n, h] rows: ``chunks`` 16-byte
    chunks a lane (lane l owns chunks l + 32 j of its warp's slice of a
    row), ``smem`` bytes of shared memory a block, ``blocks_per_sm``
    blocks resident an SM, and a grid of ``blocks`` blocks of R rows
    (``row_split``); row group g of block b takes rows b * R + g, then
    every R * blocks rows on. The partial rows of dgamma/dbeta are
    [2, blocks, h] f32."""
    chunks: int
    smem: int
    blocks_per_sm: int
    blocks: int


def bwd_plan(n, h, dtype):
    """The backward's launch plan: a function of (n, h, dtype) alone, so
    the partial rows, and with them dgamma/dbeta, repeat bit for bit. The
    grid is one wave: two blocks an SM of the card's 132, where up to four
    reside (registers held to 128 a thread; shared memory: gamma in f32
    and, per warp, two stages of three row tensors). Two run 3-11 % faster
    than four on the H100 at both slice shapes, and sum half the partial
    rows.

    A row wider than 1024 values runs on ``row_split``'s W warps, each
    with the chunks (2 bf16 or f16, 4 f32: room for 512 values), ring and
    accumulators of a 512-value row, in blocks of 16 warps that keep
    gamma's W slices, the W * R rings and the row sums' exchange in
    shared memory. At 128 registers a thread or fewer (and more than 64)
    one such block resides an SM; the grid is one an SM."""
    if n < 1 or h < 1 or h > MAX_H:
        raise ValueError(f"bwd_plan: no plan for [{n}, {h}] rows")
    per = _CHUNK // dtype.itemsize                 # values a chunk
    split = row_split(h, dtype)
    if split.warps == 1:
        nch = -(-h // per)                                  # chunks a row
        chunks = next(c for c in _CHUNK_COUNTS if 32 * c >= nch)
    else:
        chunks = _WIDE_SLICE // (32 * per)    # a slice of up to 512 values
    row = chunks * 32 * _CHUNK
    gamma = 32 * chunks * per * 4
    if split.warps == 1:
        smem = gamma + _WARPS * 2 * 3 * row
        per_sm = min(_BWD_MIN_BLOCKS,
                     _SMEM_PER_SM // (smem + _SMEM_RESERVED))
    else:
        smem = (split.warps * gamma + split.warps * split.rows * 2 * 3 * row
                + 2 * _WIDE_WARPS * 8)
        per_sm = min(_REGS // (128 * 32 * _WIDE_WARPS),
                     _SMEM_PER_SM // (smem + _SMEM_RESERVED))
    grid = _SMS * min(_BWD_GRID_PER_SM, per_sm)
    return BwdPlan(chunks, smem, per_sm,
                   min(-(-n // split.rows), grid))


# -- the CUDA side ------------------------------------------------------------

def _on_cuda(fn, t):
    if t.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {t.device}")


def _check(fn, rows, gamma, beta=None):
    """Raise on anything the kernels do not take. ``rows``: (name, tensor)
    pairs of one [N, H] shape and dtype."""
    first = rows[0][1]
    _on_cuda(fn, first)
    if first.dtype not in _DTYPES:
        raise TypeError(f"{fn}: dtype {first.dtype} not in {_DTYPES}")
    if first.dim() != 2 or first.shape[0] < 1 or first.shape[1] < 1:
        raise ValueError(f"{fn}: rows must be a non-empty [N, H] tensor, got "
                         f"{tuple(first.shape)}")
    h = first.shape[1]
    if h > MAX_H:
        raise ValueError(f"{fn}: H = {h} is wider than the kernels take "
                         f"({MAX_H}); wider rows are still to port "
                         "(ROADMAP.md, queue 2)")
    for name, t in rows:
        if t.device != first.device or t.dtype != first.dtype \
                or t.shape != first.shape:
            raise ValueError(f"{fn}: {name} {t.dtype} {tuple(t.shape)} on "
                             f"{t.device} does not match {rows[0][0]} "
                             f"{first.dtype} {tuple(first.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t is None:
            continue
        if t.device != first.device or t.shape != (h,) \
                or t.dtype not in (torch.float32, first.dtype) \
                or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous [{h}] "
                             f"float32 or {first.dtype} tensor on "
                             f"{first.device}")
    if beta is not None and beta.dtype != gamma.dtype:
        raise TypeError(f"{fn}: beta is {beta.dtype}, gamma {gamma.dtype}")


def _stats_for(fn, mu, rstd, x):
    n = x.shape[0]
    for name, t in (("mu", mu), ("rstd", rstd)):
        if (t.device != x.device or t.dtype != torch.float32
                or t.shape != (n,) or not t.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be a contiguous [{n}] "
                             f"float32 tensor on {x.device}")


def _launch(fn, symbol, argtypes, x, *args):
    from .. import _build
    entry = _build.load("fused_ln", argtypes, symbol)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = entry(*args, stream)
    if err:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err}")
    fn.launches += 1


def _fwd_cuda(fn, x, res, gamma, beta, eps, with_sum):
    _check(fn.__name__, (("x", x), ("res", res)), gamma, beta)
    n, h = x.shape
    y = torch.empty_like(x)
    s = torch.empty_like(x) if with_sum else None
    mu = torch.empty(n, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mu)
    _launch(fn, "fused_ln_fwd", _FWD_ARGTYPES, x, x.data_ptr(),
            res.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            None if s is None else s.data_ptr(), mu.data_ptr(),
            rstd.data_ptr(), n, h, float(eps), _CODES[x.dtype],
            _CODES[gamma.dtype])
    return y, s, mu, rstd


def _bwd_cuda(fn, dy, ds, a, b, mu, rstd, gamma):
    rows = [("dy", dy), ("ds", ds) if ds is not None else ("res", b),
            ("s", a) if ds is not None else ("x", a)]
    _check(fn.__name__, rows, gamma)
    _stats_for(fn.__name__, mu, rstd, dy)
    n, h = dy.shape
    blocks = bwd_plan(n, h, dy.dtype).blocks
    dx = torch.empty_like(dy)
    part = torch.empty(2, blocks, h, dtype=torch.float32, device=dy.device)
    dgb = torch.empty(2, h, dtype=torch.float32, device=dy.device)
    _launch(fn, "fused_ln_bwd", _BWD_ARGTYPES, dy, dy.data_ptr(),
            None if ds is None else ds.data_ptr(), a.data_ptr(),
            None if b is None else b.data_ptr(), mu.data_ptr(),
            rstd.data_ptr(), gamma.data_ptr(), dx.data_ptr(),
            part[0].data_ptr(), part[1].data_ptr(), dgb[0].data_ptr(),
            dgb[1].data_ptr(), n, h, blocks, _CODES[dy.dtype],
            _CODES[gamma.dtype])
    return dx, dgb[0], dgb[1]


def bwd_residency(h, dtype, with_sum, device="cuda"):
    """What the card makes of the backward's row kernel for [*, h] rows of
    ``dtype``, #7 (``with_sum``) or #9: {"blocks_per_sm"
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), "smem", "registers",
    "spill_bytes" (local memory a thread)}. Launches nothing."""
    from .. import _build
    entry = _build.load("fused_ln", _RESIDENCY_ARGTYPES,
                        "fused_ln_bwd_residency")
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(torch.device(device)):
        err = entry(h, _CODES[dtype], int(with_sum), out)
    if err:
        raise RuntimeError(f"bwd_residency: CUDA error {err}")
    return dict(zip(("blocks_per_sm", "smem", "registers", "spill_bytes"),
                    out))


def fused_add_layer_norm_fwd(x, res, gamma, beta, eps=1e-5):
    """#6 on [N, H] rows -> (y, s, mu, rstd). CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return fused_add_layer_norm_fwd_plain(x, res, gamma, beta, eps)
    return _fwd_cuda(fused_add_layer_norm_fwd, x, res, gamma, beta, eps,
                     True)


def fused_add_layer_norm_y_fwd(x, res, gamma, beta, eps=1e-5):
    """#8 on [N, H] rows -> (y, mu, rstd), no s written. CPU tensors run
    the plain version; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return fused_add_layer_norm_y_fwd_plain(x, res, gamma, beta, eps)
    y, _, mu, rstd = _fwd_cuda(fused_add_layer_norm_y_fwd, x, res, gamma,
                               beta, eps, False)
    return y, mu, rstd


def fused_add_layer_norm_bwd(dy, ds, s, mu, rstd, gamma):
    """#7 -> (dx, dgamma, dbeta f32). CPU tensors run the plain version;
    CUDA tensors launch the kernel (and its column sum) or raise."""
    if dy.device.type == "cpu":
        return fused_add_layer_norm_bwd_plain(dy, ds, s, mu, rstd, gamma)
    return _bwd_cuda(fused_add_layer_norm_bwd, dy, ds, s, None, mu, rstd,
                     gamma)


def fused_add_layer_norm_y_bwd(dy, x, res, mu, rstd, gamma):
    """#9 -> (dx, dgamma, dbeta f32). CPU tensors run the plain version;
    CUDA tensors launch the kernel (and its column sum) or raise."""
    if dy.device.type == "cpu":
        return fused_add_layer_norm_y_bwd_plain(dy, x, res, mu, rstd, gamma)
    return _bwd_cuda(fused_add_layer_norm_y_bwd, dy, None, x, res, mu, rstd,
                     gamma)


fused_add_layer_norm_fwd.launches = 0
fused_add_layer_norm_bwd.launches = 0
fused_add_layer_norm_y_fwd.launches = 0
fused_add_layer_norm_y_bwd.launches = 0


# -- the differentiable entries -----------------------------------------------

def _rows(t, h):
    return t.contiguous().view(-1, h)


class _FusedAddLayerNorm(torch.autograd.Function):
    """Counterpart of ``fused_add_layer_norm``'s custom_vjp: saves the
    rounded s, mu, rstd and gamma."""

    @staticmethod
    def forward(ctx, x, res, gamma, beta, eps):
        h = x.shape[-1]
        y, s, mu, rstd = fused_add_layer_norm_fwd(_rows(x, h), _rows(res, h),
                                                  gamma, beta, eps)
        ctx.save_for_backward(s, mu, rstd, gamma)
        ctx.beta_dtype = beta.dtype
        return y.view(x.shape), s.view(x.shape)

    @staticmethod
    def backward(ctx, dy, ds):
        s, mu, rstd, gamma = ctx.saved_tensors
        h = s.shape[-1]
        dx, dg, db = fused_add_layer_norm_bwd(_rows(dy, h), _rows(ds, h), s,
                                              mu, rstd, gamma)
        dx = dx.view(dy.shape)
        return dx, dx, dg.to(gamma.dtype), db.to(ctx.beta_dtype), None


class _FusedAddLayerNormY(torch.autograd.Function):
    """Counterpart of ``fused_add_layer_norm_y``'s custom_vjp: saves x,
    res, mu, rstd and gamma, and re-adds x + res in the backward."""

    @staticmethod
    def forward(ctx, x, res, gamma, beta, eps):
        h = x.shape[-1]
        x2, r2 = _rows(x, h), _rows(res, h)
        y, mu, rstd = fused_add_layer_norm_y_fwd(x2, r2, gamma, beta, eps)
        ctx.save_for_backward(x2, r2, mu, rstd, gamma)
        ctx.beta_dtype = beta.dtype
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, r2, mu, rstd, gamma = ctx.saved_tensors
        dx, dg, db = fused_add_layer_norm_y_bwd(_rows(dy, x2.shape[1]), x2, r2,
                                                mu, rstd, gamma)
        dx = dx.view(dy.shape)
        return dx, dx, dg.to(gamma.dtype), db.to(ctx.beta_dtype), None


def fused_add_layer_norm(x, res, gamma, beta, eps=1e-5):
    """(y, s): y = LayerNorm(x + res) * gamma + beta, s = x + res (in x's
    dtype). x, res [..., H]; gamma, beta [H]. Both outputs
    differentiable."""
    return _FusedAddLayerNorm.apply(x, res, gamma, beta, float(eps))


def fused_add_layer_norm_y(x, res, gamma, beta, eps=1e-5):
    """y = LayerNorm(x + res) * gamma + beta, without materialising the
    sum; the backward recomputes it from x and res."""
    return _FusedAddLayerNormY.apply(x, res, gamma, beta, float(eps))
