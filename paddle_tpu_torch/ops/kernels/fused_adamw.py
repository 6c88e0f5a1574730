"""One-pass Adam/AdamW update: the CUDA kernel's wrappers and plain twins.

Counterpart of ``paddle_tpu/ops/pallas/fused_adamw.py``
(``fused_adamw_update`` / ``fused_adamw_supported``).

- ``fused_adamw_multi_update`` — the kernel's one entry, in place on a list
  of leaves (one leaf is a list of one): CPU tensors run
  ``adamw_multi_update_plain``; CUDA tensors launch ``csrc/fused_adamw.cu``
  once for every ``MAX_LEAVES`` leaves or raise. Its ``launches`` counts
  kernel launches and ``leaves`` the leaves they updated. The kernel reads
  the step's lr and bias corrections from a 3-value f32 array on the
  device (``step_scalars``), as the TPU kernel reads its SMEM operand, so a
  launch captured in a CUDA graph takes each replay's values. An optional
  device scalar ``scale`` multiplies every gradient inside the kernel (the
  global-norm clip's coefficient, times 1/n over an accumulated window,
  times a GradScaler's 1/scale). An optional device flag ``skip`` (one
  bool, the guarded step's found-inf) makes every block return without
  writing, so a skipped step leaves p, m and v as they were, bit for bit.
- ``adamw_update_plain`` / ``adamw_multi_update_plain`` — the same update
  in plain PyTorch, f32 throughout, written back in place, on host floats
  or on the device array alike: the optimizer's own math (``optimizer.Adam`` runs it for every leaf the
  kernel does not take, and on the CPU).
- ``fused_adamw_supported`` — the reference's per-leaf rule: f32 p, m and
  v of at least ``MIN_SIZE`` elements ("smaller leaves: kernel launch
  overhead > win" on the TPU, where a leaf is a launch). On the card a
  launch takes a whole leaf set, so the rule no longer decides a route
  there: every f32 leaf goes to the kernel, at any size. It stays as the
  reference's rule, which the tests read. The TPU's ``size % 4096`` rule
  belongs to Mosaic's tiling and is dropped.
- ``multi_plan`` — how a leaf set is cut: into launches of at most
  ``MAX_LEAVES`` leaves, each leaf into chunks of ``CHUNK`` values, one
  thread block a chunk (the prefix of chunks a launch carries).

Kernel note (details in the .cu): bound by bytes, 28 per value (read p, m,
v, g; write p, m, v) at 3.35 TB/s on the H100; one pass with 16-byte
vector accesses, the leaf table in the launch's parameter space.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = ["MIN_SIZE", "MAX_LEAVES", "CHUNK", "fused_adamw_supported",
           "fused_adamw_multi_update", "multi_plan", "step_scalars",
           "LeafTable", "adamw_update_plain", "adamw_multi_update_plain"]

MIN_SIZE = 1 << 14  # the reference's floor: smaller leaves stay plain there
# the kernel's launch geometry (csrc/fused_adamw.cu kMaxLeaves, kChunk;
# the wrapper checks the library agrees)
MAX_LEAVES = 512
CHUNK = 4096
# leaves; ptrs, n, wd, first_chunk (host arrays); [lr, bc1, bc2] (device);
# beta1, 1 - beta1, beta2, 1 - beta2, eps; decoupled; scale; skip; stream
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
    ctypes.c_float] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 3


def fused_adamw_supported(p, m, v):
    """The reference's rule for a leaf to go to its kernel: f32 p, m and v
    (a bf16 moment keeps the plain path) of at least MIN_SIZE elements."""
    return (p.dtype == torch.float32 and m.dtype == torch.float32
            and v.dtype == torch.float32 and p.numel() >= MIN_SIZE)


def step_scalars(lr, bc1=None, bc2=None, device="cpu"):
    """The f32 array [lr, bc1, bc2] that an update reads: ``lr`` itself
    when it is one (three f32 values; bc1 and bc2 then None), else a new
    one on ``device`` from three host floats (on CUDA a copy from the host,
    which waits for it: a step keeps its own array and fills it instead)."""
    if torch.is_tensor(lr):
        if bc1 is not None or bc2 is not None or lr.numel() != 3 \
                or lr.dtype != torch.float32:
            raise ValueError("step_scalars: a tensor lr is the f32 array "
                             "[lr, bc1, bc2] (bc1 and bc2 then None)")
        return lr
    return torch.tensor([float(lr), float(bc1), float(bc2)],
                        dtype=torch.float32, device=device)


@torch.no_grad()
def adamw_update_plain(p, m, v, g, lr, bc1, bc2, *, beta1, beta2, eps,
                       weight_decay, decoupled, skip=None):
    """One Adam (``decoupled=False``: L2 decay added to the gradient) or
    AdamW (decoupled decay) step in plain PyTorch, f32 math, written back
    into p, m and v in place (each keeps its dtype). lr, bc1 and bc2 are
    host floats or f32 scalar tensors on p's device (the same values give
    the same bits either way). ``skip``: None or a bool scalar tensor;
    where set, p, m and v keep their values (``torch.where``, as the
    reference masks its kernel's result). Returns (p, m, v)."""
    g32 = g.float()
    p32 = p.float()
    if weight_decay and not decoupled:
        g32 = g32 + weight_decay * p32
    m32 = beta1 * m.float() + (1.0 - beta1) * g32
    v32 = beta2 * v.float() + (1.0 - beta2) * g32 * g32
    step = lr * (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
    if weight_decay and decoupled:
        step = step + lr * weight_decay * p32
    p_new = p32 - step
    if skip is not None:
        p_new = torch.where(skip, p32, p_new)
        m32 = torch.where(skip, m.float(), m32)
        v32 = torch.where(skip, v.float(), v32)
    p.copy_(p_new)
    m.copy_(m32)
    v.copy_(v32)
    return p, m, v


@torch.no_grad()
def adamw_multi_update_plain(ps, ms, vs, gs, lr, bc1=None, bc2=None, *,
                             weight_decays, beta1, beta2, eps, decoupled,
                             scale=None, skip=None):
    """``adamw_update_plain`` over a list of leaves, leaf by leaf, each
    with its own weight decay. lr, bc1, bc2: host floats, or ``lr`` the
    device array [lr, bc1, bc2] as the kernel takes it (bc1, bc2 None);
    ``scale`` (an f32 scalar tensor or None) multiplies every gradient
    first, in f32, as the kernel does; ``skip`` (a bool scalar tensor or
    None) leaves every leaf as it was where set, as the kernel does."""
    if torch.is_tensor(lr):
        lr, bc1, bc2 = step_scalars(lr).unbind()
    for p, m, v, g, wd in zip(ps, ms, vs, gs, weight_decays):
        if scale is not None:
            g = g.float() * scale
        adamw_update_plain(p, m, v, g, lr, bc1, bc2, beta1=beta1,
                           beta2=beta2, eps=eps, weight_decay=wd,
                           decoupled=decoupled, skip=skip)


def multi_plan(sizes, max_leaves=MAX_LEAVES, chunk=CHUNK):
    """The launches of a leaf set of ``sizes`` values: a list of (first
    leaf, end leaf, first_chunk), one a launch of at most ``max_leaves``
    consecutive leaves, ``first_chunk`` the int32 prefix of their
    ceil(n / chunk) chunks from 0 (its last entry is the launch's grid).
    Shapes only: nothing is allocated or read on a device."""
    sizes = np.asarray(sizes, dtype=np.int64)
    if sizes.ndim != 1 or not len(sizes) or (sizes < 1).any():
        raise ValueError("multi_plan: every leaf needs at least one value")
    plan = []
    for lo in range(0, len(sizes), max_leaves):
        part = sizes[lo:lo + max_leaves]
        first = np.zeros(len(part) + 1, np.int64)
        np.cumsum(-(-part // chunk), out=first[1:])
        if first[-1] > np.iinfo(np.int32).max:
            raise ValueError(f"multi_plan: {first[-1]} chunks exceed a grid")
        plan.append((lo, lo + len(part), first.astype(np.int32)))
    return plan


class LeafTable:
    """A leaf set's launch table, built once and kept by its optimizer:
    the plan, and each launch's host arrays of pointers (p, m and v fixed,
    g written each step), lengths and weight decays. ``fits`` says whether
    it still describes the given p, m and v."""

    def __init__(self, ps, ms, vs, weight_decays):
        self.ms, self.vs = list(ms), list(vs)
        self.sizes = [p.numel() for p in ps]
        self.plan = multi_plan(self.sizes)
        self.p_ptrs = [p.data_ptr() for p in ps]
        self.launches = []
        for lo, hi, first in self.plan:
            ptrs = np.zeros((hi - lo, 4), np.int64)
            ptrs[:, 0] = self.p_ptrs[lo:hi]
            ptrs[:, 1] = [m.data_ptr() for m in ms[lo:hi]]
            ptrs[:, 2] = [v.data_ptr() for v in vs[lo:hi]]
            self.launches.append(dict(
                lo=lo, hi=hi, first=first, ptrs=ptrs,
                n=np.asarray(self.sizes[lo:hi], np.int64),
                wd=np.asarray(weight_decays[lo:hi], np.float32)))

    def fits(self, ps, ms, vs):
        return (len(ps) == len(self.sizes)
                and all(a is b for a, b in zip(ms, self.ms))
                and all(a is b for a, b in zip(vs, self.vs))
                and [p.data_ptr() for p in ps] == self.p_ptrs)


def _check(p, m, v):
    name = "fused_adamw_multi_update"
    for what, t in (("p", p), ("m", m), ("v", v)):
        if t.device != p.device:
            raise ValueError(f"{name}: {what} on {t.device}, p on {p.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {what} is {t.dtype}; the kernel takes "
                            "float32 only")
        if t.shape != p.shape:
            raise ValueError(f"{name}: {what} {tuple(t.shape)} is not "
                             f"shaped like p {tuple(p.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if p.numel() < 1:
        raise ValueError(f"{name}: empty leaf")


def _load():
    from .. import _build
    fn = _build.load("fused_adamw", _ARGTYPES, "fused_adamw_multi_update")
    if not _GEOMETRY:
        got = tuple(_build.load("fused_adamw", [], name)()
                    for name in ("fused_adamw_max_leaves",
                                 "fused_adamw_chunk"))
        if got != (MAX_LEAVES, CHUNK):
            raise RuntimeError(f"csrc/fused_adamw.cu plans (max leaves, "
                               f"chunk) = {got}, the wrapper "
                               f"{(MAX_LEAVES, CHUNK)}")
        _GEOMETRY.append(got)
    return fn


_GEOMETRY = []


def _check_grads(table, gs, device):
    for i, (g, n) in enumerate(zip(gs, table.sizes)):
        if g.dtype != torch.float32 or g.numel() != n or g.device != device:
            raise ValueError(
                f"fused_adamw_multi_update: gradient {i} is {g.dtype} of "
                f"{g.numel()} values on {g.device}; its leaf is float32 of "
                f"{n} on {device}")


@torch.no_grad()
def fused_adamw_multi_update(ps, ms, vs, gs, lr, bc1=None, bc2=None, *,
                             weight_decays, beta1, beta2, eps, decoupled,
                             scale=None, table=None, skip=None):
    """In-place one-pass update of every leaf of a list. ``lr``: the step's
    f32 array [lr, bc1, bc2] on the leaves' device, which the kernel reads
    (no host sync; what an optimizer passes), or this step's lr with bc1
    and bc2 as host floats (``step_scalars`` copies them over);
    ``weight_decays`` one float a leaf; ``scale`` None or an f32 scalar
    tensor on the leaves' device that multiplies every gradient (the
    clip's coefficient, read by the kernel: no host sync). CPU tensors run
    the plain version leaf by leaf; CUDA tensors launch the kernel,
    ceil(len(ps) / MAX_LEAVES) times, or raise. ``table``: a ``LeafTable``
    of these p, m and v (the optimizer keeps one; built here when None).
    ``skip``: None or a one-element bool tensor on the leaves' device (the
    guarded step's found-inf), read by the kernel: where set, no block
    writes. Returns the table."""
    if not ps:
        return table
    dev = ps[0].device
    kw = dict(beta1=beta1, beta2=beta2, eps=eps, decoupled=decoupled)
    if dev.type == "cpu":
        adamw_multi_update_plain(ps, ms, vs, gs, lr, bc1, bc2,
                                 weight_decays=weight_decays, scale=scale,
                                 skip=skip, **kw)
        return table
    hyper = step_scalars(lr, bc1, bc2, dev)
    if dev.type != "cuda":
        raise ValueError(f"fused_adamw_multi_update: unsupported device "
                         f"{dev}")
    if table is None:
        for p, m, v in zip(ps, ms, vs):
            _check(p, m, v)
        table = LeafTable(ps, ms, vs, weight_decays)
    # the kernel reads g flat: a channels-last convolution's weight
    # gradient comes back strided from cuDNN
    gs = [g.contiguous() for g in gs]
    _check_grads(table, gs, dev)
    if scale is not None and (scale.dtype != torch.float32
                              or scale.numel() != 1 or scale.device != dev):
        raise ValueError(f"fused_adamw_multi_update: scale must be one "
                         f"float32 value on {dev}")
    if skip is not None and (skip.dtype != torch.bool or skip.numel() != 1
                             or skip.device != dev):
        raise ValueError(f"fused_adamw_multi_update: skip must be one bool "
                         f"on {dev}")
    if hyper.device != dev or not hyper.is_contiguous():
        raise ValueError(f"fused_adamw_multi_update: [lr, bc1, bc2] must "
                         f"be contiguous on {dev}")
    fn = _load()
    scale_ptr = None if scale is None else scale.data_ptr()
    skip_ptr = None if skip is None else skip.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lt in table.launches:
            lt["ptrs"][:, 3] = [g.data_ptr() for g in gs[lt["lo"]:lt["hi"]]]
            err = fn(lt["hi"] - lt["lo"], lt["ptrs"].ctypes.data,
                     lt["n"].ctypes.data, lt["wd"].ctypes.data,
                     lt["first"].ctypes.data, hyper.data_ptr(), float(beta1),
                     1.0 - beta1, float(beta2), 1.0 - beta2, float(eps),
                     int(bool(decoupled)), scale_ptr, skip_ptr, stream)
            if err:
                raise RuntimeError(f"fused_adamw_multi_update kernel launch "
                                   f"failed: CUDA error {err}")
            fused_adamw_multi_update.launches += 1
            fused_adamw_multi_update.leaves += lt["hi"] - lt["lo"]
    return table


fused_adamw_multi_update.launches = 0
fused_adamw_multi_update.leaves = 0
