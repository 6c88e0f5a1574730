"""One-pass Adam/AdamW update: the CUDA kernel's wrapper and its plain twin.

Counterpart of ``paddle_tpu/ops/pallas/fused_adamw.py``
(``fused_adamw_update`` / ``fused_adamw_supported``).

- ``fused_adamw_update`` — the entry, in place on one leaf: a CPU tensor
  runs ``adamw_update_plain``; a CUDA tensor launches
  ``csrc/fused_adamw.cu`` or raises. ``fused_adamw_update.launches`` counts
  kernel launches.
- ``adamw_update_plain`` — the same update in plain PyTorch: the
  optimizer's own math (``optimizer.Adam`` runs it for every leaf the
  kernel does not take), f32 throughout, written back in place.
- ``fused_adamw_supported`` — the reference's per-leaf rule: f32 p, m and
  v of at least 16384 elements. The TPU's ``size % 4096`` rule belongs to
  Mosaic's tiling and is dropped: a CUDA grid covers any length.

Kernel note (details in the .cu): bound by bytes, 28 per element (read p,
m, v, g; write p, m, v) at 3.35 TB/s on the H100; one pass with 16-byte
vector accesses.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["MIN_SIZE", "fused_adamw_supported", "fused_adamw_update",
           "adamw_update_plain"]

MIN_SIZE = 1 << 14  # the reference's floor: smaller leaves stay plain
# p, m, v, g; n; lr, bc1, bc2, beta1, 1 - beta1, beta2, 1 - beta2, eps, wd;
# decoupled; stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [
    ctypes.c_float] * 9 + [ctypes.c_int, ctypes.c_void_p]


def fused_adamw_supported(p, m, v):
    """The leaf goes to the kernel: f32 p, m and v (a bf16 moment keeps the
    plain path) of at least MIN_SIZE elements."""
    return (p.dtype == torch.float32 and m.dtype == torch.float32
            and v.dtype == torch.float32 and p.numel() >= MIN_SIZE)


@torch.no_grad()
def adamw_update_plain(p, m, v, g, lr, bc1, bc2, *, beta1, beta2, eps,
                       weight_decay, decoupled):
    """One Adam (``decoupled=False``: L2 decay added to the gradient) or
    AdamW (decoupled decay) step in plain PyTorch, f32 math, written back
    into p, m and v in place (each keeps its dtype). Returns (p, m, v)."""
    g32 = g.float()
    p32 = p.float()
    if weight_decay and not decoupled:
        g32 = g32 + weight_decay * p32
    m32 = beta1 * m.float() + (1.0 - beta1) * g32
    v32 = beta2 * v.float() + (1.0 - beta2) * g32 * g32
    step = lr * (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
    if weight_decay and decoupled:
        step = step + lr * weight_decay * p32
    p.copy_(p32 - step)
    m.copy_(m32)
    v.copy_(v32)
    return p, m, v


def _check(p, m, v, g):
    for name, t in (("p", p), ("m", m), ("v", v), ("g", g)):
        if t.device != p.device:
            raise ValueError(f"fused_adamw_update: {name} on {t.device}, p on "
                             f"{p.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"fused_adamw_update: {name} is {t.dtype}; the "
                            "kernel takes float32 only")
        if t.shape != p.shape:
            raise ValueError(f"fused_adamw_update: {name} {tuple(t.shape)} "
                             f"is not shaped like p {tuple(p.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"fused_adamw_update: {name} must be contiguous")
    if p.numel() < 1:
        raise ValueError("fused_adamw_update: empty leaf")


@torch.no_grad()
def fused_adamw_update(p, m, v, g, lr, bc1, bc2, *, beta1, beta2, eps,
                       weight_decay, decoupled):
    """In-place one-pass update of one leaf -> (p, m, v). lr, bc1 and bc2
    are this step's (host floats: no device sync); the betas, eps and
    weight_decay are the optimizer's. CPU tensors run the plain version;
    CUDA tensors launch the kernel or raise."""
    kw = dict(beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay,
              decoupled=decoupled)
    if p.device.type == "cpu":
        return adamw_update_plain(p, m, v, g, lr, bc1, bc2, **kw)
    if p.device.type != "cuda":
        raise ValueError(f"fused_adamw_update: unsupported device {p.device}")
    _check(p, m, v, g)
    from .. import _build
    fn = _build.load("fused_adamw", _ARGTYPES, "fused_adamw_update")
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
                 p.numel(), float(lr), float(bc1), float(bc2), float(beta1),
                 1.0 - beta1, float(beta2), 1.0 - beta2, float(eps),
                 float(weight_decay or 0.0), int(bool(decoupled)), stream)
    if err:
        raise RuntimeError(f"fused_adamw_update kernel launch failed: CUDA "
                           f"error {err}")
    fused_adamw_update.launches += 1
    return p, m, v


fused_adamw_update.launches = 0
