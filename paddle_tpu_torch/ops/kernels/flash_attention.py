"""Flash-attention forward: the CUDA kernel's wrapper and its plain twin.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``
(``_fwd_call`` / ``_fwd_kernel``, forward only). Layout is the kernel's
folded ``[B*H, S, D]``; ``ops.attention.flash_attention`` takes the public
``[B, S, H, D]`` layout and folds.

- ``flash_attention_fwd`` — the entry: a CPU tensor runs
  ``flash_attention_fwd_plain``; a CUDA tensor launches
  ``csrc/flash_attention_fwd.cu`` or raises. ``flash_attention_fwd.launches``
  counts kernel launches.
- ``flash_attention_fwd_plain`` — the same function in plain PyTorch (f32
  math, one dense softmax), what the CPU runs and what the kernel is held
  against on the card.

Kernel note (details in the .cu): bound by operations on the H100; this
first version computes on the CUDA cores in f32 with K/V tiles staged in
shared memory and skips tiles above the causal diagonal or past the key
length. Dropout (the TPU kernel's murmur3 hash) is not ported yet.
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["HEAD_DIMS", "NEG_INF", "flash_attention_fwd",
           "flash_attention_fwd_plain"]

HEAD_DIMS = (64, 128, 256)
NEG_INF = -1e30  # the TPU kernel's masked-score sentinel
_DTYPES = (torch.float32, torch.bfloat16)
# q, k, v, lens, o, lse; bh, sq, sk, d, causal; sm_scale; is_bf16; stream
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _visible(sq, sk, lens, causal, device):
    """[BH or 1, Sq, Sk] bool: which keys each query row may attend."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    ok = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        ok = kpos <= qpos + (sk - sq)
    ok = ok[None]
    if lens is not None:
        ok = ok & (kpos[None] < lens.to(device)[:, None, None])
    return ok


def flash_attention_fwd_plain(q, k, v, lens=None, causal=False,
                              sm_scale=None):
    """q [BH, Sq, D], k/v [BH, Sk, D]; lens [BH] int or None. Returns
    (o [BH, Sq, D] in q's dtype, lse [BH, Sq] f32). Rows with no visible
    key give o = 0 and lse = -1e30, as the kernels do."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    sq, sk = q.shape[1], k.shape[1]
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * sm_scale
    ok = _visible(sq, sk, lens, causal, q.device)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.matmul(p, v.float()) / safe_l
    lse = (m + torch.log(safe_l))[..., 0]
    return o.to(q.dtype), lse


def _check(q, k, v, lens):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention_fwd: {name} is {t.dtype}, "
                            f"q is {q.dtype}")
        if t.dim() != 3:
            raise ValueError(f"flash_attention_fwd: {name} must be "
                             f"[B*H, S, D], got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_fwd: {name} must be "
                             "contiguous and 16-byte aligned")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_fwd: dtype {q.dtype} not in "
                        f"{_DTYPES}")
    bh, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"flash_attention_fwd: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if sq < 1 or k.shape[1] < 1 or bh < 1 or bh > 65535:
        raise ValueError(f"flash_attention_fwd: unsupported shape "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    if lens is not None and (lens.device != q.device
                             or lens.dtype != torch.int32
                             or lens.shape != (bh,)
                             or not lens.is_contiguous()):
        raise ValueError("flash_attention_fwd: lens must be a contiguous "
                         f"[{bh}] int32 tensor on {q.device}")


def flash_attention_fwd(q, k, v, lens=None, causal=False, sm_scale=None):
    """[B*H, S, D] flash-attention forward -> (o, lse). CPU tensors run
    the plain version; CUDA tensors launch the kernel or raise."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, lens, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device "
                         f"{q.device}")
    _check(q, k, v, lens)
    from .. import _build
    fn = _build.load("flash_attention_fwd", _ARGTYPES)
    bh, sq, d = q.shape
    sk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty(bh, sq, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if lens is None else lens.data_ptr(),
                 o.data_ptr(), lse.data_ptr(), bh, sq, sk, d, int(causal),
                 float(sm_scale), int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: "
                           f"CUDA error {err}")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0
