"""Fused 1x1 convolution + BatchNorm + ReLU (+ residual): the CUDA kernel's
wrapper, its plain twin, its autograd function and the batch statistics.

Counterpart of ``paddle_tpu/ops/pallas/conv_bn_act.py``
(``fused_conv1x1_bn_act`` over ``_fwd_call``, ``_reference``,
``_fused_bwd`` and ``conv1x1_batch_stats``). In NHWC a 1x1 convolution is
``x2 [M, Cin] @ w [Cin, Cout]`` with M = N*H*W, and

    y = relu((x2 @ w) * scale + shift [+ res2])

with the BatchNorm folded into per-channel ``scale``/``shift``, the
product summed in f32 and y in x2's dtype.

- ``fused_conv1x1_bn_act`` — the entry and the kernel's wrapper: a CPU
  tensor runs ``conv_bn_act_plain``; a CUDA tensor launches
  ``csrc/conv_bn_act.cu`` or raises. ``fused_conv1x1_bn_act.launches``
  counts kernel launches. With gradients wanted it runs through
  ``FusedConv1x1BnAct``.
- ``conv_bn_act_plain`` — the twin of ``_reference``: the product in f32,
  the epilogue in f32, the output in x2's dtype.
- ``FusedConv1x1BnAct`` — the autograd function. Its backward is plain
  PyTorch, as ``_fused_bwd`` is plain jnp: it recomputes x2 @ w (the
  forward never wrote it), masks by y > 0 and returns dx, dw, dscale,
  dshift and dres in the primals' dtypes.
- ``conv1x1_batch_stats`` — (mean, var) of x2 @ w over the rows without
  forming the product (the Gram-matrix trick), plain PyTorch.

The reference's TPU tiling rules are gone, and with them its quiet jnp
fallback: ``_supported``'s Cin and Cout multiples of 128 and 4 MiB weight
cap, and ``_pick_block_m``. The kernel takes any M, Cin and Cout, in f32,
bf16 or float16; what it does not take (another dtype, a mismatched or
non-contiguous operand) raises on every device.

Kernel note (details in the .cu): bound by bytes at most of ResNet-50's
shapes; one block of 8 warps per 128 x 128 output tile, bf16 and float16
through tensor-core mma.sync with f32 accumulators (one kernel, the element
type a template parameter; a float16 output past 65504 is inf, as the
reference's astype makes it); f32 on the tensor cores in 3xTF32 (each
operand split into two TF32 parts, three wgmma products a step, at the f32
bar), the block's tile computed transposed so that x is
the K-major shared-memory operand; the epilogue staged through shared
memory for 16-byte stores.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["fused_conv1x1_bn_act", "conv_bn_act_plain", "FusedConv1x1BnAct",
           "conv1x1_batch_stats"]

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# the C entry's dtype codes (kF32, kBF16, kF16)
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P = ctypes.c_void_p
# x, w, scale, shift, res, y; m; k; n; the dtype code; relu; stream
_ARGTYPES = [_P] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [_P]


def conv_bn_act_plain(x2, w, scale, shift, res2=None, relu=True):
    """The twin: relu((x2 @ w) * scale + shift [+ res2]) with the product
    and the epilogue in f32, returned in x2's dtype."""
    y = torch.matmul(x2.float(), w.float()) * scale.float() + shift.float()
    if res2 is not None:
        y = y + res2.float()
    if relu:
        y = torch.where(y > 0, y, torch.zeros_like(y))
    return y.to(x2.dtype)


def _check(x2, w, scale, shift, res2):
    """Raise on anything the kernel does not take."""
    fn = "fused_conv1x1_bn_act"
    if x2.dtype not in _DTYPES:
        raise TypeError(f"{fn}: x2 is {x2.dtype}; the kernel takes "
                        f"{_DTYPES}")
    if x2.dim() != 2 or w.dim() != 2 or w.shape[0] != x2.shape[1]:
        raise ValueError(f"{fn}: x2 {tuple(x2.shape)} and w "
                         f"{tuple(w.shape)} are not [M, Cin] and [Cin, Cout]")
    m, cout = x2.shape[0], w.shape[1]
    if m < 1 or x2.shape[1] < 1 or cout < 1:
        raise ValueError(f"{fn}: empty product {tuple(x2.shape)} @ "
                         f"{tuple(w.shape)}")
    operands = [("x2", x2, x2.dtype, (m, x2.shape[1])),
                ("w", w, x2.dtype, tuple(w.shape)),
                ("scale", scale, torch.float32, (cout,)),
                ("shift", shift, torch.float32, (cout,))]
    if res2 is not None:
        operands.append(("res2", res2, x2.dtype, (m, cout)))
    for name, t, dtype, shape in operands:
        if t.device != x2.device or t.dtype != dtype \
                or tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}; want {dtype} {shape} on "
                             f"{x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")


def _launch(x2, w, scale, shift, res2, relu):
    """The forward on x2's device: the twin on the CPU, the kernel on
    CUDA (counted), anything else raises."""
    if x2.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_conv1x1_bn_act: unsupported device "
                         f"{x2.device}")
    _check(x2, w, scale, shift, res2)
    if x2.device.type == "cpu":
        return conv_bn_act_plain(x2, w, scale, shift, res2, relu)
    from .. import _build
    fn = _build.load("conv_bn_act", _ARGTYPES)
    m, k = x2.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = fn(x2.data_ptr(), w.data_ptr(), scale.data_ptr(),
                 shift.data_ptr(), 0 if res2 is None else res2.data_ptr(),
                 y.data_ptr(), m, k, n, _CODES[x2.dtype], int(bool(relu)),
                 stream)
    if err:
        raise RuntimeError(f"fused_conv1x1_bn_act kernel launch failed: "
                           f"CUDA error {err}")
    fused_conv1x1_bn_act.launches += 1
    return y


class FusedConv1x1BnAct(torch.autograd.Function):
    """y = relu((x2 @ w) * scale + shift [+ res2]) forward through the
    kernel; the backward in plain PyTorch, as the reference's
    ``_fused_bwd``."""

    @staticmethod
    def forward(ctx, x2, w, scale, shift, res2, relu):
        y = _launch(x2, w, scale, shift, res2, relu)
        ctx.relu = relu
        ctx.res_dtype = None if res2 is None else res2.dtype
        ctx.save_for_backward(x2, w, scale, shift, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, w, scale, shift, y = ctx.saved_tensors
        dz = dy.float()
        if ctx.relu:
            dz = torch.where(y > 0, dz, torch.zeros_like(dz))
        xf, wf = x2.float(), w.float()
        xw = torch.matmul(xf, wf)
        dscale = (dz * xw).sum(0)
        dshift = dz.sum(0)
        dxw = dz * scale.float()
        dx = torch.matmul(dxw, wf.t())
        dw = torch.matmul(xf.t(), dxw)
        dres = None if ctx.res_dtype is None else dz.to(ctx.res_dtype)
        return (dx.to(x2.dtype), dw.to(w.dtype), dscale.to(scale.dtype),
                dshift.to(shift.dtype), dres, None)


def fused_conv1x1_bn_act(x2, w, scale, shift, res2=None, relu=True):
    """y = relu((x2 @ w) * scale + shift [+ res2]) in one pass.

    x2 [M, Cin] (NHWC flattened over N*H*W) and w [Cin, Cout] in f32,
    bf16 or float16 alike; scale, shift [Cout] f32 (the folded BatchNorm);
    res2 an optional [M, Cout] residual in x2's dtype, added before the
    ReLU. All
    contiguous. Returns [M, Cout] in x2's dtype, differentiable in every
    tensor argument."""
    args = (x2, w, scale, shift) + (() if res2 is None else (res2,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return FusedConv1x1BnAct.apply(x2, w, scale, shift, res2, relu)
    return _launch(x2, w, scale, shift, res2, relu)


fused_conv1x1_bn_act.launches = 0


def conv1x1_batch_stats(x2, w):
    """(mean, var) per output channel of x2 @ w over the M rows, without
    forming the [M, Cout] product, all in f32 and differentiable:

        mean  = mean_M(x2) @ w
        E[y²] = diag(wᵀ G w),  G = x2ᵀ x2 / M
        var   = max(E[y²] - mean², 0)
    """
    xf, wf = x2.float(), w.float()
    mean = torch.matmul(xf.mean(0), wf)
    g = torch.matmul(xf.t(), xf) / x2.shape[0]
    ex2 = (wf * torch.matmul(g, wf)).sum(0)
    return mean, torch.clamp_min(ex2 - mean.square(), 0.0)
