"""paddle.nn.functional subset of the port (counterpart of
``paddle_tpu/nn/functional.py``): what GPT serving and training,
BERT/ERNIE pretraining, Llama's decode, ResNet and the detection models
need, and the classification zoo's activations and average pool.

Weights keep the Paddle layout: ``linear`` takes ``[in, out]``, ``conv2d``
an OIHW kernel or, with ``weight_format="HWIO"``, the channels-last one.
The convolutions and pools run through PyTorch's own operators on permuted
views, as the reference leaves them to XLA outside Pallas; an NHWC tensor
stays NHWC in memory from op to op. Whatever
draws random numbers (``dropout``, attention dropout in
``scaled_dot_product_attention``) takes an explicit ``torch.Generator``
and raises without one: the port keeps no global RNG state. Every
function takes the reference's parameters in the reference's order,
``name`` taken and ignored; the port's own (``generator``, ``kv_lens``)
are keyword-only and ``weight_format`` trails.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as _F

from ..framework import later
from ..ops import attention as _attn

__all__ = ["linear", "embedding", "layer_norm", "rms_norm", "gelu", "silu",
           "swish", "sigmoid", "hardsigmoid", "hardswish", "tanh", "relu",
           "relu6", "softmax", "dropout", "cross_entropy",
           "scaled_dot_product_attention", "conv2d", "batch_norm",
           "max_pool2d", "avg_pool2d", "adaptive_avg_pool2d", "interpolate"]


def linear(x, weight, bias=None, name=None):
    """x @ weight (+ bias), weight [in_features, out_features]."""
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def _refuse_sparse(sparse):
    if sparse:
        raise NotImplementedError(f"embedding(sparse=True) (a sparse "
                                  f"gradient) {later('1.6')}")


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """ref: F.embedding: rows of ``weight`` at ``x``; where x ==
    ``padding_idx`` the row reads zero and passes no gradient."""
    _refuse_sparse(sparse)
    out = _F.embedding(x, weight)
    if padding_idx is None:
        return out
    return torch.where((x == padding_idx)[..., None],
                       torch.zeros((), dtype=out.dtype, device=out.device),
                       out)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    return _F.layer_norm(x, tuple(normalized_shape), weight, bias, epsilon)


def rms_norm(x, weight=None, epsilon=1e-6, axis=-1, name=None):
    """ref: F.rms_norm — x * rsqrt(mean(x^2) + epsilon) with the statistics
    in f32, cast back to x's dtype, then times ``weight``."""
    xf = x.float()
    ms = xf.square().mean(dim=axis, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


def gelu(x, approximate=False, name=None):
    """Exact erf GELU by default, as the reference."""
    return _F.gelu(x, approximate="tanh" if approximate else "none")


def silu(x, name=None):
    """x * sigmoid(x): Llama's SwiGLU gate."""
    return _F.silu(x)


def swish(x, name=None):
    """ref: F.swish, which is ``silu``."""
    return _F.silu(x)


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def hardsigmoid(x, slope=1.0 / 6, offset=0.5, name=None):
    """ref: F.hardsigmoid — clip(slope * x + offset, 0, 1)."""
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x, name=None):
    """ref: F.hardswish — x * relu6(x + 3) / 6 (MobileNetV3)."""
    return _F.hardswish(x)


def tanh(x, name=None):
    """The BERT/ERNIE pooler's activation (``pool_act="tanh"``)."""
    return torch.tanh(x)


def relu(x, name=None):
    return torch.relu(x)


def relu6(x, name=None):
    """ref: F.relu6 — min(max(x, 0), 6) (MobileNetV2)."""
    return _F.relu6(x)


def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(dtype)
    return torch.softmax(x, dim=axis)


def _refuse_loss_options(fn, weight, soft_label, use_softmax,
                         label_smoothing):
    """Raise NotImplementedError naming item 1.6 for a loss option the
    port does not compute."""
    for what, off in (("weight", weight is None),
                      ("soft_label=True", not soft_label),
                      ("use_softmax=False", use_softmax),
                      ("label_smoothing", not label_smoothing)):
        if not off:
            raise NotImplementedError(f"{fn}({what}) {later('1.6')}")


def _need_generator(fn, generator):
    if generator is None:
        raise ValueError(
            f"{fn}: dropout in training needs an explicit torch.Generator "
            "(framework.seed(...) makes one; a model or Engine passes its "
            "own) — the port draws nothing from torch's global RNG")


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, *, generator=None):
    """ref: F.dropout. ``mode`` "upscale_in_train" (kept values over
    1 - p in training, identity otherwise) or "downscale_in_infer" (kept
    values as they are in training, x * (1 - p) otherwise); ``axis`` (an
    int or a list) draws one keep decision along the named axes, shared
    over the others. The keep mask draws from ``generator`` (on x's
    device), which training with p > 0 requires."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout: unknown mode {mode!r}")
    if not training or not p:
        if p and mode == "downscale_in_infer":
            return x * (1.0 - p)
        return x
    _need_generator("dropout", generator)
    shape = x.shape
    if axis is not None:
        axes = [a % x.dim() for a in (axis if isinstance(axis, (list, tuple))
                                      else [axis])]
        shape = [n if i in axes else 1 for i, n in enumerate(x.shape)]
    keep = torch.rand(shape, generator=generator, device=x.device) >= p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros_like(x))


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """ref: F.cross_entropy with integer labels: log-softmax in f32 over
    ``axis``, the label's negative log-probability per position, 0 where
    label == ignore_index. reduction 'mean' divides by the number of
    positions not ignored; 'sum' and 'none' as named. ``weight``,
    ``soft_label=True``, ``use_softmax=False`` and ``label_smoothing``
    raise NotImplementedError naming item 1.6."""
    _refuse_loss_options("cross_entropy", weight, soft_label, use_softmax,
                         label_smoothing)
    logp = torch.log_softmax(input.float(), dim=axis)
    lab = label.long()
    if lab.dim() == logp.dim() and lab.shape[axis] == 1:
        lab = lab.squeeze(axis)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    picked = torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp_min(1)
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, use_flash=True, name=None,
                                 *, kv_lens=None, generator=None):
    """ref: F.scaled_dot_product_attention, [B, S, H, D] layout.

    Attention runs through the differentiable ``ops.attention.
    flash_attention`` — the CUDA kernels on the card, their plain twins on
    the CPU — with or without a dense mask. ``attn_mask`` (a bool
    keep-mask or an additive float bias, broadcastable to [B, H, Sq, Sk])
    is read by the kernels in place, as the reference's dense path applies
    it: after the scale and ``is_causal``'s mask, a bool mask by
    ``where(mask, logits, -inf)``, a float one by addition; a row it
    leaves with no visible key gives NaN, as there. ``kv_lens`` ([B] ints,
    a port extension) masks keys at positions >= kv_lens[b] inside the
    kernel: the serving prefill's padding mask, whose empty rows give 0; it
    does not combine with ``attn_mask``. Attention dropout (training,
    dropout_p > 0) runs in the kernel with the TPU kernel's hash, with or
    without a mask; its seed is drawn from ``generator`` on the device, as
    the reference draws it from its key stream, so the call stays free of
    host syncs (the reference's dense path draws its keep mask with
    jax.random instead: the draws differ, the distribution is the same).
    ``use_flash=False`` (the reference's plain jnp path) raises: the port
    has no plain attention path on the card."""
    if not use_flash:
        raise NotImplementedError(
            "scaled_dot_product_attention(use_flash=False): the port has no "
            "plain attention path on the card (ROADMAP.md, ground rules: "
            "no fallback)")
    eff_drop = float(dropout_p) if (dropout_p and training) else 0.0
    seed = 0
    if eff_drop:
        _need_generator("scaled_dot_product_attention", generator)
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=query.device, dtype=torch.int32)
    return _attn.flash_attention(query, key, value, causal=is_causal,
                                 kv_lens=kv_lens, dropout_p=eff_drop,
                                 dropout_seed=seed, attn_mask=attn_mask)


# -- convolution, normalisation and pooling ------------------------------------

def _norm_tuple(v, n):
    if isinstance(v, int):
        return (int(v),) * n
    v = tuple(int(i) for i in v)
    return v if len(v) == n else v * n


def _pads(padding, n, kernel, stride, dilation, spatial):
    """The reference's padding spec (an int, n ints, 2n ints, n pairs, or
    'SAME' / 'VALID' as lax computes them) -> n (lo, hi) pairs."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * n
        if mode != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        pads = []
        for i in range(n):
            eff = (kernel[i] - 1) * dilation[i] + 1
            out = -(-spatial[i] // stride[i])
            total = max((out - 1) * stride[i] + eff - spatial[i], 0)
            pads.append((total // 2, total - total // 2))
        return pads
    if isinstance(padding, int):
        return [(int(padding), int(padding))] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    return [tuple(int(q) for q in p) for p in padding]


def _padded(x, pads, value=0.0):
    """x (NCHW view) and the symmetric padding left for the operator: an
    uneven pair is applied with ``F.pad`` first."""
    if all(lo == hi for lo, hi in pads):
        return x, tuple(lo for lo, _ in pads)
    flat = [v for lo, hi in reversed(pads) for v in (lo, hi)]
    return _F.pad(x, flat, value=value), (0,) * len(pads)


def _nchw(x, data_format):
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"unknown data_format {data_format!r} (NCHW | NHWC)")
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def _back(out, data_format):
    """Return an NHWC result as a contiguous [N, H, W, C] tensor (a no-op
    when the operator kept the channels-last memory format)."""
    if data_format == "NHWC":
        return out.permute(0, 2, 3, 1).contiguous()
    return out


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None, weight_format="OIHW"):
    """ref: F.conv2d. ``data_format`` NCHW or NHWC; ``weight_format`` OIHW
    ([out, in/groups, kh, kw]) or HWIO ([kh, kw, in/groups, out]). An NHWC
    input goes to ``torch.nn.functional.conv2d`` as a channels-last view
    and comes back as a contiguous NHWC tensor."""
    if weight_format == "HWIO":
        w = weight.permute(3, 2, 0, 1)
    elif weight_format == "OIHW":
        w = weight
    else:
        raise ValueError(f"unknown weight_format {weight_format!r} "
                         "(OIHW | HWIO)")
    xn = _nchw(x, data_format)
    stride, dilation = _norm_tuple(stride, 2), _norm_tuple(dilation, 2)
    pads = _pads(padding, 2, tuple(w.shape[2:]), stride, dilation,
                 tuple(xn.shape[2:]))
    xn, pad = _padded(xn, pads)
    out = _F.conv2d(xn, w, bias, stride, pad, dilation, groups)
    return _back(out, data_format)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """ref: F.batch_norm over the channel axis that ``data_format`` names
    (1 for NC*, the last for N*C). In training without
    ``use_global_stats`` it normalises by the batch statistics and updates
    the running ones in place with Paddle's convention, running = running *
    momentum + batch * (1 - momentum), the variance taken unbiased there;
    otherwise it normalises by the running statistics. The arithmetic is
    the reference's, (x - mean) * rsqrt(var + eps) * weight + bias, in the
    dtypes the operands promote to."""
    ch = x.dim() - 1 if data_format.endswith("C") else 1
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    if training and not use_global_stats:
        axes = [i for i in range(x.dim()) if i != ch]
        mean = x.mean(dim=axes)
        var = x.var(dim=axes, correction=0)
        n = math.prod(x.shape[i] for i in axes)
        with torch.no_grad():
            unbiased = var * (n / max(n - 1.0, 1.0))
            running_mean.copy_(running_mean * momentum
                               + mean * (1.0 - momentum))
            running_var.copy_(running_var * momentum
                              + unbiased * (1.0 - momentum))
    else:
        mean, var = running_mean, running_var
    out = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                  + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    """ref: F.max_pool2d: windows padded with -inf (the reference's
    reduce_window), ``ceil_mode`` extending the high pad so the last partial
    window is kept, as the reference does."""
    if return_mask:
        raise NotImplementedError(f"max_pool2d(return_mask=True) "
                                  f"{later('6')}")
    k = _norm_tuple(kernel_size, 2)
    s = _norm_tuple(stride if stride is not None else kernel_size, 2)
    xn = _nchw(x, data_format)
    pads = _pads(padding, 2, k, s, (1, 1), tuple(xn.shape[2:]))
    if ceil_mode and not isinstance(padding, str):
        pads = _ceil_pads(pads, tuple(xn.shape[2:]), k, s)
    if any(lo != hi or 2 * lo > k[d] for d, (lo, hi) in enumerate(pads)):
        flat = [v for lo, hi in reversed(pads) for v in (lo, hi)]
        xn, pad = _F.pad(xn, flat, value=-math.inf), (0, 0)
    else:
        pad = tuple(lo for lo, _ in pads)
    return _back(_F.max_pool2d(xn, k, s, pad), data_format)


def _ceil_pads(pads, size, k, s):
    """``pads`` with each high pad extended so the last partial window is
    kept (``ceil_mode``), as the reference extends it."""
    pads = list(pads)
    for d in range(len(pads)):
        rem = (size[d] + pads[d][0] + pads[d][1] - k[d]) % s[d]
        if rem:
            pads[d] = (pads[d][0], pads[d][1] + s[d] - rem)
    return pads


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    """ref: F.avg_pool2d: window sums over zero padding, divided by the
    window's area or, with ``exclusive`` (the default, torch's
    ``count_include_pad=False``), by the number of its cells inside the
    input. ``ceil_mode`` extends the high pad as ``max_pool2d`` does, and
    those cells are padding too. ``divisor_override`` is taken and
    ignored, as the reference ignores it."""
    k = _norm_tuple(kernel_size, 2)
    s = _norm_tuple(stride if stride is not None else kernel_size, 2)
    xn = _nchw(x, data_format)
    pads = _pads(padding, 2, k, s, (1, 1), tuple(xn.shape[2:]))
    if ceil_mode and not isinstance(padding, str):
        pads = _ceil_pads(pads, tuple(xn.shape[2:]), k, s)
    if all(lo == hi and 2 * lo <= k[d] for d, (lo, hi) in enumerate(pads)):
        out = _F.avg_pool2d(xn, k, s, tuple(lo for lo, _ in pads),
                            count_include_pad=not exclusive)
        return _back(out, data_format)
    # uneven or wide padding: pad with zeros, sum every window, divide by
    # the area or by the count of real cells
    flat = [v for lo, hi in reversed(pads) for v in (lo, hi)]
    area = float(k[0] * k[1])
    out = _F.avg_pool2d(_F.pad(xn, flat), k, s) * area
    if exclusive:
        ones = torch.ones((1, 1) + tuple(xn.shape[2:]), dtype=xn.dtype,
                          device=xn.device)
        out = out / (_F.avg_pool2d(_F.pad(ones, flat), k, s) * area)
    else:
        out = out / area
    return _back(out, data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """ref: F.adaptive_avg_pool2d: window i of n over a length L spans
    [floor(i L / n), ceil((i + 1) L / n)), also where n > L (VGG's 7 x 7
    over a smaller map repeats cells); None keeps that axis."""
    xn = _nchw(x, data_format)
    size = output_size if isinstance(output_size, int) else tuple(
        output_size)
    return _back(_F.adaptive_avg_pool2d(xn, size), data_format)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """ref: F.interpolate in ``nearest`` mode with an integer
    ``scale_factor`` (what the detection necks upsample with): output
    pixel i of an axis reads input pixel i // f, the reference's sampling
    matrix at an integer factor, so every value repeats f times along each
    spatial axis. ``data_format`` NCHW or NHWC. Other modes, ``size`` and
    fractional factors raise."""
    factors = (scale_factor if isinstance(scale_factor, (list, tuple))
               else [scale_factor] * (x.dim() - 2))
    if (mode != "nearest" or size is not None
            or any(f is None or not float(f).is_integer() or f < 1
                   for f in factors)):
        raise NotImplementedError(
            f"interpolate(mode={mode!r}, size={size!r}, scale_factor="
            f"{scale_factor!r}) {later('6')}; nearest with an integer "
            "scale_factor is ported")
    first = 1 if data_format.endswith("C") else 2
    for i, f in enumerate(factors):
        x = x.repeat_interleave(int(f), dim=first + i)
    return x
