"""paddle.nn.functional subset of the port (counterpart of
``paddle_tpu/nn/functional.py``): what GPT serving and training,
BERT/ERNIE pretraining and Llama's decode need.

Weights keep the Paddle layout: ``linear`` takes ``[in, out]``. Whatever
draws random numbers (``dropout``, attention dropout in
``scaled_dot_product_attention``) takes an explicit ``torch.Generator``
and raises without one: the port keeps no global RNG state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as _F

from ..ops import attention as _attn

__all__ = ["linear", "embedding", "layer_norm", "rms_norm", "gelu", "silu",
           "tanh", "softmax", "dropout", "cross_entropy",
           "scaled_dot_product_attention"]


def linear(x, weight, bias=None):
    """x @ weight (+ bias), weight [in_features, out_features]."""
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def embedding(x, weight):
    return _F.embedding(x, weight)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    return _F.layer_norm(x, tuple(normalized_shape), weight, bias, epsilon)


def rms_norm(x, weight=None, epsilon=1e-6, axis=-1):
    """ref: F.rms_norm — x * rsqrt(mean(x^2) + epsilon) with the statistics
    in f32, cast back to x's dtype, then times ``weight``."""
    xf = x.float()
    ms = xf.square().mean(dim=axis, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


def gelu(x, approximate=False):
    """Exact erf GELU by default, as the reference."""
    return _F.gelu(x, approximate="tanh" if approximate else "none")


def silu(x):
    """x * sigmoid(x): Llama's SwiGLU gate."""
    return _F.silu(x)


def tanh(x):
    """The BERT/ERNIE pooler's activation (``pool_act="tanh"``)."""
    return torch.tanh(x)


def softmax(x, axis=-1, dtype=None):
    if dtype is not None:
        x = x.to(dtype)
    return torch.softmax(x, dim=axis)


def _need_generator(fn, generator):
    if generator is None:
        raise ValueError(
            f"{fn}: dropout in training needs an explicit torch.Generator "
            "(framework.seed(...) makes one; a model or Engine passes its "
            "own) — the port draws nothing from torch's global RNG")


def dropout(x, p=0.5, training=True, generator=None):
    """Upscale-in-train dropout; identity when not training or p == 0.
    The keep mask draws from ``generator`` (on x's device), which training
    with p > 0 requires."""
    if not training or not p:
        return x
    _need_generator("dropout", generator)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def cross_entropy(input, label, ignore_index=-100, reduction="mean",
                  axis=-1):
    """ref: F.cross_entropy with integer labels: log-softmax in f32 over
    ``axis``, the label's negative log-probability per position, 0 where
    label == ignore_index. reduction 'mean' divides by the number of
    positions not ignored; 'sum' and 'none' as named."""
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
                                 training=True, kv_lens=None,
                                 generator=None):
    """ref: F.scaled_dot_product_attention, [B, S, H, D] layout.

    With no dense mask, attention runs through the differentiable
    ``ops.attention.flash_attention`` — the CUDA kernels on the card, their
    plain twins on the CPU. ``kv_lens`` ([B] ints, a port extension) masks
    keys at positions >= kv_lens[b] inside the kernel: the serving
    prefill's padding mask. Attention dropout (training, dropout_p > 0)
    runs in the kernel with the TPU kernel's hash; its seed is drawn from
    ``generator`` on the device, as the reference draws it from its key
    stream, so the call stays free of host syncs. A dense ``attn_mask``
    (bool keep-mask or additive bias) takes the plain dense path, as it
    takes the jnp path in the reference, and only on the CPU: no kernel of
    this port takes a dense mask yet, so on the card it raises (express
    padding as ``kv_lens``)."""
    eff_drop = float(dropout_p) if (dropout_p and training) else 0.0
    if attn_mask is None:
        seed = 0
        if eff_drop:
            _need_generator("scaled_dot_product_attention", generator)
            seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                 device=query.device, dtype=torch.int32)
        return _attn.flash_attention(query, key, value, causal=is_causal,
                                     kv_lens=kv_lens, dropout_p=eff_drop,
                                     dropout_seed=seed)
    if query.device.type != "cpu":
        raise NotImplementedError(
            "a dense attn_mask has no kernel on the card yet (ROADMAP.md); "
            "express padding as kv_lens, which the flash kernel takes")
    if eff_drop:
        raise NotImplementedError(
            "attention dropout with a dense attn_mask is not ported (the "
            "reference draws it with jax.random there; ROADMAP.md); "
            "express padding as kv_lens, which the flash kernel takes")
    return _attn.reference_attention(query, key, value, causal=is_causal,
                                     kv_lens=kv_lens, attn_mask=attn_mask)
