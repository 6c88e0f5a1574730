"""paddle.nn.functional subset of the port (counterpart of
``paddle_tpu/nn/functional.py``): what GPT serving needs.

Weights keep the Paddle layout: ``linear`` takes ``[in, out]``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as _F

from ..ops import attention as _attn

__all__ = ["linear", "embedding", "layer_norm", "gelu", "softmax",
           "dropout", "scaled_dot_product_attention"]


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


def gelu(x, approximate=False):
    """Exact erf GELU by default, as the reference."""
    return _F.gelu(x, approximate="tanh" if approximate else "none")


def softmax(x, axis=-1, dtype=None):
    if dtype is not None:
        x = x.to(dtype)
    return torch.softmax(x, dim=axis)


def dropout(x, p=0.5, training=True, generator=None):
    """Upscale-in-train dropout; identity when not training or p == 0."""
    if not training or not p:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, kv_lens=None):
    """ref: F.scaled_dot_product_attention, [B, S, H, D] layout.

    With no dense mask, attention runs through
    ``ops.attention.flash_attention`` — the CUDA kernel on the card, its
    plain twin on the CPU. ``kv_lens`` ([B] ints, a port extension) masks
    keys at positions >= kv_lens[b] inside the kernel: the serving
    prefill's padding mask. A dense ``attn_mask`` (bool keep-mask or
    additive bias) takes the plain dense path, as it takes the jnp path in
    the reference, and only on the CPU: no kernel of this port takes a
    dense mask yet, so on the card it raises (express padding as
    ``kv_lens``)."""
    eff_drop = float(dropout_p) if (dropout_p and training) else 0.0
    if attn_mask is None:
        return _attn.flash_attention(query, key, value, causal=is_causal,
                                     kv_lens=kv_lens, dropout_p=eff_drop)
    if query.device.type != "cpu":
        raise NotImplementedError(
            "a dense attn_mask has no kernel on the card yet (ROADMAP.md); "
            "express padding as kv_lens, which the flash kernel takes")
    if eff_drop:
        raise NotImplementedError(
            "attention dropout on the dense path belongs to the training "
            "slice (ROADMAP.md)")
    return _attn.reference_attention(query, key, value, causal=is_causal,
                                     kv_lens=kv_lens, attn_mask=attn_mask)
