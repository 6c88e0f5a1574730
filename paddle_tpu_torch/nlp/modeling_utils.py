"""Shared transformer modeling helpers of the port (counterpart of
``paddle_tpu/nlp/modeling_utils.py``)."""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..framework import convert_dtype, get_default_dtype, seed
from ..ops.kernels.fused_ln import (fused_add_layer_norm,
                                    fused_add_layer_norm_y)

__all__ = ["normalize_attention_mask", "fused_residual_ln", "coerce_config",
           "model_kw"]


def coerce_config(cls, config, kwargs):
    """A model's config: ``cls(**kwargs)`` when none is given, ``cls`` of a
    dict, or the config object itself."""
    if config is None:
        return cls(**kwargs)
    if isinstance(config, dict):
        return cls(**config)
    return config


def model_kw(device, dtype, generator):
    """{device, dtype, generator} resolved as every model of the port does:
    CUDA by default (raises with no GPU), the framework's default dtype, a
    fresh nondeterministically seeded generator on that device."""
    device = resolve_device(device)
    dtype = convert_dtype(dtype) or get_default_dtype()
    if generator is None:
        generator = seed(None, device)
    return dict(device=device, dtype=dtype, generator=generator)


def normalize_attention_mask(attention_mask):
    """Normalise a user attention mask to [b, 1, sq|1, sk] broadcastable
    form: 2D/3D 0/1 padding masks (int or float — the tokenizer
    convention) become bool keep-masks; 4D float masks pass through as
    additive biases."""
    if attention_mask is None:
        return None
    m = torch.as_tensor(attention_mask)
    is_padding = m.dim() <= 3
    if m.dim() == 2:
        m = m[:, None, None, :]
    elif m.dim() == 3:
        m = m[:, None]
    if m.dtype != torch.bool and is_padding:
        m = m != 0
    return m


def fused_residual_ln(residual, h, ln, want_sum=True):
    """LN(residual + h) with ``ln``'s weight, bias and epsilon in one pass
    (``ops.kernels.fused_ln``: the CUDA kernel on the card, its plain twin
    on the CPU). want_sum=True returns (y, s) with s = residual + h (GPT's
    pre-LN block feeds s to the next residual); want_sum=False returns y
    alone and never writes the sum (BERT/ERNIE's post-LN blocks drop it).
    The kernels take any row count, so there is no fallback path."""
    eps = getattr(ln, "_epsilon", 1e-5)
    fn = fused_add_layer_norm if want_sum else fused_add_layer_norm_y
    return fn(residual, h, ln.weight, ln.bias, eps)
