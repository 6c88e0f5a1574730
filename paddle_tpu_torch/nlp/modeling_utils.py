"""Shared transformer modeling helpers of the port (counterpart of
``paddle_tpu/nlp/modeling_utils.py``)."""
from __future__ import annotations

import torch

__all__ = ["normalize_attention_mask"]


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
