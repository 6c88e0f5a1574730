"""Carry weights from a reference ``state_dict`` into a port model.

The JAX package's ``Layer.state_dict()`` names parameters by their
structured path (``gpt.h.0.attn.q_proj.weight``) and keeps Paddle's
``[in, out]`` linear layout; the port's modules use the same names and
layout, so arrays copy across key for key with no transposes. A bf16
array (numpy's ``ml_dtypes.bfloat16``, which a bf16 JAX ``state_dict()``
gives and torch cannot read) crosses as its 16-bit pattern, bit for bit.

A GPT or Llama state crosses between the decoder layouts too: per-layer
or stacked ``[L, ...]`` blocks (``scan_layers``) and separate or fused
q/k/v projections (GPT's ``fused_qkv``), whichever the state is in and
whichever the model was built with (``nn.scan_stack.stack_layer_state``,
``nlp.gpt.fuse_qkv_state`` and their inverses).
"""
from __future__ import annotations

import numpy as np
import torch

from ..nn.layers_common import LayerList
from ..nn.scan_stack import (ScannedLayerStack, stack_layer_state,
                             unstack_layer_state)

__all__ = ["load_numpy_state"]


def _layer_prefix(model, layers):
    """The state-dict prefix of the model's decoder blocks ('gpt.h.',
    'llama.layers.', ...), or None."""
    for name, m in model.named_modules():
        if isinstance(m, ScannedLayerStack) or (
                isinstance(m, LayerList) and len(m) == layers):
            return name + "."
    return None


def _to_model_layout(model, arrays):
    """``arrays`` (a GPT or Llama state) converted to the decoder layout
    ``model`` was built with: stacked or per-layer blocks, fused or
    separate q/k/v. A state already in that layout, or a model without
    these options, comes back as it is."""
    from .gpt import fuse_qkv_state, split_qkv_state
    cfg = getattr(model, "config", None)
    if cfg is None or not hasattr(cfg, "scan_layers") \
            or set(model.state_dict()) == set(arrays):
        return arrays
    layers, heads = cfg.num_hidden_layers, cfg.num_attention_heads
    prefix = _layer_prefix(model, layers)
    if prefix is None:
        return arrays
    out = unstack_layer_state(dict(arrays), layers, prefix)
    if any(".qkv_proj." in k for k in out):
        out = split_qkv_state(out, heads)
    if getattr(cfg, "fused_qkv", False):
        out = fuse_qkv_state(out, heads)
    if cfg.scan_layers:
        out = stack_layer_state(out, layers, prefix)
    return out


def load_numpy_state(model, arrays):
    """Copy ``{name: np.ndarray}`` into ``model``'s parameters and
    buffers, strictly: a missing or unexpected key, or a shape mismatch,
    raises. The state may be in another decoder layout than the model's
    (``_to_model_layout``). Dtype and device are taken from the port
    model. Returns the model."""
    arrays = _to_model_layout(model, arrays)
    own = model.state_dict()
    missing = sorted(set(own) - set(arrays))
    unexpected = sorted(set(arrays) - set(own))
    if missing or unexpected:
        raise KeyError(f"load_numpy_state: missing {missing[:8]} "
                       f"(of {len(missing)}), unexpected {unexpected[:8]} "
                       f"(of {len(unexpected)})")
    for name, target in own.items():
        arr = np.asarray(arrays[name])
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"load_numpy_state: shape mismatch for {name}: "
                             f"{arr.shape} vs {tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(_tensor(arr))
    return model


def _tensor(arr):
    """A CPU tensor holding ``arr``'s values; bf16 viewed through int16."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return torch.tensor(arr)
