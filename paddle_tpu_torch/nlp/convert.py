"""Carry weights from a reference ``state_dict`` into a port model.

The JAX package's ``Layer.state_dict()`` names parameters by their
structured path (``gpt.h.0.attn.q_proj.weight``) and keeps Paddle's
``[in, out]`` linear layout; the port's modules use the same names and
layout, so arrays copy across key for key with no transposes. A bf16
array (numpy's ``ml_dtypes.bfloat16``, which a bf16 JAX ``state_dict()``
gives and torch cannot read) crosses as its 16-bit pattern, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_numpy_state"]


def load_numpy_state(model, arrays):
    """Copy ``{name: np.ndarray}`` into ``model``'s parameters and
    buffers, strictly: a missing or unexpected key, or a shape mismatch,
    raises. Dtype and device are taken from the port model. Returns the
    model."""
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
