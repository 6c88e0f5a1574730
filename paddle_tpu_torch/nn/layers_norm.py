"""Normalisation layers of the port (counterpart of
``paddle_tpu/nn/layers_norm.py``): ``LayerNorm``, ``RMSNorm``."""
from __future__ import annotations

from torch import nn

from . import functional as F
from .layers_common import make_param

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(nn.Module):
    """ref: nn.LayerNorm — weight ones, bias zeros, over the trailing
    ``normalized_shape``."""

    def __init__(self, normalized_shape, epsilon=1e-5, *, device=None,
                 dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        self.weight = make_param(self._normalized_shape, device=device,
                                 dtype=dtype, init="ones")
        self.bias = make_param(self._normalized_shape, device=device,
                               dtype=dtype)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class RMSNorm(nn.Module):
    """ref: nn.RMSNorm — weight ones over the last dim, f32 statistics
    (``F.rms_norm``)."""

    def __init__(self, hidden_size, epsilon=1e-6, *, device=None,
                 dtype=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = make_param((hidden_size,), device=device, dtype=dtype,
                                 init="ones")

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)
