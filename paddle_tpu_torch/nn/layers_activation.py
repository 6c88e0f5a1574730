"""Activation layers of the port (counterpart of
``paddle_tpu/nn/layers_activation.py``): ``ReLU``, ``ReLU6``, ``Silu``,
``Swish``, ``Sigmoid``, ``Hardsigmoid`` and ``Hardswish``, as far as ResNet,
the detection models and the classification zoo need them."""
from __future__ import annotations

from torch import nn

from . import functional as F


class _Activation(nn.Module):
    """An activation layer: ``name`` is taken and ignored, as in the
    reference."""

    def __init__(self, name=None):
        super().__init__()

__all__ = ["ReLU", "ReLU6", "Silu", "Swish", "Sigmoid", "Hardsigmoid",
           "Hardswish"]


class ReLU(_Activation):
    """ref: nn.ReLU."""

    def forward(self, x):
        return F.relu(x)


class ReLU6(_Activation):
    """ref: nn.ReLU6."""

    def forward(self, x):
        return F.relu6(x)


class Silu(_Activation):
    """ref: nn.Silu."""

    def forward(self, x):
        return F.silu(x)


class Swish(Silu):
    """ref: nn.Swish, which is ``Silu``."""


class Sigmoid(_Activation):
    """ref: nn.Sigmoid."""

    def forward(self, x):
        return F.sigmoid(x)


class Hardsigmoid(_Activation):
    """ref: nn.Hardsigmoid (slope 1/6, offset 0.5)."""

    def forward(self, x):
        return F.hardsigmoid(x)


class Hardswish(_Activation):
    """ref: nn.Hardswish."""

    def forward(self, x):
        return F.hardswish(x)
