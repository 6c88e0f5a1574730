"""Activation layers of the port (counterpart of
``paddle_tpu/nn/layers_activation.py``): ``ReLU``, ``ReLU6``, ``Silu``,
``Swish``, ``Sigmoid``, ``Hardsigmoid`` and ``Hardswish``, as far as ResNet,
the detection models and the classification zoo need them."""
from __future__ import annotations

from torch import nn

from . import functional as F

__all__ = ["ReLU", "ReLU6", "Silu", "Swish", "Sigmoid", "Hardsigmoid",
           "Hardswish"]


class ReLU(nn.Module):
    """ref: nn.ReLU."""

    def forward(self, x):
        return F.relu(x)


class ReLU6(nn.Module):
    """ref: nn.ReLU6."""

    def forward(self, x):
        return F.relu6(x)


class Silu(nn.Module):
    """ref: nn.Silu."""

    def forward(self, x):
        return F.silu(x)


class Swish(Silu):
    """ref: nn.Swish, which is ``Silu``."""


class Sigmoid(nn.Module):
    """ref: nn.Sigmoid."""

    def forward(self, x):
        return F.sigmoid(x)


class Hardsigmoid(nn.Module):
    """ref: nn.Hardsigmoid (slope 1/6, offset 0.5)."""

    def forward(self, x):
        return F.hardsigmoid(x)


class Hardswish(nn.Module):
    """ref: nn.Hardswish."""

    def forward(self, x):
        return F.hardswish(x)
