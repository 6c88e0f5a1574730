"""Activation layers of the port (counterpart of
``paddle_tpu/nn/layers_activation.py``): ``ReLU``, ``Silu``, ``Sigmoid``
and ``Hardsigmoid``, as far as ResNet and the detection models need
them."""
from __future__ import annotations

from torch import nn

from . import functional as F

__all__ = ["ReLU", "Silu", "Sigmoid", "Hardsigmoid"]


class ReLU(nn.Module):
    """ref: nn.ReLU."""

    def forward(self, x):
        return F.relu(x)


class Silu(nn.Module):
    """ref: nn.Silu."""

    def forward(self, x):
        return F.silu(x)


class Sigmoid(nn.Module):
    """ref: nn.Sigmoid."""

    def forward(self, x):
        return F.sigmoid(x)


class Hardsigmoid(nn.Module):
    """ref: nn.Hardsigmoid (slope 1/6, offset 0.5)."""

    def forward(self, x):
        return F.hardsigmoid(x)
