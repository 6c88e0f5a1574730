"""Activation layers of the port (counterpart of
``paddle_tpu/nn/layers_activation.py``): ``ReLU``, as far as ResNet needs
them."""
from __future__ import annotations

from torch import nn

from . import functional as F

__all__ = ["ReLU"]


class ReLU(nn.Module):
    """ref: nn.ReLU."""

    def forward(self, x):
        return F.relu(x)
