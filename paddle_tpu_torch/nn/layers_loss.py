"""Loss layers of the port (counterpart of
``paddle_tpu/nn/layers_loss.py``): ``CrossEntropyLoss``, as far as
ResNet training needs it."""
from __future__ import annotations

from torch import nn

from ..framework import later
from . import functional as F

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(nn.Module):
    """ref: nn.CrossEntropyLoss with integer labels over ``F.cross_entropy``
    (log-softmax in f32). Not ported (each raises NotImplementedError):
    ``weight``, ``soft_label=True``, ``use_softmax=False`` and
    ``label_smoothing``."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        for what, off in (("weight", weight is None),
                          ("soft_label=True", not soft_label),
                          ("use_softmax=False", use_softmax),
                          ("label_smoothing", not label_smoothing)):
            if not off:
                raise NotImplementedError(f"CrossEntropyLoss({what}) "
                                          f"{later('1.6')}")
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.axis = axis

    def forward(self, input, label):
        return F.cross_entropy(input, label, ignore_index=self.ignore_index,
                               reduction=self.reduction, axis=self.axis)
