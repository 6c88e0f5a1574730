"""Loss layers of the port (counterpart of
``paddle_tpu/nn/layers_loss.py``): ``CrossEntropyLoss``, as far as
ResNet training needs it."""
from __future__ import annotations

from torch import nn

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
        F._refuse_loss_options("CrossEntropyLoss", weight, soft_label,
                               use_softmax, label_smoothing)
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.axis = axis

    def forward(self, input, label):
        return F.cross_entropy(input, label, ignore_index=self.ignore_index,
                               reduction=self.reduction, axis=self.axis)
