"""LeNet of the port (counterpart of ``paddle_tpu/vision/models/lenet.py``,
ref: python/paddle/vision/models/lenet.py).

The reference's layers and parameter names (``features.0.weight`` ...
``fc.2.bias``), NCHW, so a reference ``state_dict`` loads key for key
through ``nlp.convert.load_numpy_state``. Built on CUDA unless the caller
passes ``device="cpu"``; ``generator`` draws the initial weights.
"""
from __future__ import annotations

from torch import nn

from ...nlp.modeling_utils import model_kw
from ...nn.layers_activation import ReLU
from ...nn.layers_common import Linear, Sequential
from ...nn.layers_conv import Conv2D
from ...nn.layers_pooling import MaxPool2D

__all__ = ["LeNet"]


class LeNet(nn.Module):
    def __init__(self, num_classes=10, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = model_kw(device, dtype, generator)
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, **kw),
            ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, **kw),
            ReLU(),
            MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = Sequential(
                Linear(400, 120, **kw),
                Linear(120, 84, **kw),
                Linear(84, num_classes, **kw),
            )

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x
