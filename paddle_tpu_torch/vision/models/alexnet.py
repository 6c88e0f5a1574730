"""AlexNet of the port (counterpart of
``paddle_tpu/vision/models/alexnet.py``, ref:
python/paddle/vision/models/alexnet.py); NCHW, the reference's names."""
from __future__ import annotations

from torch import nn

from ...nlp.modeling_utils import model_kw
from ...nn.layers_activation import ReLU
from ...nn.layers_common import Dropout, Linear, Sequential
from ...nn.layers_conv import Conv2D
from ...nn.layers_pooling import AdaptiveAvgPool2D, MaxPool2D
from ._utils import load_pretrained

__all__ = ["AlexNet", "alexnet"]


class AlexNet(nn.Module):
    def __init__(self, num_classes=1000, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = model_kw(device, dtype, generator)
        g = kw["generator"]
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(3, 64, 11, stride=4, padding=2, **kw), ReLU(),
            MaxPool2D(3, stride=2),
            Conv2D(64, 192, 5, padding=2, **kw), ReLU(),
            MaxPool2D(3, stride=2),
            Conv2D(192, 384, 3, padding=1, **kw), ReLU(),
            Conv2D(384, 256, 3, padding=1, **kw), ReLU(),
            Conv2D(256, 256, 3, padding=1, **kw), ReLU(),
            MaxPool2D(3, stride=2))
        self.avgpool = AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(generator=g), Linear(256 * 6 * 6, 4096, **kw),
                ReLU(), Dropout(generator=g), Linear(4096, 4096, **kw),
                ReLU(), Linear(4096, num_classes, **kw))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def alexnet(pretrained=False, **kwargs):
    return load_pretrained(lambda: AlexNet(**kwargs), pretrained,
                           arch="alexnet")
