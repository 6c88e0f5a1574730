"""SqueezeNet 1.0 and 1.1 of the port (counterpart of
``paddle_tpu/vision/models/squeezenet.py``, ref:
python/paddle/vision/models/squeezenet.py); NCHW, the reference's
names."""
from __future__ import annotations

import torch
from torch import nn

from ...nlp.modeling_utils import model_kw
from ...nn.layers_activation import ReLU
from ...nn.layers_common import Dropout, Sequential
from ...nn.layers_conv import Conv2D
from ...nn.layers_pooling import AdaptiveAvgPool2D, MaxPool2D
from ._utils import load_pretrained

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class Fire(nn.Module):
    def __init__(self, in_c, squeeze, e1, e3, **kw):
        super().__init__()
        self.squeeze = Conv2D(in_c, squeeze, 1, **kw)
        self.relu = ReLU()
        self.expand1 = Conv2D(squeeze, e1, 1, **kw)
        self.expand3 = Conv2D(squeeze, e3, 3, padding=1, **kw)

    def forward(self, x):
        x = self.relu(self.squeeze(x))
        return torch.cat([self.relu(self.expand1(x)),
                          self.relu(self.expand3(x))], dim=1)


class SqueezeNet(nn.Module):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        if version not in ("1.0", "1.1"):
            raise ValueError(
                f"version must be one of 1.0/1.1, got {version!r}")
        kw = model_kw(device, dtype, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = Sequential(
                Conv2D(3, 96, 7, stride=2, **kw), ReLU(),
                MaxPool2D(3, stride=2),
                Fire(96, 16, 64, 64, **kw), Fire(128, 16, 64, 64, **kw),
                Fire(128, 32, 128, 128, **kw), MaxPool2D(3, stride=2),
                Fire(256, 32, 128, 128, **kw), Fire(256, 48, 192, 192, **kw),
                Fire(384, 48, 192, 192, **kw), Fire(384, 64, 256, 256, **kw),
                MaxPool2D(3, stride=2), Fire(512, 64, 256, 256, **kw))
        else:
            self.features = Sequential(
                Conv2D(3, 64, 3, stride=2, **kw), ReLU(),
                MaxPool2D(3, stride=2),
                Fire(64, 16, 64, 64, **kw), Fire(128, 16, 64, 64, **kw),
                MaxPool2D(3, stride=2),
                Fire(128, 32, 128, 128, **kw), Fire(256, 32, 128, 128, **kw),
                MaxPool2D(3, stride=2),
                Fire(256, 48, 192, 192, **kw), Fire(384, 48, 192, 192, **kw),
                Fire(384, 64, 256, 256, **kw), Fire(512, 64, 256, 256, **kw))
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.5, generator=kw["generator"]),
                Conv2D(512, num_classes, 1, **kw), ReLU())
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        if self.with_pool:
            x = self.pool(x)
        return x.flatten(1)


def squeezenet1_0(pretrained=False, **kwargs):
    return load_pretrained(lambda: SqueezeNet("1.0", **kwargs), pretrained,
                           arch="squeezenet1_0")


def squeezenet1_1(pretrained=False, **kwargs):
    return load_pretrained(lambda: SqueezeNet("1.1", **kwargs), pretrained,
                           arch="squeezenet1_1")
