"""GoogLeNet (Inception v1) of the port (counterpart of
``paddle_tpu/vision/models/googlenet.py``, ref:
python/paddle/vision/models/googlenet.py); NCHW, the reference's names.
In training the forward returns (main, aux1, aux2) logits, in eval the
main logits alone, as the reference's."""
from __future__ import annotations

import torch
from torch import nn

from ...nlp.modeling_utils import model_kw
from ...nn.layers_activation import ReLU
from ...nn.layers_common import Dropout, Linear, Sequential
from ...nn.layers_conv import Conv2D
from ...nn.layers_pooling import AdaptiveAvgPool2D, MaxPool2D
from ._utils import load_pretrained

__all__ = ["GoogLeNet", "googlenet"]


class Inception(nn.Module):
    def __init__(self, in_c, c1, c2_red, c2, c3_red, c3, c4, **kw):
        super().__init__()
        self.b1 = Sequential(Conv2D(in_c, c1, 1, **kw), ReLU())
        self.b2 = Sequential(
            Conv2D(in_c, c2_red, 1, **kw), ReLU(),
            Conv2D(c2_red, c2, 3, padding=1, **kw), ReLU())
        self.b3 = Sequential(
            Conv2D(in_c, c3_red, 1, **kw), ReLU(),
            Conv2D(c3_red, c3, 5, padding=2, **kw), ReLU())
        self.b4 = Sequential(
            MaxPool2D(3, stride=1, padding=1),
            Conv2D(in_c, c4, 1, **kw), ReLU())

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)],
                         dim=1)


class _AuxHead(nn.Module):
    def __init__(self, in_c, num_classes, **kw):
        super().__init__()
        self.pool = AdaptiveAvgPool2D(4)
        self.conv = Conv2D(in_c, 128, 1, **kw)
        self.relu = ReLU()
        self.fc1 = Linear(128 * 16, 1024, **kw)
        self.dropout = Dropout(0.7, generator=kw["generator"])
        self.fc2 = Linear(1024, num_classes, **kw)

    def forward(self, x):
        x = self.relu(self.conv(self.pool(x)))
        x = self.relu(self.fc1(x.flatten(1)))
        return self.fc2(self.dropout(x))


class GoogLeNet(nn.Module):
    def __init__(self, num_classes=1000, with_pool=True, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        kw = model_kw(device, dtype, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            Conv2D(3, 64, 7, stride=2, padding=3, **kw), ReLU(),
            MaxPool2D(3, stride=2, padding=1),
            Conv2D(64, 64, 1, **kw), ReLU(),
            Conv2D(64, 192, 3, padding=1, **kw), ReLU(),
            MaxPool2D(3, stride=2, padding=1))
        self.i3a = Inception(192, 64, 96, 128, 16, 32, 32, **kw)
        self.i3b = Inception(256, 128, 128, 192, 32, 96, 64, **kw)
        self.pool3 = MaxPool2D(3, stride=2, padding=1)
        self.i4a = Inception(480, 192, 96, 208, 16, 48, 64, **kw)
        self.i4b = Inception(512, 160, 112, 224, 24, 64, 64, **kw)
        self.i4c = Inception(512, 128, 128, 256, 24, 64, 64, **kw)
        self.i4d = Inception(512, 112, 144, 288, 32, 64, 64, **kw)
        self.i4e = Inception(528, 256, 160, 320, 32, 128, 128, **kw)
        self.pool4 = MaxPool2D(3, stride=2, padding=1)
        self.i5a = Inception(832, 256, 160, 320, 32, 128, 128, **kw)
        self.i5b = Inception(832, 384, 192, 384, 48, 128, 128, **kw)
        if with_pool:
            self.pool5 = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = Dropout(0.4, generator=kw["generator"])
            self.fc = Linear(1024, num_classes, **kw)
            self.aux1 = _AuxHead(512, num_classes, **kw)
            self.aux2 = _AuxHead(528, num_classes, **kw)

    def forward(self, x):
        heads = self.training and self.num_classes > 0
        x = self.pool3(self.i3b(self.i3a(self.stem(x))))
        x = self.i4a(x)
        aux1 = self.aux1(x) if heads else None
        x = self.i4d(self.i4c(self.i4b(x)))
        aux2 = self.aux2(x) if heads else None
        x = self.i5b(self.i5a(self.pool4(self.i4e(x))))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x.flatten(1)))
        if heads:
            return x, aux1, aux2
        return x


def googlenet(pretrained=False, **kwargs):
    return load_pretrained(lambda: GoogLeNet(**kwargs), pretrained,
                           arch="googlenet")
