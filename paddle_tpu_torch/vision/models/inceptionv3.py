"""Inception v3 of the port (counterpart of
``paddle_tpu/vision/models/inceptionv3.py``, ref:
python/paddle/vision/models/inceptionv3.py); NCHW, the reference's names.
Its pooled branches average over 3 x 3 windows with padding 1, which
count only the cells inside the map (``AvgPool2D``'s default
``exclusive=True``)."""
from __future__ import annotations

import torch
from torch import nn

from ...nlp.modeling_utils import model_kw
from ...nn.layers_common import Dropout, Linear, Sequential
from ...nn.layers_pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D
from ._utils import ConvBNLayer as ConvBN
from ._utils import load_pretrained

__all__ = ["InceptionV3", "inception_v3"]


class InceptionA(nn.Module):
    def __init__(self, in_c, pool_c, **kw):
        super().__init__()
        self.b1 = ConvBN(in_c, 64, 1, **kw)
        self.b5 = Sequential(ConvBN(in_c, 48, 1, **kw),
                             ConvBN(48, 64, 5, padding=2, **kw))
        self.b3 = Sequential(ConvBN(in_c, 64, 1, **kw),
                             ConvBN(64, 96, 3, padding=1, **kw),
                             ConvBN(96, 96, 3, padding=1, **kw))
        self.bp = Sequential(AvgPool2D(3, stride=1, padding=1),
                             ConvBN(in_c, pool_c, 1, **kw))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)],
                         dim=1)


class InceptionB(nn.Module):
    """Grid reduction 35 -> 17."""

    def __init__(self, in_c, **kw):
        super().__init__()
        self.b3 = ConvBN(in_c, 384, 3, stride=2, **kw)
        self.b3d = Sequential(ConvBN(in_c, 64, 1, **kw),
                              ConvBN(64, 96, 3, padding=1, **kw),
                              ConvBN(96, 96, 3, stride=2, **kw))
        self.pool = MaxPool2D(3, stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b3d(x), self.pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_c, c7, **kw):
        super().__init__()
        self.b1 = ConvBN(in_c, 192, 1, **kw)
        self.b7 = Sequential(
            ConvBN(in_c, c7, 1, **kw),
            ConvBN(c7, c7, (1, 7), padding=(0, 3), **kw),
            ConvBN(c7, 192, (7, 1), padding=(3, 0), **kw))
        self.b7d = Sequential(
            ConvBN(in_c, c7, 1, **kw),
            ConvBN(c7, c7, (7, 1), padding=(3, 0), **kw),
            ConvBN(c7, c7, (1, 7), padding=(0, 3), **kw),
            ConvBN(c7, c7, (7, 1), padding=(3, 0), **kw),
            ConvBN(c7, 192, (1, 7), padding=(0, 3), **kw))
        self.bp = Sequential(AvgPool2D(3, stride=1, padding=1),
                             ConvBN(in_c, 192, 1, **kw))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)],
                         dim=1)


class InceptionD(nn.Module):
    """Grid reduction 17 -> 8."""

    def __init__(self, in_c, **kw):
        super().__init__()
        self.b3 = Sequential(ConvBN(in_c, 192, 1, **kw),
                             ConvBN(192, 320, 3, stride=2, **kw))
        self.b7 = Sequential(
            ConvBN(in_c, 192, 1, **kw),
            ConvBN(192, 192, (1, 7), padding=(0, 3), **kw),
            ConvBN(192, 192, (7, 1), padding=(3, 0), **kw),
            ConvBN(192, 192, 3, stride=2, **kw))
        self.pool = MaxPool2D(3, stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b7(x), self.pool(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, in_c, **kw):
        super().__init__()
        self.b1 = ConvBN(in_c, 320, 1, **kw)
        self.b3_in = ConvBN(in_c, 384, 1, **kw)
        self.b3_a = ConvBN(384, 384, (1, 3), padding=(0, 1), **kw)
        self.b3_b = ConvBN(384, 384, (3, 1), padding=(1, 0), **kw)
        self.bd_in = Sequential(ConvBN(in_c, 448, 1, **kw),
                                ConvBN(448, 384, 3, padding=1, **kw))
        self.bd_a = ConvBN(384, 384, (1, 3), padding=(0, 1), **kw)
        self.bd_b = ConvBN(384, 384, (3, 1), padding=(1, 0), **kw)
        self.bp = Sequential(AvgPool2D(3, stride=1, padding=1),
                             ConvBN(in_c, 192, 1, **kw))

    def forward(self, x):
        b3 = self.b3_in(x)
        bd = self.bd_in(x)
        return torch.cat([self.b1(x), self.b3_a(b3), self.b3_b(b3),
                          self.bd_a(bd), self.bd_b(bd), self.bp(x)], dim=1)


class InceptionV3(nn.Module):
    def __init__(self, num_classes=1000, with_pool=True, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        kw = model_kw(device, dtype, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            ConvBN(3, 32, 3, stride=2, **kw), ConvBN(32, 32, 3, **kw),
            ConvBN(32, 64, 3, padding=1, **kw), MaxPool2D(3, stride=2),
            ConvBN(64, 80, 1, **kw), ConvBN(80, 192, 3, **kw),
            MaxPool2D(3, stride=2))
        self.blocks = Sequential(
            InceptionA(192, 32, **kw), InceptionA(256, 64, **kw),
            InceptionA(288, 64, **kw), InceptionB(288, **kw),
            InceptionC(768, 128, **kw), InceptionC(768, 160, **kw),
            InceptionC(768, 160, **kw), InceptionC(768, 192, **kw),
            InceptionD(768, **kw),
            InceptionE(1280, **kw), InceptionE(2048, **kw))
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = Dropout(0.5, generator=kw["generator"])
            self.fc = Linear(2048, num_classes, **kw)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x.flatten(1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    return load_pretrained(lambda: InceptionV3(**kwargs), pretrained,
                           arch="inception_v3")
