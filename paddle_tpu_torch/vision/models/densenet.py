"""DenseNet of the port (counterpart of
``paddle_tpu/vision/models/densenet.py``, ref:
python/paddle/vision/models/densenet.py); NCHW, the reference's names,
every depth (121, 161, 169, 201, 264)."""
from __future__ import annotations

import torch
from torch import nn

from ...nlp.modeling_utils import model_kw
from ...nn.layers_activation import ReLU
from ...nn.layers_common import Dropout, Linear, Sequential
from ...nn.layers_conv import Conv2D
from ...nn.layers_norm import BatchNorm2D
from ...nn.layers_pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D
from ._utils import load_pretrained, split_kw

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

_CFGS = {121: (64, 32, (6, 12, 24, 16)), 161: (96, 48, (6, 12, 36, 24)),
         169: (64, 32, (6, 12, 32, 32)), 201: (64, 32, (6, 12, 48, 32)),
         264: (64, 32, (6, 12, 64, 48))}


class _DenseLayer(nn.Module):
    def __init__(self, in_c, growth_rate, bn_size, dropout, **kw):
        super().__init__()
        _, dk = split_kw(kw)
        self.bn1 = BatchNorm2D(in_c, **dk)
        self.relu = ReLU()
        self.conv1 = Conv2D(in_c, bn_size * growth_rate, 1, bias_attr=False,
                            **kw)
        self.bn2 = BatchNorm2D(bn_size * growth_rate, **dk)
        self.conv2 = Conv2D(bn_size * growth_rate, growth_rate, 3,
                            padding=1, bias_attr=False, **kw)
        self.dropout = (Dropout(dropout, generator=kw["generator"])
                        if dropout else None)

    def forward(self, x):
        out = self.conv1(self.relu(self.bn1(x)))
        out = self.conv2(self.relu(self.bn2(out)))
        if self.dropout:
            out = self.dropout(out)
        return torch.cat([x, out], dim=1)


class _Transition(nn.Module):
    def __init__(self, in_c, out_c, **kw):
        super().__init__()
        _, dk = split_kw(kw)
        self.bn = BatchNorm2D(in_c, **dk)
        self.relu = ReLU()
        self.conv = Conv2D(in_c, out_c, 1, bias_attr=False, **kw)
        self.pool = AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.bn(x))))


class DenseNet(nn.Module):
    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True, *, device=None, dtype=None, generator=None):
        super().__init__()
        if layers not in _CFGS:
            raise ValueError(f"supported layers: {sorted(_CFGS)}, "
                             f"got {layers!r}")
        kw, dk = split_kw(model_kw(device, dtype, generator))
        num_init, growth, blocks = _CFGS[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = Conv2D(3, num_init, 7, stride=2, padding=3,
                            bias_attr=False, **kw)
        self.bn1 = BatchNorm2D(num_init, **dk)
        self.relu = ReLU()
        self.pool1 = MaxPool2D(3, stride=2, padding=1)
        feats = []
        c = num_init
        for i, n in enumerate(blocks):
            for _ in range(n):
                feats.append(_DenseLayer(c, growth, bn_size, dropout, **kw))
                c += growth
            if i != len(blocks) - 1:
                feats.append(_Transition(c, c // 2, **kw))
                c //= 2
        self.features = Sequential(*feats)
        self.bn2 = BatchNorm2D(c, **dk)
        if with_pool:
            self.pool2 = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Linear(c, num_classes, **kw)

    def forward(self, x):
        x = self.pool1(self.relu(self.bn1(self.conv1(x))))
        x = self.relu(self.bn2(self.features(x)))
        if self.with_pool:
            x = self.pool2(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _densenet(layers, pretrained, **kw):
    return load_pretrained(lambda: DenseNet(layers, **kw), pretrained,
                           arch=f"densenet{layers}")


def densenet121(pretrained=False, **kw):
    return _densenet(121, pretrained, **kw)


def densenet161(pretrained=False, **kw):
    return _densenet(161, pretrained, **kw)


def densenet169(pretrained=False, **kw):
    return _densenet(169, pretrained, **kw)


def densenet201(pretrained=False, **kw):
    return _densenet(201, pretrained, **kw)


def densenet264(pretrained=False, **kw):
    return _densenet(264, pretrained, **kw)
