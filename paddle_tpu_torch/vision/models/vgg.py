"""VGG of the port (counterpart of ``paddle_tpu/vision/models/vgg.py``,
ref: python/paddle/vision/models/vgg.py).

NCHW, the reference's layers and parameter names (``features.0.weight``,
``classifier.0.weight`` ...), so a reference ``state_dict`` loads key for
key. Every model of the zoo is built on CUDA unless the caller passes
``device="cpu"``; ``generator`` draws the initial weights and, in
training, the dropout masks (``framework.bind_generator`` points the
model at another one)."""
from __future__ import annotations

from torch import nn

from ...nlp.modeling_utils import model_kw
from ...nn.layers_activation import ReLU
from ...nn.layers_common import Dropout, Linear, Sequential
from ...nn.layers_conv import Conv2D
from ...nn.layers_norm import BatchNorm2D
from ...nn.layers_pooling import AdaptiveAvgPool2D, MaxPool2D
from ._utils import load_pretrained, split_kw

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg, batch_norm=False, *, device=None, dtype=None,
                generator=None):
    kw, dk = split_kw(model_kw(device, dtype, generator))
    layers, in_c = [], 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(kernel_size=2, stride=2))
        else:
            layers.append(Conv2D(in_c, v, 3, padding=1, **kw))
            if batch_norm:
                layers.append(BatchNorm2D(v, **dk))
            layers.append(ReLU())
            in_c = v
    return Sequential(*layers)


class VGG(nn.Module):
    """ref: VGG — features + the three-layer 4096-wide classifier."""

    def __init__(self, features, num_classes=1000, with_pool=True, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = model_kw(device, dtype, generator)
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            g = kw["generator"]
            self.classifier = Sequential(
                Linear(512 * 7 * 7, 4096, **kw), ReLU(), Dropout(generator=g),
                Linear(4096, 4096, **kw), ReLU(), Dropout(generator=g),
                Linear(4096, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


_PUBLIC_NAME = {"A": "vgg11", "B": "vgg13", "D": "vgg16", "E": "vgg19"}


def _vgg(cfg, batch_norm, pretrained=False, **kwargs):
    arch = _PUBLIC_NAME[cfg] + ("_bn" if batch_norm else "")

    def build():
        kw = model_kw(kwargs.pop("device", None), kwargs.pop("dtype", None),
                      kwargs.pop("generator", None))
        return VGG(make_layers(_CFGS[cfg], batch_norm, **kw), **kwargs,
                   **kw)
    return load_pretrained(build, pretrained, arch=arch)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, **kwargs)
