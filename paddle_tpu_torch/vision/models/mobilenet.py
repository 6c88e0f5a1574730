"""MobileNet v1, v2 and v3 of the port (counterpart of
``paddle_tpu/vision/models/mobilenet.py``, ref:
python/paddle/vision/models/mobilenetv1.py, mobilenetv2.py,
mobilenetv3.py).

NCHW and the reference's names. The depthwise convolutions are
``Conv2D(groups=channels)`` with OIHW kernels ``[c, 1, k, k]``, which run
through cuDNN on the card as the reference leaves them to XLA. The scale
multipliers, ``_make_divisible`` and the v3 tables are the reference's."""
from __future__ import annotations

from torch import nn

from ...nlp.modeling_utils import model_kw
from ...nn.layers_activation import Hardsigmoid, Hardswish, ReLU
from ...nn.layers_common import Dropout, Linear, Sequential
from ...nn.layers_conv import Conv2D
from ...nn.layers_pooling import AdaptiveAvgPool2D
from ._utils import ConvBNLayer, load_pretrained

__all__ = ["MobileNetV1", "MobileNetV2", "MobileNetV3Small",
           "MobileNetV3Large", "mobilenet_v1", "mobilenet_v2",
           "mobilenet_v3_small", "mobilenet_v3_large"]


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class DepthwiseSeparable(nn.Module):
    """ref: DepthwiseSeparable — depthwise 3x3 + pointwise 1x1."""

    def __init__(self, in_c, out_c1, out_c2, num_groups, stride, scale,
                 **kw):
        super().__init__()
        c1 = int(out_c1 * scale)
        self.dw = ConvBNLayer(in_c, c1, 3, stride=stride, padding=1,
                              groups=int(num_groups * scale), **kw)
        self.pw = ConvBNLayer(c1, int(out_c2 * scale), 1, **kw)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = model_kw(device, dtype, generator)
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        s = scale
        self.conv1 = ConvBNLayer(3, int(32 * s), 3, stride=2, padding=1,
                                 **kw)
        cfg = [  # in, out1, out2, groups, stride
            (32, 32, 64, 32, 1), (64, 64, 128, 64, 2),
            (128, 128, 128, 128, 1), (128, 128, 256, 128, 2),
            (256, 256, 256, 256, 1), (256, 256, 512, 256, 2),
            (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1), (512, 512, 1024, 512, 2),
            (1024, 1024, 1024, 1024, 1)]
        self.blocks = Sequential(*[
            DepthwiseSeparable(int(i * s), o1, o2, g, st, s, **kw)
            for i, o1, o2, g, st in cfg])
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(int(1024 * s), num_classes, **kw)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


class InvertedResidual(nn.Module):
    """ref: InvertedResidual — expand 1x1 -> depthwise 3x3 -> project
    1x1, ReLU6, with the identity added where stride 1 keeps the
    width."""

    def __init__(self, inp, oup, stride, expand_ratio, **kw):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNLayer(inp, hidden, 1, act="relu6", **kw))
        layers += [
            ConvBNLayer(hidden, hidden, 3, stride=stride, padding=1,
                        groups=hidden, act="relu6", **kw),
            ConvBNLayer(hidden, oup, 1, act=None, **kw)]
        self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = model_kw(device, dtype, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [  # t, c, n, s
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        in_c = _make_divisible(32 * scale)
        last_c = _make_divisible(1280 * max(1.0, scale))
        feats = [ConvBNLayer(3, in_c, 3, stride=2, padding=1, act="relu6",
                             **kw)]
        for t, c, n, s in cfg:
            out_c = _make_divisible(c * scale)
            for i in range(n):
                feats.append(InvertedResidual(in_c, out_c,
                                              s if i == 0 else 1, t, **kw))
                in_c = out_c
        feats.append(ConvBNLayer(in_c, last_c, 1, act="relu6", **kw))
        self.features = Sequential(*feats)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.2, generator=kw["generator"]),
                Linear(last_c, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


class SqueezeExcitation(nn.Module):
    """ref: SqueezeExcitation — a Hardsigmoid gate from the pooled
    features through two 1x1 convolutions."""

    def __init__(self, c, squeeze_c, **kw):
        super().__init__()
        self.pool = AdaptiveAvgPool2D(1)
        self.fc1 = Conv2D(c, squeeze_c, 1, **kw)
        self.relu = ReLU()
        self.fc2 = Conv2D(squeeze_c, c, 1, **kw)
        self.hs = Hardsigmoid()

    def forward(self, x):
        s = self.hs(self.fc2(self.relu(self.fc1(self.pool(x)))))
        return x * s


class _V3Block(nn.Module):
    def __init__(self, in_c, exp_c, out_c, k, stride, use_se, act, **kw):
        super().__init__()
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if exp_c != in_c:
            layers.append(ConvBNLayer(in_c, exp_c, 1, act=act, **kw))
        layers.append(ConvBNLayer(exp_c, exp_c, k, stride=stride,
                                  padding=k // 2, groups=exp_c, act=act,
                                  **kw))
        if use_se:
            layers.append(SqueezeExcitation(
                exp_c, _make_divisible(exp_c // 4), **kw))
        layers.append(ConvBNLayer(exp_c, out_c, 1, act=None, **kw))
        self.block = Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


# k, exp, out, se, act, stride — ref mobilenetv3.py NET_CONFIG
_V3_LARGE = [
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2), (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1), (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1), (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2), (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1)]
_V3_SMALL = [
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1), (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1), (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2), (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1)]


class _MobileNetV3(nn.Module):
    def __init__(self, cfg, last_exp, last_c, scale=1.0, num_classes=1000,
                 with_pool=True, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = model_kw(device, dtype, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        in_c = _make_divisible(16 * scale)
        feats = [ConvBNLayer(3, in_c, 3, stride=2, padding=1,
                             act="hardswish", **kw)]
        for k, exp, out, se, act, s in cfg:
            exp_c = _make_divisible(exp * scale)
            out_c = _make_divisible(out * scale)
            feats.append(_V3Block(in_c, exp_c, out_c, k, s, se, act, **kw))
            in_c = out_c
        exp_out = _make_divisible(last_exp * scale)
        feats.append(ConvBNLayer(in_c, exp_out, 1, act="hardswish", **kw))
        self.features = Sequential(*feats)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(exp_out, last_c, **kw), Hardswish(),
                Dropout(0.2, generator=kw["generator"]),
                Linear(last_c, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__(_V3_SMALL, 576, 1024, scale, num_classes, with_pool,
                         **kw)


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__(_V3_LARGE, 960, 1280, scale, num_classes, with_pool,
                         **kw)


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return load_pretrained(lambda: MobileNetV1(scale=scale, **kwargs),
                           pretrained, arch="mobilenet_v1")


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return load_pretrained(lambda: MobileNetV2(scale=scale, **kwargs),
                           pretrained, arch="mobilenet_v2")


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    return load_pretrained(lambda: MobileNetV3Small(scale=scale, **kwargs),
                           pretrained, arch="mobilenet_v3_small")


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    return load_pretrained(lambda: MobileNetV3Large(scale=scale, **kwargs),
                           pretrained, arch="mobilenet_v3_large")
