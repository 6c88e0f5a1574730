"""ShuffleNetV2 of the port (counterpart of
``paddle_tpu/vision/models/shufflenetv2.py``, ref:
python/paddle/vision/models/shufflenetv2.py); NCHW, the reference's
names. ``channel_shuffle`` is a reshape, a transpose and a reshape."""
from __future__ import annotations

import torch
from torch import nn

from ...nlp.modeling_utils import model_kw
from ...nn.layers_activation import ReLU, Swish
from ...nn.layers_common import Linear, Sequential
from ...nn.layers_conv import Conv2D
from ...nn.layers_norm import BatchNorm2D
from ...nn.layers_pooling import AdaptiveAvgPool2D, MaxPool2D
from ._utils import load_pretrained, split_kw

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish"]

_STAGE_OUT = {
    0.25: (24, 24, 48, 96, 512), 0.33: (24, 32, 64, 128, 512),
    0.5: (24, 48, 96, 192, 1024), 1.0: (24, 116, 232, 464, 1024),
    1.5: (24, 176, 352, 704, 1024), 2.0: (24, 244, 488, 976, 2048)}
_STAGE_REPEATS = (4, 8, 4)


def channel_shuffle(x, groups):
    b, c, h, w = x.shape
    x = x.reshape(b, groups, c // groups, h, w).transpose(1, 2)
    return x.reshape(b, c, h, w)


def _act(name):
    return Swish() if name == "swish" else ReLU()


class InvertedResidual(nn.Module):
    def __init__(self, in_c, out_c, stride, act="relu", **kw):
        super().__init__()
        _, dk = split_kw(kw)
        self.stride = stride
        branch = out_c // 2
        if stride == 1:
            self.branch2 = self._main(in_c // 2, branch, stride, act, kw)
        else:
            self.branch1 = Sequential(
                Conv2D(in_c, in_c, 3, stride=stride, padding=1, groups=in_c,
                       bias_attr=False, **kw),
                BatchNorm2D(in_c, **dk),
                Conv2D(in_c, branch, 1, bias_attr=False, **kw),
                BatchNorm2D(branch, **dk), _act(act))
            self.branch2 = self._main(in_c, branch, stride, act, kw)

    @staticmethod
    def _main(in_c, out_c, stride, act, kw):
        _, dk = split_kw(kw)
        return Sequential(
            Conv2D(in_c, out_c, 1, bias_attr=False, **kw),
            BatchNorm2D(out_c, **dk), _act(act),
            Conv2D(out_c, out_c, 3, stride=stride, padding=1, groups=out_c,
                   bias_attr=False, **kw),
            BatchNorm2D(out_c, **dk),
            Conv2D(out_c, out_c, 1, bias_attr=False, **kw),
            BatchNorm2D(out_c, **dk), _act(act))

    def forward(self, x):
        if self.stride == 1:
            half = x.shape[1] // 2
            out = torch.cat([x[:, :half], self.branch2(x[:, half:])], dim=1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], dim=1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(nn.Module):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True, *, device=None, dtype=None, generator=None):
        super().__init__()
        if scale not in _STAGE_OUT:
            raise ValueError(f"supported scales: {sorted(_STAGE_OUT)}, "
                             f"got {scale!r}")
        kw, dk = split_kw(model_kw(device, dtype, generator))
        outs = _STAGE_OUT[scale]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = Sequential(
            Conv2D(3, outs[0], 3, stride=2, padding=1, bias_attr=False,
                   **kw),
            BatchNorm2D(outs[0], **dk), _act(act))
        self.max_pool = MaxPool2D(3, stride=2, padding=1)
        stages = []
        in_c = outs[0]
        for out_c, repeats in zip(outs[1:4], _STAGE_REPEATS):
            stages.append(InvertedResidual(in_c, out_c, 2, act, **kw))
            for _ in range(repeats - 1):
                stages.append(InvertedResidual(out_c, out_c, 1, act, **kw))
            in_c = out_c
        self.stages = Sequential(*stages)
        self.conv_last = Sequential(
            Conv2D(in_c, outs[4], 1, bias_attr=False, **kw),
            BatchNorm2D(outs[4], **dk), _act(act))
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(outs[4], num_classes, **kw)

    def forward(self, x):
        x = self.conv_last(self.stages(self.max_pool(self.conv1(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def _shufflenet(scale, arch, pretrained, act="relu", **kw):
    return load_pretrained(lambda: ShuffleNetV2(scale, act=act, **kw),
                           pretrained, arch=arch)


def shufflenet_v2_x0_25(pretrained=False, **kw):
    return _shufflenet(0.25, "shufflenet_v2_x0_25", pretrained, **kw)


def shufflenet_v2_x0_33(pretrained=False, **kw):
    return _shufflenet(0.33, "shufflenet_v2_x0_33", pretrained, **kw)


def shufflenet_v2_x0_5(pretrained=False, **kw):
    return _shufflenet(0.5, "shufflenet_v2_x0_5", pretrained, **kw)


def shufflenet_v2_x1_0(pretrained=False, **kw):
    return _shufflenet(1.0, "shufflenet_v2_x1_0", pretrained, **kw)


def shufflenet_v2_x1_5(pretrained=False, **kw):
    return _shufflenet(1.5, "shufflenet_v2_x1_5", pretrained, **kw)


def shufflenet_v2_x2_0(pretrained=False, **kw):
    return _shufflenet(2.0, "shufflenet_v2_x2_0", pretrained, **kw)


def shufflenet_v2_swish(pretrained=False, **kw):
    return _shufflenet(1.0, "shufflenet_v2_swish", pretrained, act="swish",
                       **kw)
