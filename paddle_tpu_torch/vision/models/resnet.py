"""ResNet family of the port (counterpart of
``paddle_tpu/vision/models/resnet.py``).

The public forward takes and returns NCHW, as the reference's. With
``layout="NHWC"`` the stack runs channels-last inside: the input is
transposed once at entry, every convolution, BatchNorm and pool then works
on real ``[N, H, W, C]`` tensors with HWIO kernels
(``nn.to_channels_last``), and a feature map leaves as NCHW.
``fused_bottleneck=True`` (NHWC only) sends both 1x1 chains of every
bottleneck, conv1 + bn1 + ReLU and conv3 + bn3 + residual + ReLU, through
``ops.kernels.conv_bn_act.fused_conv1x1_bn_act``: kernel #11 on the card,
its plain twin on the CPU. In eval mode the running statistics fold into
the kernel's f32 scale and shift. In training the batch statistics of
the conv output come from ``conv1x1_batch_stats`` (the Gram-matrix trick,
without forming the product), update the running statistics as
``F.batch_norm`` does and fold into scale and shift with autograd live, so
the gradients reach x, w, gamma and beta both through the kernel's
backward and through the statistics. As the reference, training fuses
only where Cin <= Cout (the Gram product costs Cin/Cout of the conv): a
contracting 1x1 runs the plain ops.

``s2d_stem=True`` replaces the 7x7/2 stem conv by ``SpaceToDepthStem``:
2x2 pixel blocks packed into 12 channels, then a 4x4/1 conv, exactly
equivalent under ``s2d_weights_from_7x7``.

``layout="auto"`` means NHWC for a model built on CUDA and NCHW on the
CPU, as the reference picks NHWC on its accelerator. Every module takes an
explicit ``device`` (CUDA unless the caller passes ``device="cpu"``),
``dtype`` and ``generator`` for initialisation. Parameter and buffer names
are the reference's, so a reference ``state_dict`` (conv kernels OIHW, or
HWIO in NHWC, and BatchNorm's ``_mean``/``_variance``) loads key for key
through ``nlp.convert.load_numpy_state``.

``pretrained`` takes the path of a checkpoint in the reference's NCHW
layout (``_utils.load_pretrained``); the model is built NCHW, loaded, then
converted to the layout asked for. ``pretrained=True`` raises, as the
reference's does.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ...device import resolve_device
from ...nlp.modeling_utils import model_kw
from ...nn.layers_activation import ReLU
from ...nn.layers_common import Linear, Sequential
from ...nn.layers_conv import Conv2D, to_channels_last
from ...nn.layers_norm import BatchNorm2D
from ...nn.layers_pooling import AdaptiveAvgPool2D, MaxPool2D
from ...ops.kernels.conv_bn_act import (conv1x1_batch_stats,
                                        fused_conv1x1_bn_act)
from ._utils import load_pretrained

__all__ = ["ResNet", "BasicBlock", "BottleneckBlock", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "wide_resnet50_2",
           "wide_resnet101_2", "resnext50_32x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_64x4d", "SpaceToDepthStem",
           "space_to_depth", "s2d_weights_from_7x7"]


def _resolve_layout(layout, device):
    """'auto' -> NHWC for a model on CUDA, NCHW on the CPU."""
    lay = str(layout).upper()
    if lay == "AUTO":
        return "NHWC" if torch.device(device).type == "cuda" else "NCHW"
    if lay not in ("NHWC", "NCHW"):
        raise ValueError(f"layout must be 'auto' | 'NHWC' | 'NCHW', "
                         f"got {layout!r}")
    return lay


def _fused_conv1x1_bn(x, conv, bn, residual=None, training=False):
    """One fused pass for a channels-last 1x1 conv + BatchNorm + ReLU
    (+ residual): y = relu((x @ W) * scale + shift [+ res]).

    Returns None where the reference's fused route does not apply (an OIHW
    kernel; a strided, padded, grouped or biased conv; a BatchNorm without
    affine parameters; batch statistics with Cin > Cout), and the caller
    runs the plain ops. ``x`` and ``residual`` are contiguous NHWC maps,
    viewed as [M, C] rows with no copy. With batch statistics the running
    ones are updated in place (Paddle's convention, the variance unbiased
    by M / (M - 1)), as ``F.batch_norm`` updates them."""
    w = conv.weight
    pad = conv._padding
    padded = isinstance(pad, str) or (
        any(int(p) != 0 for p in pad) if isinstance(pad, (list, tuple))
        else int(pad) != 0)
    if (conv._weight_format != "HWIO" or conv.bias is not None
            or getattr(bn, "weight", None) is None
            or getattr(bn, "bias", None) is None
            or conv._groups != 1 or padded
            or any(s != 1 for s in conv._stride)
            or any(k != 1 for k in conv._kernel_size)):
        return None
    cin, cout = int(w.shape[-2]), int(w.shape[-1])
    use_batch = training and not bn._use_global_stats
    if use_batch and cin > cout:
        return None
    lead = tuple(x.shape[:-1])
    m = math.prod(lead)
    x2, w2 = x.view(m, cin), w.view(cin, cout)
    if use_batch:
        mean, var = conv1x1_batch_stats(x2, w2)
        mom = bn._momentum
        with torch.no_grad():
            unbiased = var * (m / max(m - 1.0, 1.0))
            bn._mean.copy_(bn._mean * mom + mean * (1.0 - mom))
            bn._variance.copy_(bn._variance * mom + unbiased * (1.0 - mom))
    else:
        mean, var = bn._mean, bn._variance
    scale = bn.weight.float() * torch.rsqrt(var.float() + bn._epsilon)
    shift = bn.bias.float() - mean.float() * scale
    r2 = None if residual is None else residual.view(m, cout)
    y2 = fused_conv1x1_bn_act(x2, w2, scale, shift, r2, True)
    return y2.view(*lead, cout)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        kw = dict(device=device, dtype=dtype)
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                            bias_attr=False, generator=generator, **kw)
        self.bn1 = norm_layer(planes, **kw)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            generator=generator, **kw)
        self.bn2 = norm_layer(planes, **kw)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        kw = dict(device=device, dtype=dtype)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False,
                            generator=generator, **kw)
        self.bn1 = norm_layer(width, **kw)
        self.conv2 = Conv2D(width, width, 3, padding=dilation, stride=stride,
                            groups=groups, dilation=dilation, bias_attr=False,
                            generator=generator, **kw)
        self.bn2 = norm_layer(width, **kw)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, generator=generator, **kw)
        self.bn3 = norm_layer(planes * self.expansion, **kw)
        self.relu = ReLU()
        self.downsample = downsample
        self.stride = stride
        self._fused = False

    def forward(self, x):
        if self._fused:
            out = self._forward_fused(x)
            if out is not None:
                return out
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)

    def _forward_fused(self, x):
        """The bottleneck with both 1x1 chains through the fused kernel
        (NHWC only; None for an OIHW block, whose caller runs the plain
        path). A chain the fused route does not take runs the plain ops,
        as the reference."""
        if self.conv1._weight_format != "HWIO":
            return None
        out = _fused_conv1x1_bn(x, self.conv1, self.bn1,
                                training=self.training)
        if out is None:
            out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        identity = x if self.downsample is None else self.downsample(x)
        fused3 = _fused_conv1x1_bn(out, self.conv3, self.bn3, identity,
                                   training=self.training)
        if fused3 is None:
            return self.relu(self.bn3(self.conv3(out)) + identity)
        return fused3


def space_to_depth(x, block_size, data_format="NCHW"):
    """NCHW: [B, C, H, W] -> [B, C*b*b, H/b, W/b]; NHWC: [B, H, W, C] ->
    [B, H/b, W/b, C*b*b]. The channel index is (c, di, dj) in both layouts,
    so ``s2d_weights_from_7x7`` kernels serve either (up to the OIHW ->
    HWIO transpose)."""
    b = int(block_size)
    if data_format == "NHWC":
        n, h, w, c = x.shape
        x = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(n, h // b, w // b, c * b * b)
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


class SpaceToDepthStem(nn.Module):
    """The 7x7/2 stem conv as an exactly equivalent 4x4/1 conv over the
    input packed 2x2 pixels into 12 channels (padding [2, 1, 2, 1]): pad
    the 7x7 kernel to 8x8 with a zero row on top and a zero column on the
    left, then regroup its taps by pixel parity (``s2d_weights_from_7x7``).
    The parameter is ``conv.weight``, as the reference's."""

    def __init__(self, out_channels=64, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.conv = Conv2D(12, out_channels, 4, stride=1,
                           padding=[2, 1, 2, 1], bias_attr=False,
                           device=device, dtype=dtype, generator=generator)

    def forward(self, x):
        cl = self.conv._weight_format == "HWIO"
        h, w = (x.shape[1], x.shape[2]) if cl else (x.shape[2], x.shape[3])
        if h % 2 or w % 2:
            raise ValueError(
                f"SpaceToDepthStem needs even input H/W (got {h}x{w}): the "
                "2x2 pixel packing has no exact 7x7/s2 equivalent on odd "
                "sizes; pad the input or use the default stem "
                "(s2d_stem=False)")
        return self.conv(space_to_depth(x, 2, "NHWC" if cl else "NCHW"))


def s2d_weights_from_7x7(w7):
    """A [O, 3, 7, 7] stem kernel as the exactly equivalent [O, 12, 4, 4]
    space-to-depth kernel (numpy in, numpy out)."""
    w7 = np.asarray(w7)
    o = w7.shape[0]
    w = np.zeros((o, 12, 4, 4), w7.dtype)
    for c in range(3):
        for di in range(2):
            for dj in range(2):
                for p in range(4):
                    for q in range(4):
                        u, v = 2 * p + di - 1, 2 * q + dj - 1
                        if 0 <= u < 7 and 0 <= v < 7:
                            w[:, c * 4 + di * 2 + dj, p, q] = w7[:, c, u, v]
    return w


class ResNet(nn.Module):
    """ref: ResNet(block, depth, width, num_classes, with_pool, groups,
    s2d_stem, layout, fused_bottleneck), plus ``device``, ``dtype`` and
    ``generator``."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, s2d_stem=False, layout="auto",
                 fused_bottleneck=False, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = model_kw(device, dtype, generator)
        self._layout = "NCHW"  # built in the reference layout first
        self._fused_bottleneck = False
        target_layout = _resolve_layout(layout, kw["device"])
        if fused_bottleneck and target_layout != "NHWC":
            raise ValueError(
                "fused_bottleneck requires the NHWC layout (pass "
                "layout='NHWC', or 'auto' for a model on CUDA): the fused "
                "kernel consumes channels-last 1x1 convs")
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self._kw = kw
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = BatchNorm2D
        self.inplanes = 64
        self.dilation = 1
        dk = dict(device=kw["device"], dtype=kw["dtype"])
        if s2d_stem:
            self.conv1 = SpaceToDepthStem(self.inplanes,
                                          generator=kw["generator"], **dk)
        else:
            self.conv1 = Conv2D(3, self.inplanes, kernel_size=7, stride=2,
                                padding=3, bias_attr=False,
                                generator=kw["generator"], **dk)
        self.bn1 = self._norm_layer(self.inplanes, **dk)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes,
                             generator=kw["generator"], **dk)
        if target_layout == "NHWC":
            self.convert_to_nhwc()
        if fused_bottleneck:
            self._arm_fused_bottleneck()

    def convert_to_nhwc(self):
        """Switch the whole stack to channels-last in place: conv kernels
        re-stored HWIO, BatchNorm over the trailing axis, pools
        channels-last. The forward still takes and returns NCHW. Call
        after loading an NCHW state; idempotent."""
        to_channels_last(self)
        self._layout = "NHWC"
        return self

    def _arm_fused_bottleneck(self):
        if self._layout != "NHWC":
            raise ValueError("fused_bottleneck requires the NHWC layout "
                             "(convert_to_nhwc() first)")
        self._fused_bottleneck = True
        for sub in self.modules():
            if isinstance(sub, BottleneckBlock):
                sub._fused = True
        return self

    def _make_layer(self, block, planes, blocks, stride=1):
        dk = dict(device=self._kw["device"], dtype=self._kw["dtype"])
        gen = self._kw["generator"]
        norm_layer = self._norm_layer
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, generator=gen, **dk),
                norm_layer(planes * block.expansion, **dk),
            )
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, self.dilation,
                        norm_layer, generator=gen, **dk)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer, generator=gen, **dk))
        return Sequential(*layers)

    def forward(self, x):
        nhwc = self._layout == "NHWC"
        if nhwc:
            # the one transpose at entry: everything below is channels-last
            x = x.permute(0, 2, 3, 1).contiguous()
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            if nhwc and not self.with_pool:
                # flatten order must match the NCHW-trained fc
                x = x.permute(0, 3, 1, 2)
            x = torch.flatten(x, 1)
            x = self.fc(x)
        elif nhwc:
            x = x.permute(0, 3, 1, 2)  # feature maps leave as NCHW
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained and not isinstance(pretrained, bool):
        # checkpoints hold the reference's NCHW/OIHW state: build NCHW,
        # load, then convert (the kernels transpose losslessly)
        device = resolve_device(kwargs.get("device"))
        layout = _resolve_layout(kwargs.pop("layout", "auto"), device)
        fused = kwargs.pop("fused_bottleneck", False)
        if fused and layout != "NHWC":
            raise ValueError("fused_bottleneck requires the NHWC layout")
        model = load_pretrained(
            lambda: ResNet(block, depth, layout="NCHW", **kwargs),
            pretrained, arch=f"resnet{depth}")
        if layout == "NHWC":
            model.convert_to_nhwc()
            if fused:
                model._arm_fused_bottleneck()
        return model
    return load_pretrained(lambda: ResNet(block, depth, **kwargs),
                           pretrained, arch=f"resnet{depth}")


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    kwargs["groups"] = 32
    kwargs["width"] = 4
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    kwargs["groups"] = 32
    kwargs["width"] = 4
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    kwargs["groups"] = 64
    kwargs["width"] = 4
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    kwargs["groups"] = 64
    kwargs["width"] = 4
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)
