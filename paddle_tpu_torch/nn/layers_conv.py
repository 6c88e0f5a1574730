"""Convolution layers of the port (counterpart of
``paddle_tpu/nn/layers_conv.py``): ``Conv2D`` and the channels-last
conversion.

Weight layouts are the reference's: a convolution's kernel is OIHW
([out, in/groups, kh, kw]) and, after ``to_channels_last()``, HWIO
([kh, kw, in/groups, out]) with the NHWC data format, so a reference
``state_dict`` in either layout loads key for key with no transposes. The
default initialisation is the reference's, Xavier-uniform over the fans of
the OIHW kernel, drawn OIHW first so a seeded build is the same in both
layouts. Conv1D, Conv3D and the transposed convolutions raise.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..framework import later
from . import functional as F
from .layers_common import make_param

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "to_channels_last"]

_CHANNELS_LAST_FMT = {2: "NHWC"}


def _ntuple(v, n):
    if isinstance(v, int):
        return (int(v),) * n
    return tuple(int(i) for i in v)


class _ConvNd(nn.Module):
    """ref: _ConvNd for a forward convolution over n = 2 spatial axes."""

    def __init__(self, in_channels, out_channels, kernel_size, n, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        if weight_attr is not None or bias_attr not in (None, False):
            raise NotImplementedError(f"Conv2D weight_attr/bias_attr "
                                      f"(nn/initializer.py) {later('1.6')}")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, n)
        self._stride = _ntuple(stride, n)
        self._padding = padding
        self._dilation = _ntuple(dilation, n)
        self._groups = groups
        self._data_format = data_format
        self._n = n
        self._transpose = False
        self._padding_mode = padding_mode
        self._weight_format = "OIHW"
        shape = (out_channels, in_channels // groups) + self._kernel_size
        rf = math.prod(self._kernel_size)
        self.weight = make_param(shape, device=device, dtype=dtype,
                                 init="xavier", generator=generator,
                                 fans=(shape[1] * rf, shape[0] * rf))
        self.bias = None if bias_attr is False else make_param(
            (out_channels,), device=device, dtype=dtype)

    def to_channels_last(self):
        """Re-store the kernel HWIO in place ([*k, in/groups, out]) and
        switch to the channels-last data format. Idempotent."""
        if self._weight_format != "HWIO":
            perm = tuple(range(2, 2 + self._n)) + (1, 0)
            with torch.no_grad():
                self.weight.data = self.weight.data.permute(
                    *perm).contiguous()
            self._weight_format = "HWIO"
        self._data_format = _CHANNELS_LAST_FMT[self._n]
        return self

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}, "
                f"{self._data_format}/{self._weight_format}")


class Conv2D(_ConvNd):
    """ref: nn.Conv2D."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device=device, dtype=dtype,
                         generator=generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format, weight_format=self._weight_format)


def _not_ported(name):
    class _Later(nn.Module):
        def __init__(self, *args, **kwargs):
            raise NotImplementedError(f"nn.{name} {later('6')}")
    _Later.__name__ = _Later.__qualname__ = name
    return _Later


Conv1D = _not_ported("Conv1D")
Conv3D = _not_ported("Conv3D")
Conv1DTranspose = _not_ported("Conv1DTranspose")
Conv2DTranspose = _not_ported("Conv2DTranspose")
Conv3DTranspose = _not_ported("Conv3DTranspose")


def to_channels_last(layer):
    """Convert a module tree in place to channels-last: convolutions get
    HWIO kernels and NHWC, BatchNorms normalise the trailing axis, pools
    window the middle axes. The caller owns the single transpose at entry
    and exit. Returns (layer, number of layers converted)."""
    from .layers_norm import _BatchNormBase
    from .layers_pooling import AdaptiveAvgPool2D, _Pool
    n = 0
    for sub in layer.modules():
        if isinstance(sub, (_ConvNd, _BatchNormBase)):
            sub.to_channels_last()
            n += 1
        elif isinstance(sub, _Pool):
            fmt = sub._kw.get("data_format")
            if fmt and not fmt.endswith("C"):
                sub._kw["data_format"] = _CHANNELS_LAST_FMT[len(fmt) - 2]
                n += 1
        elif isinstance(sub, AdaptiveAvgPool2D):
            if not sub._data_format.endswith("C"):
                sub._data_format = _CHANNELS_LAST_FMT[
                    len(sub._data_format) - 2]
                n += 1
    return layer, n
