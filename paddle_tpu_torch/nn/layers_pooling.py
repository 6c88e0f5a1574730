"""Pooling layers of the port (counterpart of
``paddle_tpu/nn/layers_pooling.py``): ``MaxPool2D``, ``AvgPool2D`` and
``AdaptiveAvgPool2D``, with the reference's ``_kw["data_format"]`` and
``_data_format`` that ``layers_conv.to_channels_last`` rewrites."""
from __future__ import annotations

from torch import nn

from . import functional as F

# ``name`` is taken and ignored, as in the reference

__all__ = ["MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D"]


class _Pool(nn.Module):
    """ref: _Pool — calls ``F.<fn>(x, kernel_size, stride, padding,
    **kw)``."""

    def __init__(self, fn, kernel_size=None, stride=None, padding=0, **kw):
        super().__init__()
        self._fn = fn
        self._kernel_size = kernel_size
        self._stride = stride
        self._padding = padding
        self._kw = kw

    def forward(self, x):
        return getattr(F, self._fn)(x, self._kernel_size, self._stride,
                                    self._padding, **self._kw)


class MaxPool2D(_Pool):
    """ref: nn.MaxPool2D."""

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__("max_pool2d", kernel_size, stride, padding,
                         return_mask=return_mask, ceil_mode=ceil_mode,
                         data_format=data_format)


class AvgPool2D(_Pool):
    """ref: nn.AvgPool2D (``exclusive`` by default: padding is not
    counted)."""

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__("avg_pool2d", kernel_size, stride, padding,
                         exclusive=exclusive, ceil_mode=ceil_mode,
                         data_format=data_format)


class AdaptiveAvgPool2D(nn.Module):
    """ref: nn.AdaptiveAvgPool2D."""

    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self._output_size = output_size
        self._data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self._output_size, self._data_format)
