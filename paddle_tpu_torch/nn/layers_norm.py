"""Normalisation layers of the port (counterpart of
``paddle_tpu/nn/layers_norm.py``): ``LayerNorm``, ``RMSNorm``,
``BatchNorm2D``."""
from __future__ import annotations

import torch
from torch import nn

from ..framework import convert_dtype, get_default_dtype
from . import functional as F
from .layers_common import make_param, refuse_attr

__all__ = ["LayerNorm", "RMSNorm", "BatchNorm2D"]

_CHANNELS_LAST_BN = {"NCL": "NLC", "NCHW": "NHWC", "NCDHW": "NDHWC"}


class LayerNorm(nn.Module):
    """ref: nn.LayerNorm — weight ones, bias zeros, over the trailing
    ``normalized_shape``; ``weight_attr``/``bias_attr`` False drops
    one. ``name`` is taken and ignored."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__()
        refuse_attr("LayerNorm", weight_attr=weight_attr,
                    bias_attr=bias_attr)
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else make_param(
            self._normalized_shape, device=device, dtype=dtype, init="ones")
        self.bias = None if bias_attr is False else make_param(
            self._normalized_shape, device=device, dtype=dtype)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class RMSNorm(nn.Module):
    """ref: nn.RMSNorm — weight ones over the last dim, f32 statistics
    (``F.rms_norm``)."""

    def __init__(self, hidden_size, epsilon=1e-6, name=None, *, device=None,
                 dtype=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = make_param((hidden_size,), device=device, dtype=dtype,
                                 init="ones")

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class _BatchNormBase(nn.Module):
    """ref: _BatchNormBase — weight ones and bias zeros (``weight_attr`` /
    ``bias_attr`` False drops them), buffers ``_mean`` (zeros) and
    ``_variance`` (ones), Paddle's momentum convention (``F.batch_norm``).
    Under a bf16 or fp16 dtype the running statistics stay f32, as the
    reference keeps them: momentum-0.9 updates underflow an 8-bit
    mantissa."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__()
        refuse_attr(type(self).__name__, weight_attr=weight_attr,
                    bias_attr=bias_attr)
        if not (data_format.startswith("NC") or data_format.endswith("C")):
            raise ValueError(
                f"unsupported BatchNorm data_format {data_format!r}: "
                "expected a channels-first NC* or channels-last N*C spec")
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        dtype = convert_dtype(dtype) or get_default_dtype()
        self.weight = None if weight_attr is False else make_param(
            (num_features,), device=device, dtype=dtype, init="ones")
        self.bias = None if bias_attr is False else make_param(
            (num_features,), device=device, dtype=dtype)
        stat = torch.float32 if dtype in (torch.float16,
                                          torch.bfloat16) else dtype
        self.register_buffer("_mean", torch.zeros(
            num_features, device=device, dtype=stat))
        self.register_buffer("_variance", torch.ones(
            num_features, device=device, dtype=stat))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def to_channels_last(self):
        """Normalise over the trailing axis. The statistics and affine
        parameters are per-channel vectors either way. Idempotent."""
        self._data_format = _CHANNELS_LAST_BN.get(self._data_format,
                                                  self._data_format)
        return self

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}, {self._data_format}")


class BatchNorm2D(_BatchNormBase):
    """ref: nn.BatchNorm2D."""
