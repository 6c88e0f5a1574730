"""Shared pieces of the port's classification zoo (counterpart of
``paddle_tpu/vision/models/_utils.py``): ``load_pretrained`` and
``ConvBNLayer``."""
from __future__ import annotations

import os

from torch import nn

from ...nn.layers_activation import Hardswish, ReLU, ReLU6, Swish
from ...nn.layers_conv import Conv2D
from ...nn.layers_norm import BatchNorm2D

__all__ = ["load_pretrained", "check_pretrained", "ConvBNLayer", "split_kw"]


def load_pretrained(model, pretrained, arch=None):
    """ref: load_pretrained — the zoo factories' ``pretrained`` argument.

    ``pretrained=False`` builds the model with its random weights. A path
    (str or os.PathLike) builds it and loads the checkpoint through
    ``serialization.load_into``, strictly: every parameter and buffer
    must be in the file. A file either package saved loads; a plain-pickle
    reference-framework ``.pdparams`` raises as ``serialization.load``
    does. ``pretrained=True`` raises NotImplementedError: it needs a
    download, which the reference refuses too.

    ``model`` is a built module or a zero-argument factory; the factory
    is called only after the ``pretrained=True`` check."""
    def build():
        return model() if callable(model) and not isinstance(
            model, nn.Module) else model

    if not pretrained:
        return build()
    if isinstance(pretrained, (str, os.PathLike)):
        from ...serialization import load_into
        built = build()
        load_into(built, pretrained)
        return built
    name = arch or (type(model).__name__ if isinstance(model, nn.Module)
                    else "Model")
    raise NotImplementedError(
        f"pretrained=True needs a weights download, which this package "
        f"does not do. Save the weights with paddle.save({name}("
        f"pretrained=True).state_dict(), '{name}.pdparams') where they "
        f"can be downloaded, copy the file here and pass "
        f"pretrained='{name}.pdparams'")


# the reference's older name for the same function
check_pretrained = load_pretrained


class ConvBNLayer(nn.Module):
    """ref: ConvBNLayer — Conv2D (no bias) + BatchNorm2D + an optional
    activation ('relu', 'relu6', 'hardswish', 'swish' or None)."""

    _ACTS = {"relu": ReLU, "relu6": ReLU6, "hardswish": Hardswish,
             "swish": Swish, None: None}

    def __init__(self, in_c, out_c, k, stride=1, padding=0, groups=1,
                 act="relu", *, device=None, dtype=None, generator=None):
        super().__init__()
        self.conv = Conv2D(in_c, out_c, k, stride=stride, padding=padding,
                           groups=groups, bias_attr=False, device=device,
                           dtype=dtype, generator=generator)
        self.bn = BatchNorm2D(out_c, device=device, dtype=dtype)
        self.act = self._ACTS[act]() if self._ACTS[act] else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act else x


def split_kw(kw):
    """``model_kw``'s dict -> (itself, the device and dtype alone): what
    a BatchNorm takes, which draws no initial weights."""
    return kw, dict(device=kw["device"], dtype=kw["dtype"])
