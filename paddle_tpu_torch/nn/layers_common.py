"""Common layers of the port (counterpart of
``paddle_tpu/nn/layers_common.py``): ``Linear``, ``Embedding``,
``Dropout``, ``LayerList``, ``Sequential``, ``Identity``.

Parameter names and shapes are the reference's (``Linear.weight`` is
``[in, out]``), so ``state_dict`` keys match key for key, and so are the
constructors' parameters, in the reference's order; the port's own
(``device``, ``dtype``, ``generator``, ``init_std``) are keyword-only.
Every layer takes an explicit ``device`` and ``dtype``; initialisation
draws from an explicit ``torch.Generator`` on that device (None: torch's
default), and ``Dropout`` draws only from the generator it holds.
``name`` is taken and ignored, as in the reference; a ``ParamAttr``
(``weight_attr``, or a ``bias_attr`` other than None/False) raises
NotImplementedError naming its item.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..framework import later
from . import functional as F

__all__ = ["Linear", "Embedding", "Dropout", "LayerList", "Sequential",
           "Identity", "make_param", "refuse_attr"]


def refuse_attr(layer, **attrs):
    """Raise NotImplementedError naming item 1.6 for a ``ParamAttr``
    (``nn/initializer.py`` is not ported): an attribute other than None,
    True (the default parameter) or False (no parameter, which the caller
    computes)."""
    for what, attr in attrs.items():
        if attr is not None and not isinstance(attr, bool):
            raise NotImplementedError(
                f"{layer}({what}=...) (ParamAttr, nn/initializer.py) "
                f"{later('1.6')}")


def make_param(shape, *, device, dtype, init="zeros", std=0.02,
               generator=None, fans=None):
    """A Parameter of ``shape`` filled by ``init``: 'zeros', 'ones',
    'normal' (mean 0, ``std``) or 'xavier' (uniform over fan_in +
    fan_out: ``fans``, by default the first and last dims)."""
    t = torch.empty(shape, device=device, dtype=dtype)
    with torch.no_grad():
        if init == "zeros":
            t.zero_()
        elif init == "ones":
            t.fill_(1.0)
        elif init == "normal":
            t.normal_(0.0, std, generator=generator)
        elif init == "xavier":
            fan_in, fan_out = fans or (shape[0], shape[-1])
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            t.uniform_(-bound, bound, generator=generator)
        else:
            raise ValueError(f"unknown init {init!r}")
    return nn.Parameter(t)


class Linear(nn.Module):
    """ref: nn.Linear — weight [in_features, out_features];
    ``bias_attr=False`` drops the bias. ``init_std`` None draws
    Xavier-uniform weights, else Normal(0, init_std)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, init_std=None, device=None,
                 dtype=None, generator=None):
        super().__init__()
        refuse_attr("Linear", weight_attr=weight_attr, bias_attr=bias_attr)
        self.in_features = in_features
        self.out_features = out_features
        self.weight = make_param(
            (in_features, out_features), device=device, dtype=dtype,
            init="xavier" if init_std is None else "normal",
            std=init_std or 0.0, generator=generator)
        self.bias = None if bias_attr is False else make_param(
            (out_features,), device=device, dtype=dtype)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """ref: nn.Embedding — weight [num_embeddings, embedding_dim]. With
    ``padding_idx`` that row starts at zero, reads as zero and gets no
    gradient, as in the reference; ``sparse=True`` raises."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *,
                 init_std=1.0, device=None, dtype=None, generator=None):
        super().__init__()
        refuse_attr("Embedding", weight_attr=weight_attr)
        F._refuse_sparse(sparse)
        self._padding_idx = padding_idx
        self.weight = make_param((num_embeddings, embedding_dim),
                                 device=device, dtype=dtype, init="normal",
                                 std=init_std, generator=generator)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)


class Dropout(nn.Module):
    """ref: nn.Dropout (``F.dropout``: ``axis``, ``mode``). Draws its mask
    from ``generator``, given at construction or bound later by the model
    or the Engine (``framework.bind_generator``); training with p > 0 and
    no generator raises."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 *, generator=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode, generator=self.generator)


class LayerList(nn.ModuleList):
    """ref: nn.LayerList(sublayers) — sublayers named '0', '1', ..."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class Sequential(nn.Sequential):
    """ref: nn.Sequential — sublayers named '0', '1', ... in call order."""


class Identity(nn.Identity):
    """ref: nn.Identity (``name_scope`` and ``dtype`` taken and
    ignored)."""

    def __init__(self, name_scope=None, dtype=None):
        super().__init__()
