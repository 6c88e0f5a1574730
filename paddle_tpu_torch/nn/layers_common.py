"""Common layers of the port (counterpart of
``paddle_tpu/nn/layers_common.py``): ``Linear``, ``Embedding``,
``Dropout``, ``LayerList``, ``Sequential``, ``Identity``.

Parameter names and shapes are the reference's (``Linear.weight`` is
``[in, out]``), so ``state_dict`` keys match key for key. Every layer
takes an explicit ``device`` and ``dtype``; initialisation draws from an
explicit ``torch.Generator`` on that device (None: torch's default), and
``Dropout`` draws only from the generator it holds.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from . import functional as F

__all__ = ["Linear", "Embedding", "Dropout", "LayerList", "Sequential",
           "Identity", "make_param"]


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
    """ref: nn.Linear — weight [in_features, out_features]. ``init_std``
    None draws Xavier-uniform weights, else Normal(0, init_std)."""

    def __init__(self, in_features, out_features, bias=True, *,
                 init_std=None, device=None, dtype=None, generator=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = make_param(
            (in_features, out_features), device=device, dtype=dtype,
            init="xavier" if init_std is None else "normal",
            std=init_std or 0.0, generator=generator)
        self.bias = make_param((out_features,), device=device,
                               dtype=dtype) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """ref: nn.Embedding — weight [num_embeddings, embedding_dim]."""

    def __init__(self, num_embeddings, embedding_dim, *, init_std=1.0,
                 device=None, dtype=None, generator=None):
        super().__init__()
        self.weight = make_param((num_embeddings, embedding_dim),
                                 device=device, dtype=dtype, init="normal",
                                 std=init_std, generator=generator)

    def forward(self, x):
        return F.embedding(x, self.weight)


class Dropout(nn.Module):
    """ref: nn.Dropout (upscale in train). Draws its mask from
    ``generator``, given at construction or bound later by the model or
    the Engine (``framework.bind_generator``); training with p > 0 and no
    generator raises."""

    def __init__(self, p=0.5, *, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, p=self.p, training=self.training,
                         generator=self.generator)


class LayerList(nn.ModuleList):
    """ref: nn.LayerList — sublayers named '0', '1', ..."""


class Sequential(nn.Sequential):
    """ref: nn.Sequential — sublayers named '0', '1', ... in call order."""


class Identity(nn.Identity):
    """ref: nn.Identity."""
