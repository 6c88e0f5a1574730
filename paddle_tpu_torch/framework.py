"""Core framework state of the PyTorch port: default dtype and seeding.

Counterpart of ``paddle_tpu/framework.py``. The JAX package keeps a global
PRNG key stream (``next_rng_key``); here randomness is an explicit
``torch.Generator`` that the caller creates (``seed``) and passes to
whatever draws from it. A model holds one generator on its device, from
which hidden dropout and the attention-dropout seed both draw;
``bind_generator`` points a model at another one (an Engine's), and
``generators`` lists the ones a model draws from, which a CUDA graph that
records its step must know (``hapi.Engine`` registers each with the
graph, so every replay draws new dropout masks and flash seeds).
"""
from __future__ import annotations

import torch

from .device import resolve_device

__all__ = ["convert_dtype", "get_default_dtype", "set_default_dtype", "seed",
           "bind_generator", "generators", "later"]

_DTYPE_ALIASES = {
    "float16": torch.float16, "fp16": torch.float16,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float32": torch.float32, "fp32": torch.float32, "float": torch.float32,
    "float64": torch.float64, "int8": torch.int8, "int32": torch.int32,
    "int64": torch.int64, "bool": torch.bool,
}

_default_dtype = torch.float32


def convert_dtype(dtype):
    """Normalise a dtype spec (str or torch.dtype) to a torch.dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype)
    if name not in _DTYPE_ALIASES:
        raise ValueError(f"unknown dtype {dtype!r}")
    return _DTYPE_ALIASES[name]


def get_default_dtype():
    return _default_dtype


def set_default_dtype(dtype):
    global _default_dtype
    _default_dtype = convert_dtype(dtype)


def seed(s=None, device=None, generator=None):
    """ref: paddle.seed. Returns a ``torch.Generator`` on ``device`` (CUDA
    by default, see ``device.resolve_device``) seeded with ``s``; with
    ``generator`` given, reseeds that one instead. With ``s=None`` the
    generator draws a nondeterministic seed."""
    g = generator if generator is not None else torch.Generator(
        device=resolve_device(device))
    if s is None:
        g.seed()
    else:
        g.manual_seed(int(s))
    return g


def bind_generator(module, generator):
    """Point every submodule of ``module`` that draws random numbers (one
    with a ``generator`` attribute: ``nn.Dropout``, GPT's attention) at
    ``generator``. Returns the module."""
    for m in module.modules():
        if hasattr(m, "generator"):
            m.generator = generator
    return module


def generators(*modules):
    """The distinct ``torch.Generator`` objects that the submodules of
    ``modules`` draw from (their ``generator`` attributes), in the order
    first met."""
    found = {}
    for mod in modules:
        for m in mod.modules():
            g = getattr(m, "generator", None)
            if isinstance(g, torch.Generator):
                found.setdefault(id(g), g)
    return list(found.values())


def later(item):
    """The tail of a NotImplementedError for a part of the reference that
    is not ported yet: names the ROADMAP.md queue 1 item that holds it."""
    return f"is not ported yet (see ROADMAP.md, queue 1 item {item})"
