"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package stays the reference; this package mirrors its module
paths and names. It imports torch only. Entry points run on CUDA unless
the caller passes ``device="cpu"``; the TPU's Pallas kernels become
hand-written CUDA C++ kernels for Hopper (``csrc/``), each with a plain
PyTorch twin that the CPU runs.

Ported so far: the serving path of GPT (``nlp.serving.ServingEngine``
over ``nlp.paged_cache``), with the flash-attention forward and paged
decode kernels; and its training path (``hapi.engine.Engine`` or eager
``loss.backward()`` + ``optimizer.step()``), with the flash-attention
backward kernels, in-kernel attention dropout and the one-pass AdamW
kernel. ROADMAP.md lists what is still to come.
"""
from .framework import (bind_generator, convert_dtype,  # noqa: F401
                        get_default_dtype, seed, set_default_dtype)
from .device import resolve_device  # noqa: F401

__version__ = "0.1.0"
