"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package stays the reference; this package mirrors its module
paths and names. It imports torch only. Entry points run on CUDA unless
the caller passes ``device="cpu"``; the TPU's Pallas kernels become
hand-written CUDA C++ kernels for Hopper (``csrc/``), each with a plain
PyTorch twin that the CPU runs.

Ported so far: GPT serving (``nlp.serving.ServingEngine`` over
``nlp.paged_cache``) and ``generate()`` for GPT and Llama; training
through ``hapi.engine.Engine`` (or eager ``loss.backward()`` +
``optimizer.step()``) of GPT (up to gpt3-1.3B), ERNIE/BERT pretraining
and ResNet; ResNet serving; and the high-level API, ``Model(net).prepare(
...).fit/evaluate/predict/save/load`` over ``io.DataLoader``, with
``metric``, the callbacks, ``summary``/``flops``, ``save``/``load`` in the
reference's file format, and ``vision`` (datasets, transforms, LeNet,
ResNet); detection serving (``vision.models`` PP-YOLOE and DETR, over
``nn``'s transformer layers) and ``incubate.fuse_conv_bn``; detection
training; the classification zoo (VGG, AlexNet, SqueezeNet, MobileNet
v1/v2/v3, DenseNet, ShuffleNetV2, GoogLeNet, Inception v3; every
factory takes ``pretrained=<a checkpoint path>``) and ``vision.ops``;
float16 AMP training with ``amp.GradScaler`` and ``resilience.TrainGuard``
(skip, snapshot and rollback), and ``amp.decorate``'s O2.
ROADMAP.md lists what is still to come.
"""
from .framework import (bind_generator, convert_dtype,  # noqa: F401
                        get_default_dtype, seed, set_default_dtype)
from .device import resolve_device  # noqa: F401
from . import nn  # noqa: E402,F401
from . import optimizer  # noqa: E402,F401
from . import metric  # noqa: E402,F401
from . import io  # noqa: E402,F401
from . import vision  # noqa: E402,F401
from . import incubate  # noqa: E402,F401
from . import amp  # noqa: E402,F401
from . import resilience  # noqa: E402,F401
from . import observability  # noqa: E402,F401
from . import static  # noqa: E402,F401
from .hapi.model import Model  # noqa: E402,F401
from .hapi.summary import summary, flops  # noqa: E402,F401
from .serialization import save, load  # noqa: E402,F401
from .hapi import callbacks  # noqa: E402,F401  (ref: paddle.callbacks)

__version__ = "0.1.0"
