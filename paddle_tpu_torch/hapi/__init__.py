"""hapi of the port (counterpart of ``paddle_tpu/hapi``): the training
``Engine``, ``Model``, the callbacks, ``summary`` and ``flops``."""
from . import callbacks  # noqa: F401
from .engine import Engine  # noqa: F401
from .model import Model  # noqa: F401
from .summary import flops, summary  # noqa: F401
