"""paddle.optimizer subset of the port (counterpart of
``paddle_tpu/optimizer``): Momentum, Adam, AdamW and the LR
schedulers."""
from . import lr  # noqa: F401
from .optimizer import Adam, AdamW, Momentum, Optimizer  # noqa: F401
