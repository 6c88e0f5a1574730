"""paddle.optimizer subset of the port (counterpart of
``paddle_tpu/optimizer``): Adam, AdamW and the LR schedulers."""
from . import lr  # noqa: F401
from .optimizer import Adam, AdamW, Optimizer  # noqa: F401
