"""Vision models of the port (counterpart of ``paddle_tpu/vision``): the
ResNet family so far."""
from . import models  # noqa: F401
