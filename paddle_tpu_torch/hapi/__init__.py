"""hapi subset of the port (counterpart of ``paddle_tpu/hapi``): the
training ``Engine``."""
from .engine import Engine  # noqa: F401
