"""paddle.incubate of the port (counterpart of ``paddle_tpu/incubate``):
``fuse_conv_bn``, the serving fold of a frozen BatchNorm into the
convolution before it. The optimizer extensions (``LookAhead``,
``ModelAverage``, ``EMA``) and ``incubate.nn`` come with ROADMAP.md queue
1 item 11."""
from .fuse import fuse_conv_bn  # noqa: F401

__all__ = ["fuse_conv_bn"]
