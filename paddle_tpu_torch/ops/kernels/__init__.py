"""Hand-written CUDA kernels (counterparts of ``paddle_tpu/ops/pallas``):
each module holds a kernel's wrapper, its launch counter and its plain
PyTorch twin."""
from .flash_attention import (flash_attention_fwd,  # noqa: F401
                              flash_attention_fwd_plain)
from .flash_decode import paged_decode_plain, paged_flash_decode  # noqa: F401

# every kernel wrapper of the port, for code that resets or reads all the
# launch counters at once
WRAPPERS = (flash_attention_fwd, paged_flash_decode)
