"""Kernels and attention dispatch of the port (counterpart of
``paddle_tpu/ops``). ``_build`` compiles ``csrc/*.cu`` on first CUDA use;
nothing is built at import."""
from .attention import (flash_attention, flash_decode,  # noqa: F401
                        paged_flash_decode, reference_attention)
