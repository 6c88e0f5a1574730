"""Hand-written CUDA kernels (counterparts of ``paddle_tpu/ops/pallas``):
each module holds a kernel's wrapper, its launch counter and its plain
PyTorch twin."""
# the paged decode's module is named flash_decode (as the reference's
# ops/pallas/flash_decode.py); the package's ``flash_decode`` is the dense
# decode wrapper, bound after the imports below so that the submodule of
# that name never shadows it, whatever their order
from . import flash_attention as _fa
from . import flash_decode as _paged
from .conv_bn_act import conv_bn_act_plain, fused_conv1x1_bn_act  # noqa: F401
from .flash_decode import paged_decode_plain, paged_flash_decode  # noqa: F401
from .flash_attention import (flash_attention_bwd_dkv,  # noqa: F401
                              flash_attention_bwd_dq, flash_attention_fwd,
                              flash_attention_fwd_plain,
                              flash_decode_plain)
from .fused_adamw import (adamw_multi_update_plain,  # noqa: F401
                          adamw_update_plain, fused_adamw_multi_update)
from .fused_ln import (fused_add_layer_norm,  # noqa: F401
                       fused_add_layer_norm_bwd, fused_add_layer_norm_fwd,
                       fused_add_layer_norm_y, fused_add_layer_norm_y_bwd,
                       fused_add_layer_norm_y_fwd)

flash_decode = _fa.flash_decode

# every kernel wrapper of the port, for code that resets or reads all the
# launch counters at once
WRAPPERS = (flash_attention_fwd, flash_attention_bwd_dq,
            flash_attention_bwd_dkv, _fa.flash_decode,
            _paged.paged_flash_decode,
            fused_adamw_multi_update,
            fused_add_layer_norm_fwd,
            fused_add_layer_norm_bwd, fused_add_layer_norm_y_fwd,
            fused_add_layer_norm_y_bwd, fused_conv1x1_bn_act)
