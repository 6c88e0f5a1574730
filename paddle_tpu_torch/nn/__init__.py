"""paddle.nn subset of the port (counterpart of ``paddle_tpu/nn``)."""
from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm  # noqa: F401
from .layers_common import Dropout, Embedding, LayerList, Linear  # noqa: F401
from .layers_norm import LayerNorm, RMSNorm  # noqa: F401
