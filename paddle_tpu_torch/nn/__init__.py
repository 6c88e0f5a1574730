"""paddle.nn subset of the port (counterpart of ``paddle_tpu/nn``)."""
from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm  # noqa: F401
from .layers_activation import (Hardsigmoid, Hardswish,  # noqa: F401
                                ReLU, ReLU6, Sigmoid, Silu, Swish)
from .layers_common import (Dropout, Embedding, Identity,  # noqa: F401
                            LayerList, Linear, Sequential)
from .layers_conv import Conv2D, to_channels_last  # noqa: F401
from .layers_loss import CrossEntropyLoss  # noqa: F401
from .layers_norm import BatchNorm2D, LayerNorm, RMSNorm  # noqa: F401
from .layers_pooling import (AdaptiveAvgPool2D, AvgPool2D,  # noqa: F401
                             MaxPool2D)
from .layers_transformer import (MultiHeadAttention,  # noqa: F401
                                 Transformer, TransformerDecoder,
                                 TransformerDecoderLayer, TransformerEncoder,
                                 TransformerEncoderLayer)
