"""fleet subset of the port: the single-device mp layers."""
from .mpu import (ColumnParallelLinear, ParallelCrossEntropy,  # noqa: F401
                  RowParallelLinear, VocabParallelEmbedding,
                  parallel_matmul)
