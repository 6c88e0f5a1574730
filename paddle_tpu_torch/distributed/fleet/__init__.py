"""fleet subset of the port: the single-device mp layers."""
from .mpu import (ColumnParallelLinear, RowParallelLinear,  # noqa: F401
                  VocabParallelEmbedding, parallel_matmul)
