"""Tensor-parallel layers of the port, single-device subset (counterpart
of ``paddle_tpu/distributed/fleet/mpu.py``).

On one device the reference's mp layers are dense layers; they keep their
names and ``[in, out]`` weights here so GPT's ``state_dict`` matches. No
collectives yet: sharding over several cards comes with the distributed
slice (ROADMAP.md).
"""
from __future__ import annotations

import torch

from torch import nn

from ...nn import functional as F
from ...nn.layers_common import Embedding, Linear

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "parallel_matmul"]


class _ParallelLinear(Linear):
    """``Linear`` under the reference's ``(in_features, out_features,
    weight_attr, has_bias)``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, **kw):
        super().__init__(in_features, out_features, weight_attr,
                         None if has_bias else False, **kw)


class ColumnParallelLinear(_ParallelLinear):
    """Linear whose output dim the reference splits over 'mp'; dense on
    one device."""


class RowParallelLinear(_ParallelLinear):
    """Linear whose input dim the reference splits over 'mp'; dense on
    one device."""


class VocabParallelEmbedding(Embedding):
    """Embedding with the vocab dim the reference splits over 'mp';
    dense on one device. Default init Normal(0, 0.02) as the reference."""

    def __init__(self, num_embeddings, embedding_dim, *, init_std=0.02,
                 **kw):
        super().__init__(num_embeddings, embedding_dim, init_std=init_std,
                         **kw)


def parallel_matmul(x, weight, transpose_y=False):
    """Logits against a (vocab-parallel) table: x @ weight(.T) — the tied
    LM head."""
    return torch.matmul(x, weight.t() if transpose_y else weight)


class ParallelCrossEntropy(nn.Module):
    """Softmax cross entropy per position over the (vocab-parallel)
    logits, the reference's single-device path: f32 log-softmax, 0 where
    label == ignore_index. Returns the unreduced [...] f32 loss."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits, label):
        return F.cross_entropy(logits, label, ignore_index=self.ignore_index,
                               reduction="none")
