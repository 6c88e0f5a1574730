"""ERNIE of the port, pretraining (counterpart of ``paddle_tpu/nlp/ernie.py``).

ERNIE is a BERT-style post-LN encoder plus an optional task-type
embedding (``use_task_id``, ERNIE 3.0), so it reuses the port's BERT
blocks, as the reference's ernie/modeling.py mirrors bert/modeling.py.
Parameter names match the reference key for key: ``ernie.*`` (the
backbone), ``cls.*`` (the MLM head, tied to the word embedding) and
``seq_relationship.*`` (NSP) — 207 keys for ernie-3.0-base-zh.

The four ERNIE task heads are BERT's (``nlp.bert._TaskHead``) with the
ERNIE backbone under ``ernie``, as the reference's are; every model class
loads a local checkpoint through ``from_pretrained``.

Not in this slice (each raises NotImplementedError, see ROADMAP.md): what
``nlp.bert`` leaves out.
"""
from __future__ import annotations

from dataclasses import dataclass

from torch import nn

from ..nn.layers_common import Embedding, Linear
from .bert import (BertConfig, BertEmbeddings, BertForMaskedLM,
                   BertForQuestionAnswering, BertForSequenceClassification,
                   BertForTokenClassification, BertLMPredictionHead,
                   BertModel, BertPretrainingCriterion)
from .modeling_utils import FromPretrainedMixin, model_kw

__all__ = ["ErnieConfig", "ERNIE_CONFIGS", "ErnieEmbeddings", "ErnieModel",
           "ErnieForPretraining", "ErniePretrainingCriterion",
           "ErnieForSequenceClassification", "ErnieForTokenClassification",
           "ErnieForQuestionAnswering", "ErnieForMaskedLM"]


@dataclass
class ErnieConfig(BertConfig):
    vocab_size: int = 40000
    task_type_vocab_size: int = 3
    use_task_id: bool = True
    pool_act: str = "tanh"


# ref: ernie/configuration.py ERNIE_PRETRAINED_INIT_CONFIGURATION
# (ernie-3.0-base-zh: 12L x 768; ernie-3.0-medium-zh: 6L x 768), as the
# reference package has them
ERNIE_CONFIGS = {
    "ernie-3.0-base-zh": dict(vocab_size=40000, hidden_size=768,
                              num_hidden_layers=12, num_attention_heads=12,
                              max_position_embeddings=2048),
    "ernie-3.0-medium-zh": dict(vocab_size=40000, hidden_size=768,
                                num_hidden_layers=6, num_attention_heads=12,
                                max_position_embeddings=2048),
    "ernie-3.0-mini-zh": dict(vocab_size=40000, hidden_size=384,
                              num_hidden_layers=6, num_attention_heads=12,
                              max_position_embeddings=2048),
    "ernie-1.0": dict(vocab_size=18000, hidden_size=768,
                      num_hidden_layers=12, num_attention_heads=12,
                      max_position_embeddings=513, use_task_id=False),
    "ernie-tiny": dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=4, max_position_embeddings=128,
                       hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0),
}


def _resolve_config(name, **overrides):
    cfg = dict(ERNIE_CONFIGS[name])
    cfg.update(overrides)
    return ErnieConfig(**cfg)


class ErnieEmbeddings(BertEmbeddings):
    """BertEmbeddings + the task-type embedding (ref ErnieEmbeddings)."""

    def __init__(self, config, *, device=None, dtype=None, generator=None):
        super().__init__(config, device=device, dtype=dtype,
                         generator=generator)
        self.use_task_id = config.use_task_id
        if config.use_task_id:
            self.task_type_embeddings = Embedding(
                config.task_type_vocab_size, config.hidden_size,
                init_std=config.initializer_range, device=device,
                dtype=dtype, generator=generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                task_type_ids=None):
        e = self.embed(input_ids, token_type_ids, position_ids)
        if self.use_task_id:
            e = e + self.task_type_embeddings(
                self.default_ids(input_ids, task_type_ids))
        return self.dropout(self.layer_norm(e))


class ErnieModel(BertModel):
    """ref: ernie/modeling.py ErnieModel — returns (sequence_output,
    pooled_output)."""

    config_cls = ErnieConfig
    embeddings_cls = ErnieEmbeddings

    @classmethod
    def from_config_name(cls, name, *, device=None, dtype=None,
                         generator=None, **overrides):
        return cls(_resolve_config(name, **overrides), device=device,
                   dtype=dtype, generator=generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, task_type_ids=None):
        x = self.embeddings(input_ids, token_type_ids, position_ids,
                            task_type_ids)
        return self.encode(x, attention_mask)


class ErnieForPretraining(FromPretrainedMixin, nn.Module):
    """ref: ErnieForPretraining — MLM + NSP heads: (prediction_scores [B,
    S, vocab], seq_relationship_score [B, 2])."""

    def __init__(self, config=None, *, device=None, dtype=None,
                 generator=None, **kwargs):
        super().__init__()
        kw = model_kw(device, dtype, generator)
        self.ernie = ErnieModel(config, **kw, **kwargs)
        self.config = self.ernie.config
        self.cls = BertLMPredictionHead(self.config, **kw)
        self.seq_relationship = Linear(
            self.config.hidden_size, 2,
            init_std=self.config.initializer_range, **kw)

    @classmethod
    def from_config_name(cls, name, *, device=None, dtype=None,
                         generator=None, **overrides):
        return cls(_resolve_config(name, **overrides), device=device,
                   dtype=dtype, generator=generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                                 attention_mask)
        return (self.cls(seq, self.ernie.embeddings.word_embeddings.weight),
                self.seq_relationship(pooled))


class ErniePretrainingCriterion(BertPretrainingCriterion):
    """ref: ErniePretrainingCriterion — the same contract as BERT's."""


class ErnieForSequenceClassification(BertForSequenceClassification):
    backbone_cls = ErnieModel
    backbone_attr = "ernie"
    _resolve = staticmethod(_resolve_config)


class ErnieForTokenClassification(BertForTokenClassification):
    backbone_cls = ErnieModel
    backbone_attr = "ernie"
    _resolve = staticmethod(_resolve_config)


class ErnieForQuestionAnswering(BertForQuestionAnswering):
    backbone_cls = ErnieModel
    backbone_attr = "ernie"
    _resolve = staticmethod(_resolve_config)


class ErnieForMaskedLM(BertForMaskedLM):
    backbone_cls = ErnieModel
    backbone_attr = "ernie"
    _resolve = staticmethod(_resolve_config)
