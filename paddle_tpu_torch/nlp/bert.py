"""BERT of the port, pretraining (counterpart of ``paddle_tpu/nlp/bert.py``).

Same modules, parameter names and ``[in, out]`` weights as the reference,
so a JAX ``state_dict()`` loads key for key (``nlp.convert``). Post-LN
blocks (the reference's ``normalize_before=False``), separate q/k/v
projections, learned positions, token-type embeddings, a tanh pooler and
an MLM head tied to the word embedding.

Attention is bidirectional: ``F.scaled_dot_product_attention`` runs the
flash kernels with ``is_causal=False`` (on the card; their plain twins on
the CPU). A padding ``attention_mask`` (the tokenizer's 0/1 ``[B, S]``)
becomes a ``[B, 1, 1, S]`` keep-mask once a forward, on the model's
device, which every layer's kernels read in place.

``fused_ln=True`` fuses both residual adds of a block into the following
LayerNorm (``modeling_utils.fused_residual_ln`` with ``want_sum=False``:
the y-only fused residual-add + LayerNorm kernel on the card).

The tied decoder: the head multiplies by the word-embedding weight that
its model passes in at forward time (as the port's GPT head reads it),
so ``state_dict`` holds one copy and, under the Engine's AMP cast, the one
bf16 copy serves both uses and its gradient sums them.

Randomness as in the port's GPT: the model holds one ``torch.Generator``
on its device for its weights and, in training, hidden and attention
dropout.

The task heads (``_TaskHead``: ``BertForSequenceClassification``,
``...ForTokenClassification``, ``...ForQuestionAnswering``,
``...ForMaskedLM``) build the backbone under the reference's attribute
(``bert``; ERNIE's heads subclass them with ``ernie``), so their state
dicts are the reference's key for key; their dropout draws from the
model's generator. Every model class loads a local checkpoint through
``from_pretrained`` (``modeling_utils.FromPretrainedMixin``).

Not in this slice (each raises NotImplementedError, see ROADMAP.md):
``scan_layers``, ``fused_qkv``, ``mlm_gather_capacity > 0`` and
``use_flash_attention=False`` (the port has no plain attention path on
the card).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..distributed.fleet.mpu import (ColumnParallelLinear,
                                     ParallelCrossEntropy, RowParallelLinear,
                                     VocabParallelEmbedding, parallel_matmul)
from ..nn import functional as F
from ..nn.layers_common import Dropout, Embedding, LayerList, Linear
from ..nn.layers_norm import LayerNorm
from .modeling_utils import (FromPretrainedMixin, coerce_config,
                             fused_residual_ln, later, model_kw,
                             normalize_attention_mask)

__all__ = ["BertConfig", "BERT_CONFIGS", "BertSelfAttention", "BertLayer",
           "BertEmbeddings", "BertPooler", "BertModel",
           "BertLMPredictionHead", "BertPretrainingHeads",
           "BertForPretraining", "BertPretrainingCriterion",
           "BertForSequenceClassification", "BertForTokenClassification",
           "BertForQuestionAnswering", "BertForMaskedLM"]

@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 0  # 0 -> 4*hidden
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    pool_act: str = "tanh"
    use_flash_attention: bool = True
    num_labels: int = 2
    scan_layers: bool = False
    fused_qkv: bool = False
    fused_ln: bool = False
    mlm_gather_capacity: float = 0.0

    def __post_init__(self):
        if not self.intermediate_size:
            self.intermediate_size = 4 * self.hidden_size
        for flag, item in (("scan_layers", "4.3"), ("fused_qkv", "4.3"),
                           ("mlm_gather_capacity", "4.2")):
            if getattr(self, flag):
                raise NotImplementedError(f"{type(self).__name__}.{flag} "
                                          f"{later(item)}")
        if not self.use_flash_attention:
            raise NotImplementedError(
                f"{type(self).__name__}.use_flash_attention=False: the port "
                "has no plain attention path on the card (ROADMAP.md, "
                "ground rules: no fallback)")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


# ref: bert/configuration.py BERT_PRETRAINED_INIT_CONFIGURATION
BERT_CONFIGS = {
    "bert-base-uncased": dict(vocab_size=30522, hidden_size=768,
                              num_hidden_layers=12, num_attention_heads=12),
    "bert-large-uncased": dict(vocab_size=30522, hidden_size=1024,
                               num_hidden_layers=24, num_attention_heads=16),
    "bert-base-chinese": dict(vocab_size=21128, hidden_size=768,
                              num_hidden_layers=12, num_attention_heads=12),
    "bert-tiny": dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=4, max_position_embeddings=128,
                      hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0),
}


def _resolve_config(name, **overrides):
    cfg = dict(BERT_CONFIGS[name])
    cfg.update(overrides)
    return BertConfig(**cfg)


class BertSelfAttention(nn.Module):
    """Bidirectional multi-head attention: q/k/v column-parallel
    projections and a row-parallel output projection."""

    def __init__(self, config, **kw):
        super().__init__()
        self.cfg = config
        self.generator = kw.get("generator")  # the attention-dropout seed
        h = config.hidden_size
        std = config.initializer_range
        self.q_proj = ColumnParallelLinear(h, h, init_std=std, **kw)
        self.k_proj = ColumnParallelLinear(h, h, init_std=std, **kw)
        self.v_proj = ColumnParallelLinear(h, h, init_std=std, **kw)
        self.out_proj = RowParallelLinear(h, h, init_std=std, **kw)

    def _heads(self, x):
        return x.reshape(x.shape[0], x.shape[1], -1, self.cfg.head_dim)

    def forward(self, x, attn_mask=None):
        q = self._heads(self.q_proj(x))
        k = self._heads(self.k_proj(x))
        v = self._heads(self.v_proj(x))
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.cfg.attention_probs_dropout_prob
            if self.training else 0.0,
            is_causal=False, training=self.training,
            generator=self.generator)
        return self.out_proj(out.reshape(out.shape[0], out.shape[1], -1))


class BertLayer(nn.Module):
    """Post-LN encoder block (ref BERT normalize_before=False)."""

    def __init__(self, config, *, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.cfg = config
        eps = config.layer_norm_eps
        std = config.initializer_range
        self.attn = BertSelfAttention(config, **kw)
        self.dropout1 = Dropout(config.hidden_dropout_prob,
                                generator=generator)
        self.ln_1 = LayerNorm(config.hidden_size, epsilon=eps, device=device,
                              dtype=dtype)
        self.fc1 = ColumnParallelLinear(
            config.hidden_size, config.intermediate_size, init_std=std, **kw)
        self.fc2 = RowParallelLinear(
            config.intermediate_size, config.hidden_size, init_std=std, **kw)
        self.act = getattr(F, config.hidden_act)
        self.dropout2 = Dropout(config.hidden_dropout_prob,
                                generator=generator)
        self.ln_2 = LayerNorm(config.hidden_size, epsilon=eps, device=device,
                              dtype=dtype)

    def forward(self, x, attn_mask=None):
        h1 = self.dropout1(self.attn(x, attn_mask))
        if self.cfg.fused_ln:
            # post-LN fuses at both block sites, y = LN(x + h) being the
            # whole pattern; the sum is never written
            x = fused_residual_ln(x, h1, self.ln_1, want_sum=False)
            h2 = self.dropout2(self.fc2(self.act(self.fc1(x))))
            return fused_residual_ln(x, h2, self.ln_2, want_sum=False)
        x = self.ln_1(x + h1)
        return self.ln_2(x + self.dropout2(self.fc2(self.act(self.fc1(x)))))


class BertEmbeddings(nn.Module):
    """word (vocab-parallel) + position + token-type embeddings with a
    post-sum LayerNorm (ref bert/modeling.py BertEmbeddings)."""

    def __init__(self, config, *, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator,
                  init_std=config.initializer_range)
        self.word_embeddings = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, **kw)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, config.hidden_size, **kw)
        self.token_type_embeddings = Embedding(
            config.type_vocab_size, config.hidden_size, **kw)
        self.layer_norm = LayerNorm(config.hidden_size,
                                    epsilon=config.layer_norm_eps,
                                    device=device, dtype=dtype)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               generator=generator)

    @staticmethod
    def default_ids(input_ids, ids):
        """The given ids, or zeros shaped like input_ids on its device."""
        if ids is not None:
            return ids
        return torch.zeros_like(input_ids)

    def embed(self, input_ids, token_type_ids=None, position_ids=None):
        """The summed embeddings before the LayerNorm."""
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)[None, :]
        token_type_ids = self.default_ids(input_ids, token_type_ids)
        return (self.word_embeddings(input_ids)
                + self.position_embeddings(position_ids)
                + self.token_type_embeddings(token_type_ids))

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        e = self.embed(input_ids, token_type_ids, position_ids)
        return self.dropout(self.layer_norm(e))


class BertPooler(nn.Module):
    """[CLS] token -> dense -> tanh (ref BertPooler)."""

    def __init__(self, config, *, device=None, dtype=None, generator=None):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size,
                            init_std=config.initializer_range, device=device,
                            dtype=dtype, generator=generator)
        self.act = getattr(F, config.pool_act)

    def forward(self, hidden):
        return self.act(self.dense(hidden[:, 0]))


class BertModel(FromPretrainedMixin, nn.Module):
    """ref: bert/modeling.py BertModel — returns (sequence_output,
    pooled_output). ``device`` defaults to CUDA (raises with no GPU);
    weights, and dropout in training, draw from ``generator``."""

    config_cls = BertConfig
    embeddings_cls = BertEmbeddings

    def __init__(self, config=None, *, device=None, dtype=None,
                 generator=None, **kwargs):
        super().__init__()
        config = coerce_config(self.config_cls, config, kwargs)
        self.config = config
        kw = model_kw(device, dtype, generator)
        self.embeddings = self.embeddings_cls(config, **kw)
        # a LayerList (the reference's scan-over-layers stack is refused by
        # the config)
        self.encoder = LayerList([BertLayer(config, **kw)
                                  for _ in range(config.num_hidden_layers)])
        self.pooler = BertPooler(config, **kw)

    @classmethod
    def from_config_name(cls, name, *, device=None, dtype=None,
                         generator=None, **overrides):
        return cls(_resolve_config(name, **overrides), device=device,
                   dtype=dtype, generator=generator)

    def encode(self, x, attention_mask):
        mask = normalize_attention_mask(attention_mask)
        if mask is not None:
            mask = mask.to(x.device)
        for blk in self.encoder:
            x = blk(x, mask)
        return x, self.pooler(x)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        return self.encode(x, attention_mask)


class BertLMPredictionHead(nn.Module):
    """MLM head: dense + act + LayerNorm, then the decode against the tied
    word-embedding weight, which ``forward`` takes from its model (the
    reference holds it as ``_tied``; here it is read at forward time, so
    it is no second state-dict key), plus ``decoder_bias``."""

    def __init__(self, config, *, device=None, dtype=None, generator=None):
        super().__init__()
        self.transform = Linear(config.hidden_size, config.hidden_size,
                                init_std=config.initializer_range,
                                device=device, dtype=dtype,
                                generator=generator)
        self.act = getattr(F, config.hidden_act)
        self.layer_norm = LayerNorm(config.hidden_size,
                                    epsilon=config.layer_norm_eps,
                                    device=device, dtype=dtype)
        self.decoder_bias = nn.Parameter(torch.zeros(
            config.vocab_size, device=device, dtype=dtype))

    def forward(self, hidden, decoder_weight):
        h = self.layer_norm(self.act(self.transform(hidden)))
        return parallel_matmul(h, decoder_weight,
                               transpose_y=True) + self.decoder_bias


class BertPretrainingHeads(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        self.predictions = BertLMPredictionHead(config, **kw)
        self.seq_relationship = Linear(config.hidden_size, 2,
                                       init_std=config.initializer_range,
                                       **kw)

    def forward(self, sequence_output, pooled_output, decoder_weight):
        return (self.predictions(sequence_output, decoder_weight),
                self.seq_relationship(pooled_output))


class BertForPretraining(FromPretrainedMixin, nn.Module):
    """ref: BertForPretraining — MLM + NSP: (prediction_scores [B, S,
    vocab], seq_relationship_score [B, 2])."""

    def __init__(self, config=None, *, device=None, dtype=None,
                 generator=None, **kwargs):
        super().__init__()
        kw = model_kw(device, dtype, generator)
        self.bert = BertModel(config, **kw, **kwargs)
        self.config = self.bert.config
        self.cls = BertPretrainingHeads(self.config, **kw)

    @classmethod
    def from_config_name(cls, name, *, device=None, dtype=None,
                         generator=None, **overrides):
        return cls(_resolve_config(name, **overrides), device=device,
                   dtype=dtype, generator=generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, position_ids,
                                attention_mask)
        return self.cls(seq, pooled,
                        self.bert.embeddings.word_embeddings.weight)


class BertPretrainingCriterion(nn.Module):
    """ref: BertPretrainingCriterion — the MLM loss (a masked mean: over
    the positions whose label is not ignore_index, or weighted by
    ``masked_lm_weights``) plus the NSP cross entropy, f32."""

    def __init__(self, config=None):
        super().__init__()
        self.ce = ParallelCrossEntropy()

    def forward(self, prediction_scores, seq_relationship_score=None,
                masked_lm_labels=None, next_sentence_labels=None,
                masked_lm_weights=None):
        mlm = self.ce(prediction_scores, masked_lm_labels)
        if masked_lm_weights is not None:
            w = torch.as_tensor(masked_lm_weights,
                                device=mlm.device).to(mlm.dtype)
            mlm_loss = (mlm * w).sum() / w.sum().clamp(min=1.0)
        else:
            labels = torch.as_tensor(masked_lm_labels, device=mlm.device)
            valid = (labels != self.ce.ignore_index).to(mlm.dtype)
            mlm_loss = mlm.sum() / valid.sum().clamp(min=1.0)
        if next_sentence_labels is None:
            return mlm_loss
        nsp_loss = F.cross_entropy(seq_relationship_score,
                                   torch.as_tensor(next_sentence_labels,
                                                   device=mlm.device))
        return mlm_loss + nsp_loss


class _TaskHead(FromPretrainedMixin, nn.Module):
    """The encoder task heads' scaffolding (ref: bert.py ``_TaskHead``):
    builds the backbone under the reference's attribute name (``bert``;
    ERNIE's heads swap ``backbone_cls``, ``backbone_attr`` and ``_resolve``)
    so state-dict keys match, and exposes it as ``self.backbone``.
    ``self.kw`` holds the resolved device, dtype and generator, from which
    a head builds its own layers and draws its dropout."""

    backbone_cls = BertModel
    backbone_attr = "bert"
    _resolve = staticmethod(_resolve_config)

    def __init__(self, config=None, *, device=None, dtype=None,
                 generator=None, **kwargs):
        super().__init__()
        self.kw = model_kw(device, dtype, generator)
        backbone = self.backbone_cls(config, **self.kw, **kwargs)
        setattr(self, self.backbone_attr, backbone)
        self.config = backbone.config

    @property
    def backbone(self):
        return getattr(self, self.backbone_attr)

    @classmethod
    def from_config_name(cls, name, *, device=None, dtype=None,
                         generator=None, **overrides):
        num_labels = overrides.pop("num_labels", None)
        kw = {} if num_labels is None else {"num_labels": num_labels}
        return cls(cls._resolve(name, **overrides), device=device,
                   dtype=dtype, generator=generator, **kw)

    def _classifier(self, n):
        return Linear(self.config.hidden_size, n,
                      init_std=self.config.initializer_range, **self.kw)

    def _dropout(self):
        return Dropout(self.config.hidden_dropout_prob,
                       generator=self.kw["generator"])


class BertForMaskedLM(_TaskHead):
    """ref: BertForMaskedLM — the MLM head over the sequence output:
    prediction scores [B, S, vocab], decoded against the tied word
    embedding."""

    def __init__(self, config=None, *, device=None, dtype=None,
                 generator=None, **kwargs):
        super().__init__(config, device=device, dtype=dtype,
                         generator=generator, **kwargs)
        self.cls = BertLMPredictionHead(self.config, **self.kw)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq, _ = self.backbone(input_ids, token_type_ids, position_ids,
                               attention_mask)
        return self.cls(seq, self.backbone.embeddings.word_embeddings.weight)


class BertForSequenceClassification(_TaskHead):
    """ref: BertForSequenceClassification — pooled output -> dropout ->
    num_labels logits."""

    def __init__(self, config=None, num_labels=None, *, device=None,
                 dtype=None, generator=None, **kwargs):
        super().__init__(config, device=device, dtype=dtype,
                         generator=generator, **kwargs)
        self.dropout = self._dropout()
        self.classifier = self._classifier(num_labels
                                           or self.config.num_labels)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        _, pooled = self.backbone(input_ids, token_type_ids, position_ids,
                                  attention_mask)
        return self.classifier(self.dropout(pooled))


class BertForTokenClassification(_TaskHead):
    """ref: BertForTokenClassification — sequence output -> dropout ->
    num_labels logits a token."""

    def __init__(self, config=None, num_labels=None, *, device=None,
                 dtype=None, generator=None, **kwargs):
        super().__init__(config, device=device, dtype=dtype,
                         generator=generator, **kwargs)
        self.dropout = self._dropout()
        self.classifier = self._classifier(num_labels
                                           or self.config.num_labels)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq, _ = self.backbone(input_ids, token_type_ids, position_ids,
                               attention_mask)
        return self.classifier(self.dropout(seq))


class BertForQuestionAnswering(_TaskHead):
    """ref: BertForQuestionAnswering — (start_logits, end_logits)."""

    def __init__(self, config=None, *, device=None, dtype=None,
                 generator=None, **kwargs):
        super().__init__(config, device=device, dtype=dtype,
                         generator=generator, **kwargs)
        self.classifier = self._classifier(2)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq, _ = self.backbone(input_ids, token_type_ids, position_ids,
                               attention_mask)
        logits = self.classifier(seq)
        return logits[:, :, 0], logits[:, :, 1]
