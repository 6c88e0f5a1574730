"""GPT of the port, serving and training (counterpart of
``paddle_tpu/nlp/gpt.py``).

Same modules, parameter names and ``[in, out]`` weights as the reference,
so a JAX ``state_dict()`` loads key for key (``nlp.convert``). Pre-LN
blocks, separate q/k/v projections, learned positions and the LM head
tied to the word embedding.

Attention: with no cache, ``F.scaled_dot_product_attention`` runs the
flash-attention forward (the CUDA kernel on the card). Serving prefill
passes ``kv_lens=[true_len]`` — the reference's padding mask expressed as
key lengths, the same rows through the same kernel. A
``PagedLayerCache`` routes each layer through the paged decode kernel. In
train mode the same flash path is differentiable (the backward kernels
on the card) and runs attention dropout in the kernel.

Randomness: the model holds one ``torch.Generator`` on its device
(``generator``, or a fresh one seeded nondeterministically): weights are
drawn from it at construction, and hidden dropout and the attention-
dropout seed draw from it in training. ``framework.bind_generator``
points the model at another (the Engine does, when given one).

``fused_ln=True`` fuses each block's second residual add into ``ln_2``
(``modeling_utils.fused_residual_ln``: the fused residual-add + LayerNorm
kernel on the card), as the reference's fused block.

``generate()`` runs ``nlp.generation.generate``: fixed ``[B, S_max, H,
D]`` per-layer buffers written in place at a scalar ``cache_index``
(``GPTAttention._forward_static_cache``); a single-token step attends
through the dense decode kernel (``ops.attention.flash_decode``), a
prefill through masked attention over ``S_max`` in plain PyTorch, as the
reference computes it.

Not in this slice (each raises NotImplementedError naming its ROADMAP.md
item): ``fused_qkv``, ``scan_layers``, ``sequence_parallel``,
``chunked_ce``, ``recompute`` and cached dense decode (``cache=`` without
``cache_index``, the reference's eager concat-cache continuation).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..distributed.fleet.mpu import (ColumnParallelLinear,
                                     ParallelCrossEntropy, RowParallelLinear,
                                     VocabParallelEmbedding, parallel_matmul)
from ..nn import functional as F
from ..nn.layers_common import Dropout, Embedding, LayerList
from ..nn.layers_norm import LayerNorm
from .generation import generate as _generate
from .modeling_utils import (coerce_config, fused_residual_ln, later,
                             model_kw, normalize_attention_mask,
                             static_cache_attention, static_index)
from .paged_cache import PagedLayerCache, paged_layer_forward

__all__ = ["GPTConfig", "GPT_CONFIGS", "GPTAttention", "GPTMLP",
           "GPTDecoderLayer", "GPTEmbeddings", "GPTModel", "GPTForCausalLM",
           "GPTPretrainingCriterion"]

@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 0  # 0 -> 4*hidden
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 1024
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-5
    use_flash_attention: bool = True
    tie_word_embeddings: bool = True
    recompute: bool = False
    scan_layers: bool = False
    fused_qkv: bool = False
    num_virtual_pipeline_stages: int = 1
    chunked_ce: int = 0
    fused_ln: bool = False
    sequence_parallel: str = ""

    def __post_init__(self):
        if not self.intermediate_size:
            self.intermediate_size = 4 * self.hidden_size
        for flag, item in (("recompute", "1.2"), ("scan_layers", "1.2"),
                           ("fused_qkv", "1.2"), ("chunked_ce", "1.2"),
                           ("sequence_parallel", "10")):
            if getattr(self, flag):
                raise NotImplementedError(f"GPTConfig.{flag} {later(item)}")
        if self.num_virtual_pipeline_stages > 1:
            raise NotImplementedError(
                f"GPTConfig.num_virtual_pipeline_stages="
                f"{self.num_virtual_pipeline_stages} (interleaved pipeline) "
                f"{later('10')}")
        if not self.use_flash_attention:
            raise NotImplementedError(
                "GPTConfig.use_flash_attention=False: the port has no "
                "plain attention path on the card (ROADMAP.md, ground "
                "rules: no fallback)")
        if not self.tie_word_embeddings:
            raise NotImplementedError(
                "GPTConfig.tie_word_embeddings=False: the reference takes "
                "the flag but always ties the LM head, and so does the port "
                "(ROADMAP.md, queue 1 item 1.2)")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


GPT_CONFIGS = {
    "gpt3-1.3B": dict(vocab_size=50304, hidden_size=2048,
                      num_hidden_layers=24, num_attention_heads=16,
                      max_position_embeddings=2048),
    "gpt3-345M": dict(vocab_size=50304, hidden_size=1024,
                      num_hidden_layers=24, num_attention_heads=16,
                      max_position_embeddings=1024),
    "gpt2-en": dict(vocab_size=50304, hidden_size=768,
                    num_hidden_layers=12, num_attention_heads=12,
                    max_position_embeddings=1024),
    "gpt-tiny": dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=4, max_position_embeddings=128,
                     hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0),
}


def _resolve_config(name, **overrides):
    cfg = dict(GPT_CONFIGS[name])
    cfg.update(overrides)
    return GPTConfig(**cfg)


class GPTAttention(nn.Module):
    """Causal self-attention: separate q/k/v column-parallel projections
    and a row-parallel output projection."""

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

    def forward(self, x, attn_mask=None, cache=None, kv_lens=None,
                cache_index=None):
        q = self._heads(self.q_proj(x))
        k = self._heads(self.k_proj(x))
        v = self._heads(self.v_proj(x))
        if isinstance(cache, PagedLayerCache):
            return paged_layer_forward(q, k, v, cache, self.out_proj)
        if cache_index is not None:
            return self._forward_static_cache(q, k, v, cache, cache_index)
        # causal always applies (decoder-only LM); attn_mask is padding on
        # top of it, kv_lens the same padding as key lengths
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.cfg.attention_probs_dropout_prob
            if self.training else 0.0,
            is_causal=True, training=self.training, kv_lens=kv_lens,
            generator=self.generator)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1], -1))
        return (out, (k, v)) if cache is not None else out

    def _forward_static_cache(self, q, k, v, cache, idx):
        """generate()'s step over the fixed [B, S_max, H, D] buffers
        ``cache`` at position idx (``static_cache_attention``: the dense
        decode kernel for one query row, the masked plain attention for a
        prefill)."""
        out = static_cache_attention(q, k, v, cache, idx)
        return self.out_proj(out.reshape(q.shape[0], q.shape[1], -1)), cache


class GPTMLP(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        std = config.initializer_range
        self.fc1 = ColumnParallelLinear(
            config.hidden_size, config.intermediate_size, init_std=std, **kw)
        self.fc2 = RowParallelLinear(
            config.intermediate_size, config.hidden_size, init_std=std, **kw)
        self.act = getattr(F, config.hidden_act)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               generator=kw.get("generator"))

    def forward(self, x):
        return self.dropout(self.fc2(self.act(self.fc1(x))))


class GPTDecoderLayer(nn.Module):
    """Pre-LN block (normalize_before=True)."""

    def __init__(self, config, *, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        eps = config.layer_norm_epsilon
        self.fused_ln = config.fused_ln
        self.ln_1 = LayerNorm(config.hidden_size, epsilon=eps,
                              device=device, dtype=dtype)
        self.attn = GPTAttention(config, **kw)
        self.dropout1 = Dropout(config.hidden_dropout_prob,
                                generator=generator)
        self.ln_2 = LayerNorm(config.hidden_size, epsilon=eps,
                              device=device, dtype=dtype)
        self.mlp = GPTMLP(config, **kw)

    def forward(self, x, attn_mask=None, cache=None, kv_lens=None,
                cache_index=None):
        residual = x
        h = self.ln_1(x)
        if cache is not None:
            h, cache = self.attn(h, attn_mask, cache, kv_lens=kv_lens,
                                 cache_index=cache_index)
        else:
            h = self.attn(h, attn_mask, kv_lens=kv_lens)
        h = self.dropout1(h)
        if self.fused_ln:
            # one pass: s = residual + h and ln_2(s)
            y, s = fused_residual_ln(residual, h, self.ln_2)
            x = s + self.mlp(y)
        else:
            x = residual + h
            x = x + self.mlp(self.ln_2(x))
        return (x, cache) if cache is not None else x


class GPTEmbeddings(nn.Module):
    """word (vocab-parallel) + learned position embeddings."""

    def __init__(self, config, *, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator,
                  init_std=config.initializer_range)
        self.word_embeddings = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, **kw)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, config.hidden_size, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               generator=generator)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)[None, :]
        return self.dropout(self.word_embeddings(input_ids)
                            + self.position_embeddings(position_ids))


class GPTModel(nn.Module):
    """ref: paddlenlp GPTModel. ``device`` defaults to CUDA (raises with no
    GPU); weights, and dropout in training, draw from ``generator`` (a
    torch.Generator on that device; None: a fresh one, seeded
    nondeterministically), dtype defaults to the framework default
    (float32)."""

    def __init__(self, config=None, *, device=None, dtype=None,
                 generator=None, **kwargs):
        super().__init__()
        config = coerce_config(GPTConfig, config, kwargs)
        self.config = config
        kw = model_kw(device, dtype, generator)
        self.embeddings = GPTEmbeddings(config, **kw)
        self.h = LayerList([GPTDecoderLayer(config, **kw)
                            for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_epsilon,
                              device=kw["device"], dtype=kw["dtype"])

    def forward(self, input_ids, position_ids=None, attention_mask=None,
                use_cache=False, cache=None, cache_index=None,
                kv_lens=None):
        """use_cache=True (prefill) also returns each layer's (k, v)
        [B, S, H, D]. cache = a list of PagedLayerCache (serving decode)
        with cache_index = the [B] per-slot positions; or a list of (k, v)
        [B, S_max, H, D] buffers (generate()'s static cache) with
        cache_index = one int, the position of input_ids' first token: the
        buffers are written in place and returned."""
        s = input_ids.shape[1]
        static = cache is not None and not isinstance(cache[0],
                                                      PagedLayerCache)
        if cache_index is None and static:
            raise NotImplementedError(f"cached dense decode {later('2.1')}")
        if cache_index is not None and cache is None:
            raise ValueError("cache_index was given without cache: the "
                             "decode paths write preallocated buffers")
        layer_index = None
        if static:
            layer_index = static_index(cache_index)
            if position_ids is None:
                position_ids = layer_index + torch.arange(
                    s, device=input_ids.device)[None, :]
        elif position_ids is None and cache_index is not None:
            idx = torch.as_tensor(cache_index, device=input_ids.device)
            # per-slot positions (paged serving decode): [B] -> [B, s]
            position_ids = idx[:, None] + torch.arange(
                s, device=input_ids.device, dtype=idx.dtype)[None, :]
        attention_mask = normalize_attention_mask(attention_mask)
        if attention_mask is not None:
            attention_mask = attention_mask.to(input_ids.device)
        x = self.embeddings(input_ids, position_ids)
        new_caches = [] if (use_cache or cache is not None) else None
        for i, blk in enumerate(self.h):
            if new_caches is not None:
                # () asks a layer for its fresh (k, v): the prefill write
                layer_cache = cache[i] if cache is not None else ()
                x, c = blk(x, attention_mask, layer_cache, kv_lens=kv_lens,
                           cache_index=layer_index)
                new_caches.append(c)
            else:
                x = blk(x, attention_mask, kv_lens=kv_lens)
        x = self.ln_f(x)
        if new_caches is not None:
            return x, new_caches
        return x


class GPTForCausalLM(nn.Module):
    """GPTModel + the tied vocab-parallel LM head."""

    def __init__(self, config=None, *, device=None, dtype=None,
                 generator=None, **kwargs):
        super().__init__()
        self.gpt = GPTModel(config, device=device, dtype=dtype,
                            generator=generator, **kwargs)
        self.config = self.gpt.config

    @classmethod
    def from_config_name(cls, name, *, device=None, dtype=None,
                         generator=None, **overrides):
        return cls(_resolve_config(name, **overrides), device=device,
                   dtype=dtype, generator=generator)

    def forward(self, input_ids, position_ids=None, attention_mask=None,
                use_cache=False, cache=None, cache_index=None,
                kv_lens=None):
        out = self.gpt(input_ids, position_ids, attention_mask,
                       use_cache=use_cache, cache=cache,
                       cache_index=cache_index, kv_lens=kv_lens)
        hidden, new_cache = out if isinstance(out, tuple) else (out, None)
        logits = parallel_matmul(
            hidden, self.gpt.embeddings.word_embeddings.weight,
            transpose_y=True)
        if new_cache is not None:
            return logits, new_cache
        return logits

    def generate(self, input_ids, **kwargs):
        """ref: paddlenlp GenerationMixin -> [B, S0 + max_new_tokens] ids,
        with ``nlp.generation.generate``'s arguments. Every call runs that
        static-cache decode. The reference sends greedy and plain top-k
        calls through an eager concat-cache loop instead, which gives the
        same greedy tokens (its test_jit_greedy_matches_eager_generate); a
        sampled stream cannot match across packages either way, so the
        port keeps one decode path."""
        return _generate(self, input_ids, **kwargs)


class GPTPretrainingCriterion(nn.Module):
    """ref: GPTPretrainingCriterion — the mean token cross entropy (f32,
    through ParallelCrossEntropy), over the positions where ``loss_mask``
    is 1 when one is given."""

    def __init__(self, config=None):
        super().__init__()
        self.ce = ParallelCrossEntropy()

    def forward(self, prediction_scores, masked_lm_labels, loss_mask=None):
        loss = self.ce(prediction_scores, masked_lm_labels)
        if loss_mask is not None:
            m = torch.as_tensor(loss_mask, device=loss.device).to(loss.dtype)
            return (loss * m).sum() / m.sum()
        return loss.mean()
