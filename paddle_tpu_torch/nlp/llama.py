"""Llama-family models of the port (counterpart of
``paddle_tpu/nlp/llama.py``).

ref parity: paddlenlp/transformers/llama/modeling.py — RMSNorm pre-norm
blocks, rotary position embeddings (half-split rotate), grouped-query
attention, SwiGLU MLP, an untied-or-tied LM head. Same module and
parameter names and ``[in, out]`` weights as the reference, so a JAX
``state_dict()`` loads key for key (``nlp.convert.load_numpy_state``).
RoPE cos/sin are computed from positions on the fly, as the reference
does, once per forward for all layers (``rope_tables``).

Attention: with no cache, kv heads are repeated to the query heads and
``F.scaled_dot_product_attention`` runs the flash-attention forward
(causal, ``kv_lens`` the serving prefill's padding as key lengths; the
CUDA kernel on the card), differentiable in training (the backward
kernels on the card; each kv head's gradient sums its repeats through
autograd).

Serving (``nlp.serving.ServingEngine``): a list of ``PagedLayerCache``
with ``cache_index`` the ``[B]`` per-slot positions on the device. The
model builds the RoPE tables at those positions once a step ([B, 1],
never read back to the host); each layer rotates q and k with them and
hands them to ``paged_layer_forward``, which writes the post-RoPE K into
the pages and attends through the paged decode kernel
(``ops.attention.paged_flash_decode``), its G = heads / kv heads query
heads a kv head in one pass.

Training options, as the reference's: ``recompute`` checkpoints each
decoder layer in training (``nn.scan_stack.checkpoint_block``);
``scan_layers`` keeps the layers as stacked ``[L, ...]`` parameters
(``nn.scan_stack.ScannedLayerStack``) under the reference's names, the
RoPE tables handed to every layer as the ``rope=`` invariant;
``chunked_ce`` makes the training forward return the ``_loss_only_aux``
dict for ``LlamaPretrainingCriterion`` (GPT's chunked head), with the
embedding (tied) or the transpose of the ``[in, out]`` ``lm_head`` weight
(untied) as the head's ``[vocab, hidden]`` weight. ``generate()`` runs
``nlp.generation.generate`` over the static cache
(``LlamaAttention._forward_static_cache``): with one kv head per query
head (MHA, e.g. Llama-2-7B) a single-token step attends through the dense
decode kernel (``ops.attention.flash_decode``); GQA steps and every
prefill take the reference's grouped attention in plain PyTorch, which
never repeats the ``[B, S_max, Hkv, D]`` buffers per query head.

Not in this slice (each raises NotImplementedError naming its ROADMAP.md
item): cached dense decode (``cache=`` without ``cache_index``),
``sequence_parallel`` and ``use_flash_attention=False``. A
``scan_layers`` model serves no cached decode and no paged cache, as in
the reference. ``LlamaModel`` and ``LlamaForCausalLM`` load a local
checkpoint through ``from_pretrained`` (``modeling_utils.
FromPretrainedMixin``), in either decoder layout.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..distributed.fleet.mpu import (ColumnParallelLinear, RowParallelLinear,
                                     VocabParallelEmbedding, parallel_matmul)
from ..nn import functional as F
from ..nn.layers_common import LayerList
from ..nn.layers_norm import RMSNorm
from ..nn.scan_stack import ScannedLayerStack, checkpoint_block
from .generation import generate as _generate
from .gpt import GPTPretrainingCriterion
from .modeling_utils import (FromPretrainedMixin, coerce_config, later,
                             model_kw, normalize_attention_mask,
                             static_cache_attention, static_index)
from .paged_cache import PagedLayerCache, paged_layer_forward

__all__ = ["LlamaConfig", "LLAMA_CONFIGS", "apply_rope", "rope_tables",
           "rotate", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
           "LlamaModel", "LlamaForCausalLM", "LlamaPretrainingCriterion"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    # grouped-query attention: kv heads < heads (0 -> = heads)
    num_key_value_heads: int = 0
    intermediate_size: int = 0  # 0 -> the Llama 8/3*h rounded to 256
    max_position_embeddings: int = 2048
    initializer_range: float = 0.02
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    use_flash_attention: bool = True
    recompute: bool = False
    scan_layers: bool = False
    sequence_parallel: str = ""
    chunked_ce: int = 0

    def __post_init__(self):
        if not self.num_key_value_heads:
            self.num_key_value_heads = self.num_attention_heads
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError(
                f"heads ({self.num_attention_heads}) must be a multiple "
                f"of num_key_value_heads ({self.num_key_value_heads})")
        if not self.intermediate_size:
            m = int(8 * self.hidden_size / 3)
            self.intermediate_size = (m + 255) // 256 * 256
        if self.sequence_parallel not in ("", "ring", "ulysses"):
            raise ValueError(
                f"sequence_parallel={self.sequence_parallel!r}")
        if self.sequence_parallel:
            raise NotImplementedError(f"LlamaConfig.sequence_parallel "
                                      f"{later('10')}")
        if not self.use_flash_attention:
            raise NotImplementedError(
                "LlamaConfig.use_flash_attention=False: the port has no "
                "plain attention path on the card (ROADMAP.md, ground "
                "rules: no fallback)")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


# ref: llama/configuration.py pretrained configs (paddlenlp model zoo)
LLAMA_CONFIGS = {
    "llama-7b": dict(hidden_size=4096, num_hidden_layers=32,
                     num_attention_heads=32, intermediate_size=11008),
    "llama2-7b": dict(hidden_size=4096, num_hidden_layers=32,
                      num_attention_heads=32, intermediate_size=11008,
                      max_position_embeddings=4096),
    "llama3-8b": dict(vocab_size=128256, hidden_size=4096,
                      num_hidden_layers=32, num_attention_heads=32,
                      num_key_value_heads=8, intermediate_size=14336,
                      max_position_embeddings=8192,
                      rope_theta=500000.0),
    "llama-tiny": dict(vocab_size=256, hidden_size=64,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2, intermediate_size=128,
                       max_position_embeddings=128),
    # a TinyLlama-class 1.1B shape (GQA 16:4)
    "llama-1b": dict(vocab_size=32000, hidden_size=2048,
                     num_hidden_layers=22, num_attention_heads=16,
                     num_key_value_heads=4, intermediate_size=5632,
                     max_position_embeddings=2048),
}


def _resolve_config(name, **overrides):
    cfg = dict(LLAMA_CONFIGS[name])
    cfg.update(overrides)
    return LlamaConfig(**cfg)


def rope_tables(positions, d, theta):
    """(cos, sin) f32 of the rotary embedding at ``positions`` [S] (shared
    across the batch) or [B, S] (per row), shaped to broadcast against
    [B, S, H, d]: freqs = pos * theta^(-2i/d), repeated over the two
    halves. A model computes them once per forward for all its layers (the
    reference recomputes them in each layer's trace, and XLA merges the
    copies; eagerly each would cost its launches again)."""
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                  device=positions.device) / d)
    freqs = positions.float()[..., None] * inv          # [..., d/2]
    cos = torch.cos(freqs).repeat(*([1] * positions.dim()), 2)
    sin = torch.sin(freqs).repeat(*([1] * positions.dim()), 2)
    if positions.dim() == 1:     # [S] -> broadcast over batch and heads
        return cos[None, :, None, :], sin[None, :, None, :]
    return cos[:, :, None, :], sin[:, :, None, :]   # [B, S] -> over heads


def rotate(x, cos, sin):
    """x * cos + rotate_half(x) * sin in f32, cast back to x's dtype;
    rotate_half(x) = concat(-x2, x1) over the last-dim halves (the
    HF/paddlenlp half-split convention)."""
    x1, x2 = x.chunk(2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return (x.float() * cos + rot.float() * sin).to(x.dtype)


def apply_rope(x, positions, theta):
    """Rotary embedding of x [B, S, H, D] at positions [S] or [B, S]
    (``rope_tables`` then ``rotate``)."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


def _repeat_kv(x, n):
    """[B, S, Hkv, D] -> [B, S, Hkv*n, D]: query head h reads kv head
    h // n (HF/paddlenlp repeat_kv)."""
    if n == 1:
        return x
    b, s, hkv, d = x.shape
    return x[:, :, :, None, :].expand(b, s, hkv, n, d).reshape(
        b, s, hkv * n, d)


class LlamaAttention(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        self.cfg = config
        h = config.hidden_size
        kvh = config.num_key_value_heads * config.head_dim
        std = config.initializer_range
        lin = dict(has_bias=False, init_std=std, **kw)
        self.q_proj = ColumnParallelLinear(h, h, **lin)
        self.k_proj = ColumnParallelLinear(h, kvh, **lin)
        self.v_proj = ColumnParallelLinear(h, kvh, **lin)
        self.o_proj = RowParallelLinear(h, h, **lin)

    def _shaped_qkv(self, x):
        b, s, d = x.shape[0], x.shape[1], self.cfg.head_dim
        return (self.q_proj(x).reshape(b, s, -1, d),
                self.k_proj(x).reshape(b, s, -1, d),
                self.v_proj(x).reshape(b, s, -1, d))

    def forward(self, x, attn_mask=None, cache=None, cache_index=None, *,
                rope, kv_lens=None):
        """cache=None: the no-cache forward; cache=(): the same, also
        returning this layer's (k, v) (RoPE applied to k); cache=(kbuf,
        vbuf) with an int cache_index: the static-cache step; cache=a
        ``PagedLayerCache``: the serving step (``paged_layer_forward``).
        rope: the (cos, sin) of ``rope_tables`` at this call's positions
        (0.., cache_index.., or each slot's position), built once per
        forward by ``LlamaModel``. kv_lens: [B] key lengths (the serving
        prefill's padding) for the no-cache forward."""
        cfg = self.cfg
        groups = cfg.num_attention_heads // cfg.num_key_value_heads
        q, k, v = self._shaped_qkv(x)
        b, s = q.shape[0], q.shape[1]
        q, k = rotate(q, *rope), rotate(k, *rope)
        if isinstance(cache, PagedLayerCache):
            # rotated already, at the slots' positions: no rope_theta
            return paged_layer_forward(q, k, v, cache, self.o_proj,
                                       groups=groups)
        if cache_index is not None:
            return self._forward_static_cache(q, k, v, cache, cache_index,
                                              groups)
        out = F.scaled_dot_product_attention(
            q, _repeat_kv(k, groups), _repeat_kv(v, groups),
            attn_mask=attn_mask, is_causal=True, training=self.training,
            kv_lens=kv_lens)
        out = self.o_proj(out.reshape(b, s, -1))
        return (out, (k, v)) if cache is not None else out

    def _forward_static_cache(self, q, k, v, cache, idx, groups):
        """generate()'s step, q and k already rotated: the static cache's
        write and attention (``static_cache_attention``: the dense decode
        kernel for one query row of an MHA model, the grouped plain
        attention for anything else)."""
        out = static_cache_attention(q, k, v, cache, idx, groups)
        return self.o_proj(out.reshape(q.shape[0], q.shape[1], -1)), cache


class LlamaMLP(nn.Module):
    """SwiGLU (ref LlamaMLP): down(silu(gate(x)) * up(x))."""

    def __init__(self, config, **kw):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        std = config.initializer_range
        lin = dict(has_bias=False, init_std=std, **kw)
        self.gate_proj = ColumnParallelLinear(h, i, **lin)
        self.up_proj = ColumnParallelLinear(h, i, **lin)
        self.down_proj = RowParallelLinear(i, h, **lin)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config, *, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        eps = config.rms_norm_eps
        self.input_layernorm = RMSNorm(config.hidden_size, epsilon=eps,
                                       device=device, dtype=dtype)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, epsilon=eps, device=device, dtype=dtype)
        self.mlp = LlamaMLP(config, **kw)

    def forward(self, x, attn_mask=None, cache=None, cache_index=None, *,
                rope, kv_lens=None):
        h = self.input_layernorm(x)
        if cache is not None:
            h, cache = self.self_attn(h, attn_mask, cache,
                                      cache_index=cache_index, rope=rope,
                                      kv_lens=kv_lens)
        else:
            h = self.self_attn(h, attn_mask, rope=rope, kv_lens=kv_lens)
        x = x + h
        x = x + self.mlp(self.post_attention_layernorm(x))
        return (x, cache) if cache is not None else x


class LlamaModel(FromPretrainedMixin, nn.Module):
    """ref: llama/modeling.py LlamaModel. ``device`` defaults to CUDA
    (raises with no GPU); weights draw from ``generator`` (a
    torch.Generator on that device; None: a fresh one, seeded
    nondeterministically); dtype defaults to the framework default."""

    def __init__(self, config=None, *, device=None, dtype=None,
                 generator=None, **kwargs):
        super().__init__()
        config = coerce_config(LlamaConfig, config, kwargs)
        self.config = config
        kw = model_kw(device, dtype, generator)
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size,
            init_std=config.initializer_range, **kw)
        blocks = [LlamaDecoderLayer(config, **kw)
                  for _ in range(config.num_hidden_layers)]
        self.layers = (ScannedLayerStack(blocks, recompute=config.recompute)
                       if config.scan_layers else LayerList(blocks))
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps,
                            device=kw["device"], dtype=kw["dtype"])

    @classmethod
    def from_config_name(cls, name, *, device=None, dtype=None,
                         generator=None, **overrides):
        return cls(_resolve_config(name, **overrides), device=device,
                   dtype=dtype, generator=generator)


    def forward(self, input_ids, attention_mask=None, use_cache=False,
                cache=None, cache_index=None, kv_lens=None):
        """use_cache=True also returns each layer's (k, v) [B, S, Hkv, D].
        cache = a list of PagedLayerCache (serving decode) with cache_index
        = the [B] per-slot positions; or a list of (k, v) [B, S_max, Hkv,
        D] buffers with cache_index = one int (generate()'s static cache):
        the buffers are written in place and returned. kv_lens: [B] key
        lengths, the serving prefill's padding mask as the flash kernel
        takes it."""
        if cache_index is not None and cache is None:
            raise ValueError(
                "cache_index was given without cache: decode-by-index "
                "needs the preallocated static KV buffers "
                "(nlp.generation._alloc_cache), or drop cache_index")
        if cache is not None and cache_index is None:
            raise NotImplementedError(f"cached dense decode {later('2.1')}")
        if self.config.scan_layers and (use_cache or cache is not None):
            raise NotImplementedError(
                "scan_layers=True serves the training/no-cache forward only; "
                "build with scan_layers=False for cached decode "
                "(unstack_layer_state converts a state)")
        paged = cache is not None and isinstance(cache[0], PagedLayerCache)
        mask = normalize_attention_mask(attention_mask)
        if mask is not None:
            mask = mask.to(input_ids.device)
        x = self.embed_tokens(input_ids)
        s = input_ids.shape[1]
        idx = None
        if paged:
            # per-slot positions, [B] on the device: [B, s] tables
            slot = torch.as_tensor(cache_index, device=x.device)
            pos = slot[:, None] + torch.arange(s, device=x.device,
                                               dtype=slot.dtype)[None, :]
        else:
            idx = None if cache_index is None else static_index(cache_index)
            pos = torch.arange(s, device=x.device) + (idx or 0)
        rope = rope_tables(pos, self.config.head_dim, self.config.rope_theta)
        if self.config.scan_layers:
            return self.norm(self.layers(x, mask, rope=rope,
                                         kv_lens=kv_lens))
        new_caches = [] if (use_cache or cache is not None) else None
        recompute = (self.config.recompute and self.training
                     and torch.is_grad_enabled())
        for i, blk in enumerate(self.layers):
            if new_caches is not None:
                # () asks a layer for its fresh (k, v)
                layer_cache = cache[i] if cache is not None else ()
                x, c = blk(x, mask, layer_cache, cache_index=idx, rope=rope,
                           kv_lens=kv_lens)
                new_caches.append(c)
            elif recompute:
                x = checkpoint_block(blk, x, mask, rope=rope,
                                     kv_lens=kv_lens)
            else:
                x = blk(x, mask, rope=rope, kv_lens=kv_lens)
        x = self.norm(x)
        return (x, new_caches) if new_caches is not None else x


class LlamaPretrainingCriterion(GPTPretrainingCriterion):
    """ref: llama/modeling.py LlamaPretrainingCriterion — the same masked
    causal-LM cross entropy as GPT's."""


class LlamaForCausalLM(FromPretrainedMixin, nn.Module):
    """ref: llama/modeling.py LlamaForCausalLM: an untied ``lm_head``
    ([hidden, vocab], the Linear layout) by default;
    ``tie_word_embeddings=True`` reuses the embedding. With
    ``chunked_ce`` a training forward without a cache returns the
    ``_loss_only_aux`` dict, as GPT's."""

    def __init__(self, config=None, *, device=None, dtype=None,
                 generator=None, **kwargs):
        super().__init__()
        config = coerce_config(LlamaConfig, config, kwargs)
        kw = model_kw(device, dtype, generator)
        self.llama = LlamaModel(config, **kw)
        self.config = config
        if not config.tie_word_embeddings:
            self.lm_head = ColumnParallelLinear(
                config.hidden_size, config.vocab_size, has_bias=False,
                init_std=config.initializer_range, **kw)

    @classmethod
    def from_config_name(cls, name, *, device=None, dtype=None,
                         generator=None, **overrides):
        return cls(_resolve_config(name, **overrides), device=device,
                   dtype=dtype, generator=generator)


    def forward(self, input_ids, attention_mask=None, use_cache=False,
                cache=None, cache_index=None, kv_lens=None):
        out = self.llama(input_ids, attention_mask, use_cache=use_cache,
                         cache=cache, cache_index=cache_index,
                         kv_lens=kv_lens)
        hidden, new_cache = out if isinstance(out, tuple) else (out, None)
        if self.config.chunked_ce and self.training and new_cache is None:
            # the criterion's head weight is [vocab, hidden]; the untied
            # lm_head keeps the Linear [in, out] layout: its transpose (a
            # view; the chunks' products read it in place)
            weight = (self.llama.embed_tokens.weight
                      if self.config.tie_word_embeddings
                      else self.lm_head.weight.t())
            return {"_loss_only_aux": True, "hidden": hidden,
                    "lm_weight": weight,
                    "chunked_ce": int(self.config.chunked_ce)}
        if self.config.tie_word_embeddings:
            logits = parallel_matmul(hidden, self.llama.embed_tokens.weight,
                                     transpose_y=True)
        else:
            logits = self.lm_head(hidden)
        return (logits, new_cache) if new_cache is not None else logits

    def generate(self, input_ids, **kwargs):
        """-> [B, S0 + max_new_tokens] ids: ``nlp.generation.generate``
        with the reference's arguments."""
        return _generate(self, input_ids, **kwargs)
