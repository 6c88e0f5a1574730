"""GPT of the port, serving and training (counterpart of
``paddle_tpu/nlp/gpt.py``).

Same modules, parameter names and ``[in, out]`` weights as the reference,
so a JAX ``state_dict()`` loads key for key (``nlp.convert``). Pre-LN
blocks, separate q/k/v projections (one ``[h, 3h]`` projection with
``fused_qkv``), learned positions and the LM head tied to the word
embedding (``tie_word_embeddings=False`` is taken and tied, as the
reference ties it).

Attention: with no cache, ``F.scaled_dot_product_attention`` runs the
flash-attention forward (the CUDA kernel on the card). Serving prefill
passes ``kv_lens=[true_len]`` — the reference's padding mask expressed as
key lengths, the same rows through the same kernel. A user's padding
``attention_mask`` goes to the same kernels as a dense mask on top of the
causal one (rows it leaves with no visible key give NaN, as the
reference's dense path gives). A ``PagedLayerCache`` routes each layer
through the paged decode kernel. In train mode the same flash path is
differentiable (the backward kernels on the card) and runs attention
dropout in the kernel. ``GPTModel`` and ``GPTForCausalLM`` load a local
checkpoint through ``from_pretrained``, in any decoder layout.

Randomness: the model holds one ``torch.Generator`` on its device
(``generator``, or a fresh one seeded nondeterministically): weights are
drawn from it at construction, and hidden dropout and the attention-
dropout seed draw from it in training. ``framework.bind_generator``
points the model at another (the Engine does, when given one).

``fused_ln=True`` fuses each block's second residual add into ``ln_2``
(``modeling_utils.fused_residual_ln``: the fused residual-add + LayerNorm
kernel on the card), as the reference's fused block.

Training options, as the reference's: ``recompute`` checkpoints each
decoder block in training (``nn.scan_stack.checkpoint_block``: the
backward reruns the block, with the forward's dropout draws);
``scan_layers`` keeps the blocks as stacked ``[L, ...]`` parameters
(``ScannedGPTLayers``, ``nn.scan_stack``) under the reference's names;
``fused_qkv`` projects q, k and v with one ``[h, 3h]`` weight in the
Megatron head-interleaved layout ``[H, 3, d]`` (``fuse_qkv_state`` /
``split_qkv_state`` convert a state); ``chunked_ce`` makes the training
forward return the ``_loss_only_aux`` dict that
``GPTPretrainingCriterion`` turns into the loss over token chunks, the
head's logits made one chunk at a time (``_chunked_head_ce``).

``generate()`` runs ``nlp.generation.generate``: fixed ``[B, S_max, H,
D]`` per-layer buffers written in place at a scalar ``cache_index``
(``GPTAttention._forward_static_cache``); a single-token step attends
through the dense decode kernel (``ops.attention.flash_decode``), a
prefill through masked attention over ``S_max`` in plain PyTorch, as the
reference computes it.

Not in this slice (each raises NotImplementedError naming its ROADMAP.md
item): ``sequence_parallel``, ``num_virtual_pipeline_stages`` and cached
dense decode (``cache=`` without ``cache_index``, the reference's eager
concat-cache continuation). A ``scan_layers`` model serves no cached
decode, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..distributed.fleet.mpu import (ColumnParallelLinear,
                                     ParallelCrossEntropy, RowParallelLinear,
                                     VocabParallelEmbedding, parallel_matmul)
from ..nn import functional as F
from ..nn.layers_common import Dropout, Embedding, LayerList
from ..nn.layers_norm import LayerNorm
from ..nn.scan_stack import (ScannedLayerStack, as_numpy,
                             checkpoint_block)
from .generation import generate as _generate
from .modeling_utils import (FromPretrainedMixin, coerce_config,
                             fused_residual_ln, later, model_kw,
                             normalize_attention_mask,
                             static_cache_attention, static_index)
from .paged_cache import PagedLayerCache, paged_layer_forward

__all__ = ["GPTConfig", "GPT_CONFIGS", "GPTAttention", "GPTMLP",
           "GPTDecoderLayer", "GPTEmbeddings", "GPTModel", "GPTForCausalLM",
           "GPTPretrainingCriterion", "ScannedGPTLayers", "fuse_qkv_state",
           "split_qkv_state"]

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
        if self.sequence_parallel:
            raise NotImplementedError(f"GPTConfig.sequence_parallel "
                                      f"{later('10')}")
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
        # tie_word_embeddings=False is taken and tied: the reference's
        # head always reads word_embeddings.weight

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
    """Causal self-attention: separate q/k/v column-parallel projections,
    or with ``fused_qkv`` one ``[h, 3h]`` projection whose output columns
    are head-interleaved ``[H, 3, d]``, and a row-parallel output
    projection."""

    def __init__(self, config, **kw):
        super().__init__()
        self.cfg = config
        self.generator = kw.get("generator")  # the attention-dropout seed
        h = config.hidden_size
        std = config.initializer_range
        if config.fused_qkv:
            self.qkv_proj = ColumnParallelLinear(h, 3 * h, init_std=std,
                                                 **kw)
        else:
            self.q_proj = ColumnParallelLinear(h, h, init_std=std, **kw)
            self.k_proj = ColumnParallelLinear(h, h, init_std=std, **kw)
            self.v_proj = ColumnParallelLinear(h, h, init_std=std, **kw)
        self.out_proj = RowParallelLinear(h, h, init_std=std, **kw)

    def _heads(self, x):
        return x.reshape(x.shape[0], x.shape[1], -1, self.cfg.head_dim)

    def _qkv(self, x):
        if self.cfg.fused_qkv:
            qkv = self.qkv_proj(x)
            qkv = qkv.reshape(x.shape[0], x.shape[1], -1, 3,
                              self.cfg.head_dim)    # [b, s, H, 3, d]
            return qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
        return (self._heads(self.q_proj(x)), self._heads(self.k_proj(x)),
                self._heads(self.v_proj(x)))

    def forward(self, x, attn_mask=None, cache=None, kv_lens=None,
                cache_index=None):
        q, k, v = self._qkv(x)
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


def fuse_qkv_state(state_dict, num_attention_heads):
    """Separate q/k/v projection leaves -> the fused head-interleaved
    layout (``attn.qkv_proj.*``), as numpy arrays: weights ``[in, h]``
    each -> ``[in, 3h]`` with the output dim laid out ``[H, 3, d]``,
    biases likewise. Inverse: ``split_qkv_state``."""
    out, groups = {}, {}
    for k, v in state_dict.items():
        for part in ("q_proj", "k_proj", "v_proj"):
            if f".{part}." in k:
                base, leaf = k.split(f".{part}.")
                groups.setdefault((base, leaf), {})[part[0]] = v
                break
        else:
            out[k] = v
    if not groups:
        hint = ""
        if any("__" in k and "q_proj" in k for k in state_dict):
            hint = (" (keys look scan_layers-stacked: unstack with "
                    "unstack_layer_state first, fuse, then re-stack)")
        raise ValueError(
            "fuse_qkv_state converted 0 q/k/v trios — no '.q_proj.' / "
            "'.k_proj.' / '.v_proj.' keys found" + hint)
    H = num_attention_heads
    for (base, leaf), g in groups.items():
        if set(g) != {"q", "k", "v"}:
            raise ValueError(f"incomplete q/k/v trio at {base}.*.{leaf}")
        arrs = [as_numpy(g[p]) for p in "qkv"]
        if arrs[0].ndim == 2:                       # weight [in, h]
            inn, h = arrs[0].shape
            stacked = np.stack([a.reshape(inn, H, h // H) for a in arrs],
                               axis=2)              # [in, H, 3, d]
            out[f"{base}.qkv_proj.{leaf}"] = stacked.reshape(inn, 3 * h)
        else:                                       # bias [h]
            h = arrs[0].shape[0]
            stacked = np.stack([a.reshape(H, h // H) for a in arrs],
                               axis=1)              # [H, 3, d]
            out[f"{base}.qkv_proj.{leaf}"] = stacked.reshape(3 * h)
    return out


def split_qkv_state(state_dict, num_attention_heads):
    """Inverse of ``fuse_qkv_state``."""
    if not any(".qkv_proj." in k for k in state_dict):
        raise ValueError("split_qkv_state converted 0 fused leaves — no "
                         "'.qkv_proj.' keys found (already separate, or "
                         "scan_layers-stacked: unstack first)")
    out = {}
    H = num_attention_heads
    for k, v in state_dict.items():
        if ".qkv_proj." not in k:
            out[k] = v
            continue
        base, leaf = k.split(".qkv_proj.")
        arr = as_numpy(v)
        if arr.ndim == 2:
            inn, h3 = arr.shape
            h = h3 // 3
            sp = arr.reshape(inn, H, 3, h // H)
            parts = [sp[:, :, i].reshape(inn, h) for i in range(3)]
        else:
            h = arr.shape[0] // 3
            sp = arr.reshape(H, 3, h // H)
            parts = [sp[:, i].reshape(h) for i in range(3)]
        for name, a in zip(("q_proj", "k_proj", "v_proj"), parts):
            out[f"{base}.{name}.{leaf}"] = a
    return out


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


def _has_dropout(config):
    return bool(config.hidden_dropout_prob
                or config.attention_probs_dropout_prob)


class ScannedGPTLayers(ScannedLayerStack):
    """GPT's L decoder blocks as stacked ``[L, ...]`` parameters
    (``nn.scan_stack``), the reference's ``scan_layers`` layout."""

    def __init__(self, config, **kw):
        super().__init__(
            [GPTDecoderLayer(config, **kw)
             for _ in range(config.num_hidden_layers)],
            has_dropout=_has_dropout(config), recompute=config.recompute)


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


class GPTModel(FromPretrainedMixin, nn.Module):
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
        if config.scan_layers:
            self.h = ScannedGPTLayers(config, **kw)
        else:
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
        if self.config.scan_layers and (use_cache or cache is not None
                                        or cache_index is not None):
            raise NotImplementedError(
                "scan_layers=True does not support the KV-cache decode "
                "paths (the per-layer caches ride the unrolled blocks). "
                "Build the serving model with scan_layers=False; states "
                "convert with unstack_layer_state().")
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
        if self.config.scan_layers:
            return self.ln_f(self.h(x, attention_mask, kv_lens=kv_lens))
        new_caches = [] if (use_cache or cache is not None) else None
        recompute = (self.config.recompute and self.training
                     and torch.is_grad_enabled())
        for i, blk in enumerate(self.h):
            if new_caches is not None:
                # () asks a layer for its fresh (k, v): the prefill write
                layer_cache = cache[i] if cache is not None else ()
                x, c = blk(x, attention_mask, layer_cache, kv_lens=kv_lens,
                           cache_index=layer_index)
                new_caches.append(c)
            elif recompute:
                x = checkpoint_block(blk, x, attention_mask, kv_lens=kv_lens,
                                     draws=_has_dropout(self.config))
            else:
                x = blk(x, attention_mask, kv_lens=kv_lens)
        x = self.ln_f(x)
        if new_caches is not None:
            return x, new_caches
        return x


class GPTForCausalLM(FromPretrainedMixin, nn.Module):
    """GPTModel + the tied vocab-parallel LM head. With ``chunked_ce``, a
    training forward without a cache returns the reference's
    ``_loss_only_aux`` dict ({"hidden", "lm_weight", "chunked_ce"}) for
    ``GPTPretrainingCriterion`` instead of the logits; the Engine passes
    it to the loss only."""

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
        weight = self.gpt.embeddings.word_embeddings.weight
        if self.config.chunked_ce and self.training and new_cache is None:
            return {"_loss_only_aux": True, "hidden": hidden,
                    "lm_weight": weight,
                    "chunked_ce": int(self.config.chunked_ce)}
        logits = parallel_matmul(hidden, weight, transpose_y=True)
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
    is 1 when one is given. Given the model's ``_loss_only_aux`` dict
    (``chunked_ce``) it computes the per-token loss with the head fused in
    (``_chunked_head_ce``)."""

    def __init__(self, config=None):
        super().__init__()
        self.ce = ParallelCrossEntropy()

    def forward(self, prediction_scores, masked_lm_labels, loss_mask=None):
        if isinstance(prediction_scores, dict) and \
                "chunked_ce" in prediction_scores:
            loss = self._chunked_head_ce(
                prediction_scores["hidden"], prediction_scores["lm_weight"],
                masked_lm_labels, prediction_scores["chunked_ce"])
        else:
            loss = self.ce(prediction_scores, masked_lm_labels)
        if loss_mask is not None:
            m = torch.as_tensor(loss_mask, device=loss.device).to(loss.dtype)
            return (loss * m).sum() / m.sum()
        return loss.mean()

    @staticmethod
    def _chunked_head_ce(hidden, weight, labels, chunk):
        """Per-token cross entropy [B, S] with the tied head fused in:
        the B * S tokens in chunks of ``chunk``, each chunk's [chunk,
        vocab] logits made in f32 from ``hidden`` and ``weight`` ([vocab,
        hidden]) in their own dtype (``f32_logits``), and checkpointed, so
        one chunk's logits live at a time and the backward makes them
        again. Labels of -100 give exactly 0, as ParallelCrossEntropy's
        ignore_index. The last chunk is shorter where ``chunk`` does not
        divide B * S (the reference pads it with ignored rows, which add
        0). The weight's gradient sums over the chunks."""
        b, s, hd = hidden.shape
        n = b * s
        h2 = hidden.reshape(n, hd)
        y2 = torch.as_tensor(labels, device=hidden.device).reshape(n)
        c = max(1, min(int(chunk), n))
        losses = [checkpoint_block(_chunk_ce, h2[i:i + c], weight,
                                   y2[i:i + c]) for i in range(0, n, c)]
        return torch.cat(losses).reshape(b, s)


class _LowPrecisionLogits(torch.autograd.Function):
    """f32 logits from bf16/fp16 operands on CUDA: ``torch.mm(...,
    out_dtype=torch.float32)`` (which autograd has no derivative for)
    forward; the backward's two products in the operands' dtype, the f32
    logits' gradient rounded to it, as a low-precision head's backward
    takes them."""

    @staticmethod
    def forward(ctx, h, weight):
        ctx.save_for_backward(h, weight)
        return torch.mm(h, weight.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        h, weight = ctx.saved_tensors
        g = grad.to(h.dtype)
        return g @ weight, g.t() @ h


def f32_logits(h, weight):
    """h [n, hidden] @ weight [vocab, hidden]^T as f32 logits, each product
    taken from the operands in their own dtype (the reference's einsum
    with ``preferred_element_type=float32``): a bf16/fp16 pair on CUDA
    accumulates in f32 and never rounds the logits to the operands'
    dtype (``_LowPrecisionLogits``); otherwise the operands are widened to
    f32 first (exact)."""
    if h.dtype in (torch.bfloat16, torch.float16) and h.is_cuda:
        return _LowPrecisionLogits.apply(h, weight)
    return torch.mm(h.float(), weight.float().t())


def _chunk_ce(h_c, weight, y_c):
    logits = f32_logits(h_c, weight)
    lse = torch.logsumexp(logits, dim=-1)
    ok = y_c != -100
    picked = logits.gather(-1, y_c.clamp_min(0).long()[:, None])[:, 0]
    return torch.where(ok, lse - picked, torch.zeros_like(lse))
