"""Transformer layers of the port (counterpart of
``paddle_tpu/nn/layers_transformer.py``, ref: python/paddle/nn/layer/
transformer.py): ``MultiHeadAttention`` (with its ``Cache`` and
``StaticCache``), the encoder and decoder layers and stacks, and
``Transformer``.

Parameter names and shapes are the reference's (the projections are
``Linear``s with ``[in, out]`` weights), so a reference ``state_dict``
loads key for key through ``nlp.convert.load_numpy_state``. The attention
core is ``F.scaled_dot_product_attention`` on ``[B, S, H, D]``: the flash
kernels on the card (the f32 ones take head_dim 32, 64, 128 and 256) and
their plain twins on the CPU, with or without a dense mask: the layers'
``attn_mask`` and ``Transformer``'s ``src_mask``, ``tgt_mask`` (e.g.
``generate_square_subsequent_mask``) and ``memory_mask`` reach the kernels
as they are, read in place. Every layer takes an explicit ``device``, ``dtype`` and
``generator``: the weights are drawn from it, and attention and hidden
dropout draw from it too (or from one bound later by
``framework.bind_generator``); the deep copies of a stack's layers share
it.
"""
from __future__ import annotations

import collections
import copy

import torch
from torch import nn

from . import functional as F
from .layers_common import Dropout, LayerList, Linear
from .layers_norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


def _linear(in_features, out_features, weight_attr, bias_attr, kw):
    return Linear(in_features, out_features, weight_attr, bias_attr, **kw)


class MultiHeadAttention(nn.Module):
    """ref: nn.MultiHeadAttention. ``need_weights`` is taken and, as in
    the reference, no attention weights are returned."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=None, generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        # attention dropout's seed is drawn from this generator
        self.generator = generator
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.q_proj = _linear(embed_dim, embed_dim, weight_attr, bias_attr, kw)
        self.k_proj = _linear(self.kdim, embed_dim, weight_attr, bias_attr,
                              kw)
        self.v_proj = _linear(self.vdim, embed_dim, weight_attr, bias_attr,
                              kw)
        self.out_proj = _linear(embed_dim, embed_dim, weight_attr, bias_attr,
                                kw)

    def _split_heads(self, x):
        # [B, S, E] -> [B, S, H, D]
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        """``StaticCache``: the projected keys and values of ``key`` /
        ``value`` (cross-attention memory). Otherwise an empty ``Cache``
        [B, 0, H, D] that each call with it extends."""
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(
                value if value is not None else key))
            return self.StaticCache(k, v)
        empty = key.new_zeros(key.shape[0], 0, self.num_heads, self.head_dim)
        return self.Cache(empty, empty)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                cache = self.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0,
            training=self.training, generator=self.generator)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        if cache is not None and not isinstance(cache, self.StaticCache):
            return out, cache
        return out


def _clones(layer, n):
    """``layer`` and ``n - 1`` deep copies of it (the same initial weights)
    that draw from ``layer``'s generators: ``copy.deepcopy`` alone would
    clone a ``torch.Generator`` with its state, and every copy would then
    draw the first layer's dropout masks."""
    shared = {id(m.generator): m.generator for m in layer.modules()
              if getattr(m, "generator", None) is not None}
    return [layer] + [copy.deepcopy(layer, dict(shared))
                      for _ in range(n - 1)]


def _dropouts(attn_dropout, act_dropout, dropout):
    attn = dropout if attn_dropout is None else attn_dropout
    act = dropout if act_dropout is None else act_dropout
    return attn, act


class TransformerEncoderLayer(nn.Module):
    """ref: nn.TransformerEncoderLayer (post-LN, or pre-LN with
    ``normalize_before``)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        attn_dropout, act_dropout = _dropouts(attn_dropout, act_dropout,
                                              dropout)
        kw = dict(device=device, dtype=dtype, generator=generator)
        dk = dict(device=device, dtype=dtype)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.linear1 = _linear(d_model, dim_feedforward, weight_attr,
                               bias_attr, kw)
        self.dropout = Dropout(act_dropout, generator=generator)
        self.linear2 = _linear(dim_feedforward, d_model, weight_attr,
                               bias_attr, kw)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps, **dk)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps, **dk)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(nn.Module):
    """ref: nn.TransformerEncoder — ``encoder_layer`` and
    ``num_layers - 1`` deep copies of it (the same initial weights)."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(_clones(encoder_layer, num_layers))
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, c = mod(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
    """ref: nn.TransformerDecoderLayer: self-attention, cross-attention
    over ``memory``, feed-forward; post-LN, or pre-LN with
    ``normalize_before``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        attn_dropout, act_dropout = _dropouts(attn_dropout, act_dropout,
                                              dropout)
        kw = dict(device=device, dtype=dtype, generator=generator)
        dk = dict(device=device, dtype=dtype)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr, **kw)
        self.linear1 = _linear(d_model, dim_feedforward, weight_attr,
                               bias_attr, kw)
        self.dropout = Dropout(act_dropout, generator=generator)
        self.linear2 = _linear(dim_feedforward, d_model, weight_attr,
                               bias_attr, kw)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps, **dk)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps, **dk)
        self.norm3 = LayerNorm(d_model, epsilon=layer_norm_eps, **dk)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.dropout3 = Dropout(dropout, generator=generator)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            new_incr = None
        else:
            tgt, new_incr = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        static_cache = cache[1] if cache is not None else None
        if static_cache is not None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask,
                                  static_cache)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (new_incr, static_cache))

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(memory, memory,
                                           MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(nn.Module):
    """ref: nn.TransformerDecoder — ``decoder_layer`` and
    ``num_layers - 1`` deep copies of it."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(_clones(decoder_layer, num_layers))
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, c = mod(output, memory, tgt_mask, memory_mask,
                                cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(nn.Module):
    """ref: nn.Transformer: an encoder over ``src`` and a decoder over
    ``tgt`` attending to its output (with a final LayerNorm on each when
    ``normalize_before``)."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        kw = dict(device=device, dtype=dtype, generator=generator)
        dk = dict(device=device, dtype=dtype)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **kw)
            enc_norm = LayerNorm(d_model, **dk) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **kw)
            dec_norm = LayerNorm(d_model, **dk) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """[length, length] f32: 0 on and below the diagonal, -inf above."""
        keep = torch.ones(length, length, dtype=torch.bool,
                          device=device).tril()
        return torch.zeros(length, length, device=device).masked_fill(
            ~keep, float("-inf"))
