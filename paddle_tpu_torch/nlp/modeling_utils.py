"""Shared transformer modeling helpers of the port (counterpart of
``paddle_tpu/nlp/modeling_utils.py``)."""
from __future__ import annotations

import math
import os
import sys

import torch

from ..device import resolve_device
from ..framework import convert_dtype, get_default_dtype, later, seed
from ..ops.attention import flash_decode
from ..ops.kernels.fused_ln import (fused_add_layer_norm,
                                    fused_add_layer_norm_y)

__all__ = ["normalize_attention_mask", "fused_residual_ln", "coerce_config",
           "model_kw", "later", "static_index", "static_cache_attention",
           "from_pretrained_impl", "adapt_state_for_model",
           "FromPretrainedMixin"]


def coerce_config(cls, config, kwargs):
    """A model's config: ``cls(**kwargs)`` when none is given, ``cls`` of a
    dict, or the config object itself."""
    if config is None:
        return cls(**kwargs)
    if isinstance(config, dict):
        return cls(**config)
    return config


def model_kw(device, dtype, generator):
    """{device, dtype, generator} resolved as every model of the port does:
    CUDA by default (raises with no GPU), the framework's default dtype, a
    fresh nondeterministically seeded generator on that device."""
    device = resolve_device(device)
    dtype = convert_dtype(dtype) or get_default_dtype()
    if generator is None:
        generator = seed(None, device)
    return dict(device=device, dtype=dtype, generator=generator)


def normalize_attention_mask(attention_mask):
    """Normalise a user attention mask to [b, 1, sq|1, sk] broadcastable
    form: 2D/3D 0/1 padding masks (int or float — the tokenizer
    convention) become bool keep-masks; 4D float masks pass through as
    additive biases. The models call it once a forward and move the result
    to their device once, so every layer's attention reads the same
    tensor in place."""
    if attention_mask is None:
        return None
    m = torch.as_tensor(attention_mask)
    is_padding = m.dim() <= 3
    if m.dim() == 2:
        m = m[:, None, None, :]
    elif m.dim() == 3:
        m = m[:, None]
    if m.dtype != torch.bool and is_padding:
        m = m != 0
    return m


def fused_residual_ln(residual, h, ln, want_sum=True):
    """LN(residual + h) with ``ln``'s weight, bias and epsilon in one pass
    (``ops.kernels.fused_ln``: the CUDA kernel on the card, its plain twin
    on the CPU). want_sum=True returns (y, s) with s = residual + h (GPT's
    pre-LN block feeds s to the next residual); want_sum=False returns y
    alone and never writes the sum (BERT/ERNIE's post-LN blocks drop it).
    The kernels take any row count, so there is no fallback path."""
    eps = getattr(ln, "_epsilon", 1e-5)
    fn = fused_add_layer_norm if want_sum else fused_add_layer_norm_y
    return fn(residual, h, ln.weight, ln.bias, eps)


def static_index(cache_index):
    """The static cache's write position as a Python int. An int (what
    generate() passes) costs nothing; a 0-d tensor on the card is read
    back, a host sync."""
    if isinstance(cache_index, torch.Tensor):
        if cache_index.dim():
            raise ValueError(f"a static cache takes one cache_index, got "
                             f"shape {tuple(cache_index.shape)}")
        return int(cache_index.item())
    return int(cache_index)


def static_cache_attention(q, k, v, cache, idx, groups=1):
    """One layer's attention over generate()'s static cache (the
    reference's ``_forward_static_cache`` of GPT and Llama): k and v
    [B, sq, Hkv, D] are written in place into the fixed [B, S_max, Hkv, D]
    buffers ``cache`` at positions idx.. (a Python int); q [B, sq, H, D],
    H = Hkv * groups, at the same positions, attends keys j <= idx + row.

    A single query row with one kv head per query head attends the first
    idx + 1 keys through the dense decode kernel (``ops.attention.
    flash_decode``; q cast to the cache dtype, as the reference casts it).
    Anything else (a prefill, a GQA step) takes the reference's grouped
    attention in plain PyTorch, which runs no kernel there either: each kv
    head meets its group of query heads in one matmul, so the buffers are
    never repeated per query head; logits in f32 (masked to -1e30), p and
    the product in q's dtype. Returns [B, sq, H, D] in q's dtype."""
    kbuf, vbuf = cache
    b, sq, h, d = q.shape
    kbuf[:, idx:idx + sq] = k
    vbuf[:, idx:idx + sq] = v
    if groups == 1 and sq == 1:
        lens = torch.full((b,), idx + 1, dtype=torch.int32, device=q.device)
        return flash_decode(q.to(kbuf.dtype), kbuf, vbuf, lens).to(q.dtype)
    hkv, s_max = h // groups, kbuf.shape[1]
    qg = q.reshape(b, sq, hkv, groups, d).permute(0, 2, 3, 1, 4).reshape(
        b, hkv, groups * sq, d)
    kh = kbuf.to(q.dtype).transpose(1, 2)               # [B, Hkv, S, D]
    vh = vbuf.to(q.dtype).transpose(1, 2)
    logits = torch.matmul(qg.float(), kh.float().transpose(-1, -2)) * (
        1.0 / math.sqrt(d))                             # [B, Hkv, G*sq, S]
    kpos = torch.arange(s_max, device=q.device)[None, :]
    qpos = (idx + torch.arange(sq, device=q.device)).repeat(groups)[:, None]
    logits = torch.where(kpos <= qpos, logits,
                         torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.matmul(p, vh)                             # [B, Hkv, G*sq, D]
    return o.reshape(b, hkv, groups, sq, d).permute(0, 3, 1, 2, 4).reshape(
        b, sq, h, d)


def from_pretrained_impl(cls, resolve, name_or_path, pretrained_path=None,
                         config_name=None, **overrides):
    """The reference's ``from_pretrained`` (paddle_tpu/nlp/modeling_utils.
    py: PaddleNLP's, offline), in its three forms:

    - ``from_pretrained('<config name>')`` needs a download: raises
      NotImplementedError with the reference's convert-and-load recipe;
    - ``from_pretrained('<config name>', pretrained_path='<file>')`` builds
      the named config and loads the checkpoint;
    - ``from_pretrained('<file>', config_name='<config name>')`` the same,
      the checkpoint first.

    The file is read by ``serialization.load`` (a ``.pdparams`` that
    either package saved; a ``{"params", "buffers"}`` dict is merged),
    brought to the model's decoder layout (``adapt_state_for_model``) and
    loaded strictly: a missing parameter raises before anything is copied.
    ``device``, ``dtype`` and ``generator`` among ``overrides`` go to the
    model, the rest to the config. Unlike the reference, the bare name
    raises before the model is built (the config is resolved first, so an
    unknown name raises as there)."""
    from ..serialization import load, set_state_dict
    name = name_or_path
    if os.path.exists(str(name_or_path)):
        if pretrained_path is not None:
            raise ValueError(
                f"'{name_or_path}' is a checkpoint path AND "
                f"pretrained_path='{pretrained_path}' was given — pass "
                "exactly one weights source")
        if not config_name:
            raise ValueError(
                f"'{name_or_path}' is a checkpoint path; also pass "
                "config_name='<config>' so the architecture can be "
                "built before loading the weights")
        pretrained_path, name = str(name_or_path), config_name
    build = {k: overrides.pop(k) for k in ("device", "dtype", "generator")
             if k in overrides}
    config = resolve(name, **overrides)
    if pretrained_path is None:
        raise NotImplementedError(
            f"from_pretrained('{name}') needs a weights download, which "
            "this offline environment cannot do. Recipe: in the "
            "reference framework run `paddle.save(model.state_dict(), "
            f"'{name}.pdparams')`, copy the file here, and call "
            f"from_pretrained('{name}', pretrained_path='"
            f"{name}.pdparams') — the .pdparams pickle loads directly "
            "(paddle_tpu.compat.load_pdparams)")
    model = cls(config, **build)
    state = load(str(pretrained_path))
    if isinstance(state, dict) and set(state) >= {"params"} and \
            all(k in ("params", "buffers", "specs") for k in state):
        state = {**state.get("params", {}), **state.get("buffers", {})}
    state = adapt_state_for_model(model, state)
    missing = [k for k in model.state_dict() if k not in state]
    if missing:
        raise ValueError(
            f"checkpoint {pretrained_path} (after layout conversion) "
            f"is missing parameters "
            f"{missing[:8]}{'...' if len(missing) > 8 else ''} — "
            "refusing a partial load")
    set_state_dict(model, state)
    return model


def adapt_state_for_model(model, state):
    """Bridge a checkpoint's decoder layout to the built model's: unrolled
    per-layer keys <-> scan-stacked ``[L, ...]`` leaves (``scan_layers``)
    and separate q/k/v projections <-> GPT's fused ``qkv_proj``
    (``fused_qkv``), in either direction, composing (the reference's
    function; the port's conversion is ``nlp.convert``'s). A state already
    in the model's layout comes back as the same object."""
    from .convert import _to_model_layout
    if not isinstance(state, dict) or not state:
        return state
    return _to_model_layout(model, state)


class FromPretrainedMixin:
    """One ``from_pretrained`` for every model family: the config resolver
    is ``cls._resolve`` (the task heads) or the defining module's
    ``_resolve_config`` (backbones and LM heads)."""

    @classmethod
    def from_pretrained(cls, name_or_path, pretrained_path=None,
                        config_name=None, **overrides):
        resolve = getattr(cls, "_resolve", None)
        if resolve is None:
            resolve = getattr(sys.modules[cls.__module__],
                              "_resolve_config")
        return from_pretrained_impl(cls, resolve, name_or_path,
                                    pretrained_path, config_name,
                                    **overrides)
