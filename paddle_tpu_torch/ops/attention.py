"""Attention entry points of the port (counterpart of
``paddle_tpu/ops/attention.py``).

Public layout is the reference's ``[batch, seq, heads, head_dim]``.
Dispatch is by device, with no fallback: a CPU tensor runs the kernel's
plain PyTorch twin, a CUDA tensor launches the hand-written kernel or
raises. ``flash_attention`` is differentiable on both devices through one
``torch.autograd.Function`` (``ops.kernels.flash_attention``), with a
dense ``attn_mask`` too: where the TPU gate sends every dense mask to the
jnp path, the port's flash kernels take it (the reference's dense path's
function, its NaN rows included). Unlike the TPU gate there is no
sequence-multiple rule — the CUDA kernels mask their own ragged edge —
and no environment switch for either decode kernel (dense
``flash_decode``, paged ``paged_flash_decode``): on the card each is the
decode path of its cache.
"""
from __future__ import annotations

import math

import torch

from .kernels import flash_attention as _fa
from .kernels.flash_decode import paged_flash_decode as _paged_flash_decode

__all__ = ["flash_attention", "flash_decode", "paged_flash_decode",
           "reference_attention", "HEAD_DIMS"]

HEAD_DIMS = _fa.HEAD_DIMS


def _fold(x):
    """[B, S, H, D] -> [B*H, S, D] contiguous."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _fold_mask(attn_mask, b, h, sq, sk, device):
    """A dense mask broadcastable to [B, H, Sq, Sk] as the kernels take it:
    a [B, H, Sq, Sk] view on ``device`` whose broadcast dimensions have
    stride 0, so bh = b * H + h reads row b's and head h's values and a
    [B, 1, 1, Sk] padding mask is never copied per head or query. A bool
    mask stays a keep-mask; a float mask of another dtype than f32, bf16 or
    f16 (and an integer one, which the reference adds too) becomes f32."""
    m = torch.as_tensor(attn_mask)
    if m.dtype not in _fa.MASK_DTYPES:
        m = m.float()
    m = m.to(device)
    if m.dim() > 4:
        raise ValueError(f"flash_attention: attn_mask of {m.dim()} dims "
                         f"{tuple(m.shape)} does not broadcast to [B, H, Sq, "
                         "Sk]")
    return m.reshape((1,) * (4 - m.dim()) + tuple(m.shape)).expand(
        b, h, sq, sk)


def flash_attention(q, k, v, causal=False, sm_scale=None, kv_lens=None,
                    dropout_p=0.0, dropout_seed=0, attn_mask=None):
    """[B, S, H, D] differentiable flash attention. kv_lens: optional [B]
    int — key positions >= kv_lens[b] are masked. Rows with no visible key
    give 0. attn_mask: a dense mask broadcastable to [B, H, Sq, Sk], a bool
    keep-mask or an additive float bias, applied after the scale and the
    causal mask as the reference's dense path applies it; rows it leaves
    with no visible key give NaN, as there. It takes no gradient, and
    raises with kv_lens. dropout_p/dropout_seed: in-kernel attention
    dropout with the TPU kernel's hash (the mask is regenerated in the
    backward, never stored); dropout_seed is an int or a one-element int32
    tensor (a tensor on q's device keeps the call free of host syncs)."""
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"flash_attention: dropout_p {dropout_p} not in "
                         "[0, 1)")
    b, sq, h, d = q.shape
    if q.device.type == "cuda":
        _fa.check_head_dim("flash_attention", d, _fa.head_dims(q.dtype))
    lens = None
    if kv_lens is not None:
        lens = torch.as_tensor(kv_lens, dtype=torch.int32,
                               device=q.device).repeat_interleave(h)
    seed = None
    if dropout_p:
        seed = torch.as_tensor(dropout_seed, dtype=torch.int32,
                               device=q.device).reshape(1)
    mask = None
    if attn_mask is not None:
        mask = _fold_mask(attn_mask, b, h, sq, k.shape[1], q.device)
    o = _fa.flash_attention_bhsd(_fold(q), _fold(k), _fold(v), lens, seed,
                                 causal=causal, sm_scale=sm_scale,
                                 dropout_p=dropout_p, mask=mask)
    return o.reshape(b, h, sq, d).transpose(1, 2)


def flash_decode(q, k_cache, v_cache, kv_lens, sm_scale=None):
    """Single-query decode against a dense padded KV cache: q [B, 1, H, D],
    k_cache/v_cache [B, S, H, D], kv_lens [B] ints (keys at positions >=
    kv_lens[b] are padding) -> [B, 1, H, D]. The static-cache decode step
    of GPT and of MHA Llama (``generate()``). Unlike the reference there
    is no ``PADDLE_TPU_FLASH_DECODE`` gate and no ``S % 128`` rule: on the
    card the CUDA kernel (``ops.kernels.flash_attention.flash_decode``) is
    the decode path and reads the cache in place; on the CPU its plain
    twin runs."""
    lens = torch.as_tensor(kv_lens, dtype=torch.int32, device=q.device)
    return _fa.flash_decode(q, k_cache, v_cache, lens, sm_scale=sm_scale)


def paged_flash_decode(q, k_pages, v_pages, page_table, lens, k_scale=None,
                       v_scale=None, sm_scale=None):
    """Paged GQA decode attention, used by
    ``nlp.paged_cache.paged_update_and_attend`` in every serving decode
    step. See ``ops.kernels.flash_decode`` (the module)."""
    return _paged_flash_decode(q, k_pages, v_pages, page_table, lens,
                               k_scale=k_scale, v_scale=v_scale,
                               sm_scale=sm_scale)


def reference_attention(q, k, v, causal=False, sm_scale=None, kv_lens=None):
    """Dense [B, S, H, D] attention in plain PyTorch (the JAX package's
    jnp path). Fully masked rows give 0."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    qh, kh, vh = (a.transpose(1, 2) for a in (q, k, v))
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * sm_scale
    sq, sk = logits.shape[-2], logits.shape[-1]
    neg = torch.tensor(-math.inf, dtype=logits.dtype, device=logits.device)
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = torch.where(keep, logits, neg)
    if kv_lens is not None:
        lens = torch.as_tensor(kv_lens, device=q.device)
        keep = torch.arange(sk, device=q.device)[None, :] < lens[:, None]
        logits = torch.where(keep[:, None, None, :], logits, neg)
    probs = torch.softmax(logits.float(), dim=-1)
    probs = torch.where(torch.isnan(probs), torch.zeros_like(probs), probs)
    out = torch.matmul(probs.to(q.dtype), vh)
    return out.transpose(1, 2)
