"""Paged (block) KV cache of the port (counterpart of
``paddle_tpu/nlp/paged_cache.py``, without the prefix-cache index).

Layouts stay the reference's:

- per layer, a fixed pool of pages laid out HEAD-MAJOR
  ``[Hkv, P, page_size, D]`` — the layout the paged decode kernel reads;
- a ``[num_slots, max_pages]`` int32 page table maps each serving slot's
  positions to pages (the engine owns it);
- page 0 is the TRASH page: inactive slots point every table entry at it,
  so masked lanes of the batched step have a legal destination;
- int8 pools store per-token-per-head symmetric rows with f32 scale
  sidecars ``[Hkv, P, page_size, 1]``.

Unlike the JAX package, page writes update the pools IN PLACE (PyTorch
tensors are mutable; the reference donates the pool to get the same
effect). ``write_token_kv`` and ``write_prompt_kv`` return the pools they
wrote so callers read like the reference.
"""
from __future__ import annotations

import torch

from ..ops.kernels.flash_decode import paged_decode_plain

__all__ = ["PagedLayerCache", "alloc_pages", "quantize_rows",
           "write_token_kv", "write_prompt_kv", "paged_attention_ref",
           "paged_update_and_attend", "paged_layer_forward", "TRASH_PAGE"]

TRASH_PAGE = 0

_INT8_MAX = 127.0
_POOL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}


class PagedLayerCache:
    """One layer's view of the paged cache plus the shared routing state
    (page table and per-slot positions)."""

    __slots__ = ("k_pages", "v_pages", "k_scale", "v_scale",
                 "page_table", "positions")

    def __init__(self, k_pages, v_pages, page_table, positions,
                 k_scale=None, v_scale=None, use_flash=True):
        if not use_flash:
            raise NotImplementedError(
                "PagedLayerCache(use_flash=False): the port has no plain "
                "attention path on the card (ROADMAP.md, ground rules: no "
                "fallback)")
        self.k_pages = k_pages          # [Hkv, P, ps, D]
        self.v_pages = v_pages          # [Hkv, P, ps, D]
        self.k_scale = k_scale          # [Hkv, P, ps, 1] f32 | None
        self.v_scale = v_scale          # [Hkv, P, ps, 1] f32 | None
        self.page_table = page_table    # [B, MP] int32
        self.positions = positions      # [B] int32 tokens already cached

    @property
    def page_size(self):
        return self.k_pages.shape[2]

    @property
    def quantized(self):
        return self.k_scale is not None


def alloc_pages(num_pages, page_size, kv_heads, head_dim, cache_dtype,
                device):
    """Fresh zeroed page pool for ONE layer: (k, v, k_scale, v_scale);
    the scales are None unless cache_dtype is 'int8'."""
    if cache_dtype not in _POOL_DTYPES:
        raise ValueError(f"cache_dtype {cache_dtype!r}: expected "
                         "float32 | bfloat16 | int8")
    shape = (kv_heads, num_pages, page_size, head_dim)
    dt = _POOL_DTYPES[cache_dtype]
    k = torch.zeros(shape, dtype=dt, device=device)
    v = torch.zeros(shape, dtype=dt, device=device)
    if cache_dtype == "int8":
        return (k, v, torch.zeros(shape[:3] + (1,), device=device),
                torch.zeros(shape[:3] + (1,), device=device))
    return k, v, None, None


def quantize_rows(x):
    """Symmetric per-row int8 quantization over the trailing (D) axis.
    x [..., D] -> (q int8 [..., D], scale f32 [..., 1]). Rounds half to
    even, as the reference does."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / _INT8_MAX
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(xf / safe), -_INT8_MAX, _INT8_MAX)
    return q.to(torch.int8), scale


def write_token_kv(cache, k_new, v_new, live):
    """Write one token per slot into the pages, in place. k_new/v_new
    [B, Hkv, D]; live [B] bool — masked slots are redirected to the trash
    page. Returns the (k_pages, v_pages, k_scale, v_scale) written."""
    ps = cache.page_size
    pos = cache.positions.long()
    page = cache.page_table.long().gather(1, (pos // ps)[:, None])[:, 0]
    page = torch.where(live, page, torch.full_like(page, TRASH_PAGE))
    row = torch.where(live, pos % ps, torch.zeros_like(pos))
    kt = k_new.transpose(0, 1)          # [Hkv, B, D]
    vt = v_new.transpose(0, 1)
    if cache.quantized:
        kq, ks = quantize_rows(kt)
        vq, vs = quantize_rows(vt)
        cache.k_pages[:, page, row] = kq
        cache.v_pages[:, page, row] = vq
        cache.k_scale[:, page, row] = ks
        cache.v_scale[:, page, row] = vs
    else:
        cache.k_pages[:, page, row] = kt.to(cache.k_pages.dtype)
        cache.v_pages[:, page, row] = vt.to(cache.v_pages.dtype)
    return cache.k_pages, cache.v_pages, cache.k_scale, cache.v_scale


def write_prompt_kv(k_pages, v_pages, k_scale, v_scale, k_full, v_full,
                    pages_vec):
    """Prefill write, in place: one request's whole (bucket-padded) prompt
    K/V into its pages. k_full/v_full [1, S_b, Hkv, D] with S_b a multiple
    of page_size; pages_vec [S_b // ps] page ids (tail entries beyond the
    request's allocation point at TRASH_PAGE). Rows past the true prompt
    length carry garbage that decode overwrites or the length masks."""
    ps = k_pages.shape[2]
    nb = k_full.shape[1] // ps
    idx = torch.as_tensor(pages_vec, device=k_pages.device).long()

    def blocks(x):                      # [1, S_b, Hkv, D] -> [Hkv, nb, ps, D]
        x = x[0].transpose(0, 1)
        return x.reshape(x.shape[0], nb, ps, x.shape[-1])

    kb, vb = blocks(k_full), blocks(v_full)
    if k_scale is not None:
        kq, ks = quantize_rows(kb)
        vq, vs = quantize_rows(vb)
        k_pages[:, idx] = kq
        v_pages[:, idx] = vq
        k_scale[:, idx] = ks
        v_scale[:, idx] = vs
    else:
        k_pages[:, idx] = kb.to(k_pages.dtype)
        v_pages[:, idx] = vb.to(v_pages.dtype)
    return k_pages, v_pages, k_scale, v_scale


# the plain paged attention IS the decode kernel's plain twin: q
# [B, Hkv, G, D], pages [Hkv, P, ps, D], page_table [B, MP], lens [B]
paged_attention_ref = paged_decode_plain


def _rope_rows(x, positions, theta):
    """RoPE of single-token rows x [B, H, D] at per-slot positions [B]: the
    per-slot case of ``llama.rope_tables`` / ``rotate``, the one formula
    prefill uses too (a second one would silently break K parity between
    prefill and paged decode)."""
    from .llama import rope_tables, rotate
    cos, sin = rope_tables(positions[:, None], x.shape[-1], theta)
    return rotate(x[:, None], cos, sin)[:, 0]


def paged_layer_forward(q, k, v, cache, out_proj, groups=1,
                        rope_theta=None):
    """The per-layer serving branch of GPT's and Llama's attention: write +
    attend (``paged_update_and_attend``), then the output projection.
    Returns (projected out, cache). ``rope_theta`` rotates q and k at the
    cache's positions first; a caller that rotated them already (Llama's
    attention, with the model's per-slot tables) passes None."""
    out = paged_update_and_attend(q, k, v, cache, groups=groups,
                                  rope_theta=rope_theta)
    b, s = out.shape[0], out.shape[1]
    return out_proj(out.reshape(b, s, -1)), cache


def paged_update_and_attend(q, k, v, cache, groups=1, rope_theta=None):
    """The per-layer serving step: (with ``rope_theta``, RoPE of q and k at
    the slots' positions,) write the new token's K/V into the pages, then
    attend the single query row against the slot's paged history with
    lens = positions + 1 (the token attends itself). The pages hold K after
    RoPE, as prefill writes it.

    q [B, 1, H, D]; k/v [B, 1, Hkv, D], H = Hkv * groups. Returns out
    [B, 1, H, D]. Slots whose table row is all trash write and read the
    trash page; the engine discards their tokens."""
    b, sq, h, d = q.shape
    if sq != 1:
        raise ValueError("paged decode is the single-token path")
    hkv = k.shape[2]
    if h != hkv * groups:
        raise ValueError(f"heads {h} != kv heads {hkv} x groups {groups}")
    q1, k1 = q[:, 0], k[:, 0]
    if rope_theta is not None:
        q1 = _rope_rows(q1, cache.positions, rope_theta)
        k1 = _rope_rows(k1, cache.positions, rope_theta)
    live = torch.ones(b, dtype=torch.bool, device=q.device)
    write_token_kv(cache, k1, v[:, 0], live)
    lens = cache.positions + 1
    from ..ops.attention import paged_flash_decode
    out = paged_flash_decode(q1.reshape(b, hkv, groups, d),
                             cache.k_pages, cache.v_pages, cache.page_table,
                             lens, k_scale=cache.k_scale,
                             v_scale=cache.v_scale)
    return out.reshape(b, 1, h, d)
