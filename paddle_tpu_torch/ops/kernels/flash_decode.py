"""Paged GQA flash-decode: the CUDA kernel's wrapper and its plain twin.

Counterpart of ``paddle_tpu/ops/pallas/flash_decode.py``
(``paged_flash_decode`` / ``_decode_kernel``).

- ``paged_flash_decode`` — the entry: a CPU tensor runs
  ``paged_decode_plain``; a CUDA tensor launches
  ``csrc/paged_flash_decode.cu`` or raises. ``paged_flash_decode.launches``
  counts kernel launches.
- ``paged_decode_plain`` — the same function in plain PyTorch: gather the
  slot's pages into a dense view, mask keys past ``lens``, one softmax.
  It is also ``nlp.paged_cache.paged_attention_ref``.
- ``paged_decode_split`` — how a call cuts each slot's page table row into
  chunks of whole pages, one block each, from shapes alone.
- ``paged_decode_residency`` — what the card makes of the kernel a call
  launches: blocks an SM resident, shared memory, registers, spills.

Dtypes on the card, as the reference's: q in f32, bf16 or float16 (read
as f32, the output in q's dtype); pools in f32, bf16, float16 or int8
with f32 scales. The serving engine makes f32, bf16 and int8 pools only,
as the reference's does; float16 pools are the function's, not an engine
option.

Kernel note (details in the .cu): bound by the bytes of the live pages
(3.35 TB/s on the H100). One launch a call splits each slot's keys over
blocks (chunks of whole pages, about four blocks an SM); a block reads its
chunk's page ids once, streams its rows with 16-byte loads (the next step's
rows in flight under this step's math) and reads K/V once for all the query
heads of a kv head; the last block of a slot to finish combines the
chunks' partial softmax states, in chunk order, through scratch the
wrapper keeps (``_paged_scratch``).
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["HEAD_DIMS", "paged_flash_decode", "paged_decode_plain",
           "paged_decode_split", "paged_decode_residency"]

HEAD_DIMS = (64, 128, 256)
_Q_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_POOL_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float16: 3}
# q, k/v pools, k/v scales, page_table, lens, out, part, counters; b, hkv,
# g, num_pages, ps, max_pages, d, pool code, splits, pages a chunk;
# sm_scale; stream
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [
    ctypes.c_float, ctypes.c_void_p]
# pool code, d, g, pages a chunk; out[4]
_RESIDENCY_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p]
# blocks a call aims for at most: four on each of the H100's 132 SMs
_PAGED_BLOCKS = 4 * 132
# a chunk holds at least this many keys: one step of a block's four warps
# at the widest rows (int8 at D=64, 16 keys a warp)
_PAGED_MIN_KEYS = 64
# at most this many pages a chunk: their ids sit in the block's shared
# memory
_PAGED_MAX_PAGES = 4096
# query heads a block (the kernel's group of a kv head's query heads)
_GROUPS = 4
# device -> (partial states, ticket counters) of the paged decode
_PAGED_SCRATCH = {}


def _dequant(pages, scale):
    x = pages.float()
    return x if scale is None else x * scale


def paged_decode_plain(q, k_pages, v_pages, page_table, lens, k_scale=None,
                       v_scale=None, sm_scale=None):
    """q [B, Hkv, G, D]; pages [Hkv, P, ps, D] (f32/bf16/f16, or int8 with
    scales [Hkv, P, ps, 1] f32); page_table [B, MP] int; lens [B] int —
    keys at flat index >= lens[b] are masked. Returns [B, Hkv, G, D] in
    q's dtype; a slot with lens 0 gives a zero row."""
    b, hkv, g, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    pt = page_table.long()

    def gather(pages, scale):
        x = _dequant(pages[:, pt], None if scale is None
                     else scale[:, pt])          # [Hkv, B, MP, ps, D]
        return x.transpose(0, 1).reshape(b, hkv, -1, d)

    k = gather(k_pages, k_scale)
    v = gather(v_pages, v_scale)
    s = torch.einsum("bhgd,bhkd->bhgk", q.float(), k) * sm_scale
    kpos = torch.arange(k.shape[2], device=q.device)
    ok = kpos[None, None, None, :] < lens.to(q.device)[:, None, None, None]
    s = torch.where(ok, s, torch.full_like(s, -math.inf))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v)
    return out.to(q.dtype)


def _check(q, k_pages, v_pages, page_table, lens, k_scale, v_scale):
    dev = q.device
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"paged_flash_decode: q dtype {q.dtype}, expected "
                        "f32, bf16 or f16")
    if q.dim() != 4:
        raise ValueError(f"paged_flash_decode: q must be [B, Hkv, G, D], "
                         f"got {tuple(q.shape)}")
    b, hkv, g, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_flash_decode: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    if k_pages.dtype not in _POOL_CODES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged_flash_decode: pools {k_pages.dtype}/"
                        f"{v_pages.dtype}, expected f32, bf16, f16 or int8")
    if (k_pages.dim() != 4 or k_pages.shape != v_pages.shape
            or k_pages.shape[0] != hkv or k_pages.shape[3] != d):
        raise ValueError(f"paged_flash_decode: pools {tuple(k_pages.shape)}"
                         f" do not match q {tuple(q.shape)}")
    quant = k_pages.dtype == torch.int8
    if quant != (k_scale is not None and v_scale is not None):
        raise ValueError("paged_flash_decode: int8 pools need k_scale and "
                         "v_scale, other pools take none")
    tensors = [("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
               ("page_table", page_table), ("lens", lens)]
    if quant:
        want = k_pages.shape[:3] + (1,)
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s.shape != want or s.dtype != torch.float32:
                raise ValueError(f"paged_flash_decode: {name} must be "
                                 f"{tuple(want)} f32")
        tensors += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"paged_flash_decode: {name} on {t.device}, "
                             f"q on {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged_flash_decode: {name} must be "
                             "contiguous and 16-byte aligned")
    if (page_table.dtype != torch.int32 or page_table.dim() != 2
            or page_table.shape[0] != b):
        raise ValueError(f"paged_flash_decode: page_table must be "
                         f"[{b}, MP] int32")
    if lens.dtype != torch.int32 or lens.shape != (b,):
        raise ValueError(f"paged_flash_decode: lens must be [{b}] int32")
    if b > 65535 or hkv * -(-g // _GROUPS) > 65535:
        raise ValueError("paged_flash_decode: too many slots or heads for "
                         "the grid")


def paged_decode_split(b, hkv, g, mp, ps):
    """(splits, pages a chunk) of a call over a ``[b, mp]`` page table of
    ``ps``-key pages: each slot's row is cut into ``splits`` chunks of
    whole pages, one block per (chunk, kv head, group of up to four query
    heads, slot), so that the call puts at most about ``_PAGED_BLOCKS``
    blocks on the card (one wave), and one chunk a slot when the slots
    alone come near it. From shapes only, never from ``lens``: the wrapper
    does not sync. Every page of the row lies in exactly one chunk."""
    rows = b * hkv * -(-g // _GROUPS)
    want = max(1, _PAGED_BLOCKS // rows)
    ppc = max(-(-mp // want), -(-_PAGED_MIN_KEYS // ps))
    ppc = min(ppc, mp, _PAGED_MAX_PAGES)
    return -(-mp // ppc), ppc


def _paged_scratch(device, b, hkv, g, splits, d):
    """(part, counters) of a call: f32 room for the ``b * hkv * g * splits``
    partial states (acc, then m and l) and one int32 ticket counter per
    (slot, kv head, head group). Made once per device and size, grown to
    the largest call so far; the counters start at zero and the kernel
    leaves them so."""
    part, counters = _PAGED_SCRATCH.get(device, (None, None))
    n_part = b * hkv * g * splits * (d + 2)
    n_count = b * hkv * -(-g // _GROUPS)
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=device)
    if counters is None or counters.numel() < n_count:
        counters = torch.zeros(n_count, dtype=torch.int32, device=device)
    _PAGED_SCRATCH[device] = (part, counters)
    return part, counters


def paged_decode_residency(pool_dtype, d, g, ppc, device="cuda"):
    """What the card makes of the kernel a call with ``pool_dtype`` pools,
    head dim ``d``, ``g`` query heads a kv head and ``ppc`` pages a chunk
    launches: {"blocks_per_sm" (cudaOccupancyMaxActiveBlocksPerMultiprocessor
    at the call's shared memory), "smem", "registers", "spill_bytes"}.
    Launches nothing."""
    from .. import _build
    entry = _build.load("paged_flash_decode", _RESIDENCY_ARGTYPES,
                        "paged_flash_decode_residency")
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(torch.device(device)):
        err = entry(_POOL_CODES[pool_dtype], d, g, ppc, out)
    if err:
        raise RuntimeError(f"paged_decode_residency: CUDA error {err}")
    return dict(zip(("blocks_per_sm", "smem", "registers", "spill_bytes"),
                    out))


def _on_cuda(q):
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: unsupported device "
                         f"{q.device}")


def paged_flash_decode(q, k_pages, v_pages, page_table, lens, k_scale=None,
                       v_scale=None, sm_scale=None):
    """Paged GQA decode attention -> [B, Hkv, G, D] in q's dtype. CPU
    tensors run the plain version; CUDA tensors launch the kernel or
    raise. ``page_table`` entries are trusted to be valid page ids (the
    serving engine owns them); the wrapper never syncs with the device.
    One launch a call; its scratch (``_paged_scratch``) serves one call at
    a time, on one stream."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, page_table, lens,
                                  k_scale, v_scale, sm_scale)
    _on_cuda(q)
    _check(q, k_pages, v_pages, page_table, lens, k_scale, v_scale)
    from .. import _build
    fn = _build.load("paged_flash_decode", _ARGTYPES)
    b, hkv, g, d = q.shape
    _, num_pages, ps, _ = k_pages.shape
    mp = page_table.shape[1]
    splits, ppc = paged_decode_split(b, hkv, g, mp, ps)
    qf = q.float().contiguous()
    out = torch.empty(b, hkv, g, d, dtype=torch.float32, device=q.device)
    part, counters = _paged_scratch(q.device, b, hkv, g, splits, d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(qf.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 None if k_scale is None else k_scale.data_ptr(),
                 None if v_scale is None else v_scale.data_ptr(),
                 page_table.data_ptr(), lens.data_ptr(), out.data_ptr(),
                 part.data_ptr(), counters.data_ptr(), b, hkv, g, num_pages,
                 ps, mp, d, _POOL_CODES[k_pages.dtype], splits, ppc,
                 float(sm_scale), stream)
    if err:
        raise RuntimeError(f"paged_flash_decode kernel launch failed: "
                           f"CUDA error {err}")
    paged_flash_decode.launches += 1
    return out.to(q.dtype)


paged_flash_decode.launches = 0
