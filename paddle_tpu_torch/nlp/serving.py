"""Continuous-batching serving engine of the port, core subset
(counterpart of ``paddle_tpu/nlp/serving.py``).

Same scheduling contract as the reference:

- a fixed pool of ``max_slots`` decode slots and a free list of KV pages
  (page 0 is the trash page, never allocated);
- admission ('wait' policy) at step boundaries: a queued request takes a
  free slot once the free list holds its prompt + max_new_tokens pages;
- prefill per request, padded to a power-of-two whole-page bucket
  (``_bucket_for``), through the flash-attention forward with
  ``kv_lens=[true_len]`` (the reference's padding mask); bucket tail
  blocks past the allocation write to the trash page;
- decode in dispatches of ``steps_per_dispatch`` batched single-token
  steps over the whole slot pool, each step writing the token's K/V (after
  RoPE at each slot's position, for Llama) and attending through the paged
  decode kernel, G = heads / kv heads query heads a kv head. The K steps of a dispatch
  run on the device without a host sync; the host syncs once per dispatch
  to read the tokens, as the reference's scan does. Inactive slots hold
  an all-trash table row, and ``done`` is monotonic within a dispatch.
- sampling: greedy (temperature 0) or temperature / top-k by Gumbel-max
  over counter-hashed uniforms, so a row's draw depends only on (its
  admission key, its emitted index) — never on batch width or dispatch
  scheduling. The key is drawn once per admission from the engine's
  ``torch.Generator`` seeded by ``seed``. Streams are not the JAX
  package's (different generators); greedy tokens are comparable.

Where the reference runs compiled XLA programs, the port runs eager
PyTorch on the engine's device (CUDA unless ``device="cpu"``). Not in this
slice (ROADMAP.md): prefix caching, speculative decoding, warmup/AOT,
the memory ledger, profiler, tenancy/tracing/metrics registry,
watchdog/retries/fault injection, the reject/evict policies, cancel and
deadlines. The constructor and ``submit`` take every keyword of the
reference's, and a value other than the reference's default raises
NotImplementedError naming ROADMAP.md queue 1 item 7, as do ``cancel``,
``drain``, ``resume``, ``health``, ``warmup`` and ``close``.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from ..device import resolve_device
from ..framework import later
from .paged_cache import (PagedLayerCache, TRASH_PAGE, alloc_pages,
                          write_prompt_kv)

__all__ = ["ServingEngine", "ServeRequest"]

_M32 = 0xFFFFFFFF
# the reference's keywords that select parts not ported yet, with the
# reference's defaults: any other value raises
_ENGINE_LATER = dict(
    donate=True, admission_policy="wait", watchdog_timeout=None,
    dispatch_retries=2, registry=None, tenant_capacity=64,
    prefix_cache=None, min_prefix_pages=None, prefix_max_entries=512,
    spec_decode=None, spec_k=None, spec_draft=None, profile=None,
    profile_hz=None, mem_ledger=None, mem_admission=None,
    mem_capacity_bytes=None)
_SUBMIT_LATER = dict(deadline_ms=None, priority=0, trace=None, tenant=None)


def _refuse_later(where, defaults, given):
    for name, value in given.items():
        if value is not defaults[name] and value != defaults[name]:
            raise NotImplementedError(f"{where}({name}={value!r}) "
                                      f"{later('7')}")


class ServeRequest:
    """One queued generation request."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "eos_token_id",
                 "submitted_at")

    def __init__(self, rid, prompt, max_new_tokens, eos_token_id):
        self.rid = rid
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.submitted_at = time.perf_counter()


class _Slot:
    __slots__ = ("req", "pages", "out_tokens", "ttft_s")

    def __init__(self, req, pages, ttft_s):
        self.req = req
        self.pages = pages          # page ids owned by this sequence
        self.out_tokens = []        # generated tokens (host ints)
        self.ttft_s = ttft_s        # submit -> first token, seconds


def _next_pow2(n):
    return 1 << max(0, (int(n) - 1)).bit_length()


def _mix32(x):
    """32-bit integer finaliser on int64 tensors holding values < 2**32
    (multipliers below 2**31 keep every product inside int64)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def row_uniforms(key_base, index, width):
    """[N, width] uniforms in (0, 1): entry (n, j) is a pure function of
    (key_base[n], index[n], j)."""
    base = _mix32((key_base.long() ^ _mix32(index.long() & _M32)) & _M32)
    col = torch.arange(width, device=key_base.device, dtype=torch.int64)
    h = _mix32((base[:, None] + col[None, :] * 0x9E3779B1) & _M32)
    return ((h >> 8).float() + 0.5) / float(1 << 24)


class ServingEngine:
    """Continuous-batching decode over a fixed slot pool.

    model: a port ``GPTForCausalLM`` or ``LlamaForCausalLM`` (anything
    whose attention layers understand ``PagedLayerCache`` and whose
    forward takes ``kv_lens``), already on ``device``, in any of its
    dtypes (logits are sampled in f32).
    device: where the engine runs; None means CUDA and raises without a
        GPU. Must be the model's device.
    max_slots: decode batch width. page_size: tokens per KV page.
    max_seq_len: per-sequence capacity (prompt + generated), rounded up to
        whole pages; fixes the page-table width.
    num_pages: total pool pages (page 0 is the trash page); default
        provisions every slot fully.
    cache_dtype: 'float32' | 'bfloat16' | 'int8' KV storage.
    temperature / top_k / seed: sampling (greedy when temperature == 0).
    steps_per_dispatch: decode tokens per dispatch; admission and release
        happen at dispatch boundaries.
    Admission is the reference's 'wait' policy (back-pressure).
    """

    def __init__(self, model, *, max_slots=8, page_size=16,
                 max_seq_len=256, num_pages=None, cache_dtype="float32",
                 use_flash=None, temperature=0.0, top_k=0, seed=0,
                 pad_token_id=0, steps_per_dispatch=8, donate=True,
                 admission_policy="wait", watchdog_timeout=None,
                 dispatch_retries=2, registry=None,
                 tenant_capacity=64, prefix_cache=None,
                 min_prefix_pages=None, prefix_max_entries=512,
                 spec_decode=None, spec_k=None, spec_draft=None,
                 profile=None, profile_hz=None, mem_ledger=None,
                 mem_admission=None, mem_capacity_bytes=None, device=None):
        if use_flash is not None and not use_flash:
            raise NotImplementedError(
                "ServingEngine(use_flash=False): the port has no plain "
                "attention path on the card (ROADMAP.md, ground rules: no "
                "fallback)")
        _refuse_later("ServingEngine", _ENGINE_LATER, dict(
            donate=donate, admission_policy=admission_policy,
            watchdog_timeout=watchdog_timeout,
            dispatch_retries=dispatch_retries, registry=registry,
            tenant_capacity=tenant_capacity, prefix_cache=prefix_cache,
            min_prefix_pages=min_prefix_pages,
            prefix_max_entries=prefix_max_entries, spec_decode=spec_decode,
            spec_k=spec_k, spec_draft=spec_draft, profile=profile,
            profile_hz=profile_hz, mem_ledger=mem_ledger,
            mem_admission=mem_admission,
            mem_capacity_bytes=mem_capacity_bytes))
        want = resolve_device(device)
        self.device = next(model.parameters()).device
        if self.device.type != want.type or (
                want.index is not None and self.device != want):
            raise ValueError(f"model is on {self.device}, engine asked "
                             f"for {want}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        model.eval()
        self.model = model
        cfg = model.config
        self.cfg = cfg
        self.kv_heads = (getattr(cfg, "num_key_value_heads", 0)
                         or cfg.num_attention_heads)
        self.groups = cfg.num_attention_heads // self.kv_heads
        self.num_layers = cfg.num_hidden_layers
        self.head_dim = cfg.head_dim
        self.page_size = int(page_size)
        self.max_slots = int(max_slots)
        self.max_pages_per_seq = -(-int(max_seq_len) // self.page_size)
        self.max_seq_len = self.max_pages_per_seq * self.page_size
        max_pos = getattr(cfg, "max_position_embeddings", None)
        if max_pos and self.max_seq_len > max_pos:
            raise ValueError(
                f"max_seq_len={max_seq_len} exceeds the model's "
                f"max_position_embeddings={max_pos}")
        if num_pages is None:
            num_pages = 1 + self.max_slots * self.max_pages_per_seq
        self.num_pages = int(num_pages)
        self.cache_dtype = str(cache_dtype)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.pad_token_id = int(pad_token_id)
        self.steps_per_dispatch = int(steps_per_dispatch)

        self._pages = [alloc_pages(self.num_pages, self.page_size,
                                   self.kv_heads, self.head_dim,
                                   self.cache_dtype, self.device)
                       for _ in range(self.num_layers)]
        b = self.max_slots
        self._page_table = np.full((b, self.max_pages_per_seq), TRASH_PAGE,
                                   np.int32)
        self._seq_lens = np.zeros((b,), np.int32)
        self._last_tokens = np.zeros((b,), np.int32)
        self._emitted = np.zeros((b,), np.int32)
        self._max_new = np.ones((b,), np.int32)
        self._eos = np.full((b,), -1, np.int32)  # -1 = no eos for slot
        self._done = np.ones((b,), bool)
        self._active = np.zeros((b,), bool)
        # per-slot sampling key, drawn once per admission
        self._key_base = np.zeros((b,), np.int64)
        self._rng = torch.Generator().manual_seed(int(seed))
        # device mirror of the scheduling arrays, rebuilt only when the
        # host changes them (admission/release)
        self._dev_sched = None

        self._free_pages = list(range(1, self.num_pages))  # 0 = trash
        self._slots = [None] * b
        self._queue = collections.deque()
        self._finished = []
        self._next_rid = 0
        # decode-dispatch accounting (the reference's bench --serve feed)
        self.decode_seconds = 0.0
        self.decode_tokens = 0
        self.decode_dispatches = 0

    # -- public API ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens=16, eos_token_id=None,
               deadline_ms=None, priority=0, trace=None, tenant=None):
        """Queue one request; returns its id. Admitted at the next step()
        boundary (slot + pages permitting). Deadlines, priorities, traces
        and tenants are not ported: a value other than the default
        raises."""
        _refuse_later("ServingEngine.submit", _SUBMIT_LATER, dict(
            deadline_ms=deadline_ms, priority=priority, trace=trace,
            tenant=tenant))
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if not len(prompt):
            raise ValueError("empty prompt")
        need = len(prompt) + int(max_new_tokens)
        if need > self.max_seq_len:
            raise ValueError(
                f"prompt({len(prompt)}) + max_new_tokens"
                f"({max_new_tokens}) = {need} exceeds max_seq_len="
                f"{self.max_seq_len}")
        need_pages = -(-need // self.page_size)
        if need_pages > self.num_pages - 1:
            raise ValueError(
                f"request needs {need_pages} KV pages but the pool only "
                f"has {self.num_pages - 1} usable — it would wedge the "
                "admission queue. Raise num_pages or shorten the request.")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(ServeRequest(rid, prompt, max_new_tokens,
                                        eos_token_id))
        return rid

    def step(self):
        """One scheduling round: release finished slots, admit queued
        requests, run ONE batched decode dispatch. Returns the requests
        finished this round as dicts {id, prompt, tokens, status, ttft_s,
        age_s} (tokens = generated only)."""
        self._evict()
        self._admit()
        if self._active.any() and not (self._done | ~self._active).all():
            self._dispatch_decode()
        self._evict()
        out, self._finished = self._finished, []
        return out

    def run_to_completion(self, max_rounds=10_000):
        """Drive step() until queue and slots drain; returns all finished
        requests in completion order."""
        results = []
        rounds = 0
        while self._queue or any(s is not None for s in self._slots):
            results.extend(self.step())
            rounds += 1
            if rounds > max_rounds:
                raise RuntimeError("serving loop did not drain within "
                                   f"{max_rounds} rounds")
        return results

    def generate(self, prompts, max_new_tokens=16, eos_token_id=None):
        """Submit all, drain, return generated token lists in submission
        order."""
        ids = [self.submit(p, max_new_tokens, eos_token_id)
               for p in prompts]
        res = {r["id"]: r for r in self.run_to_completion()}
        return [res[i]["tokens"] for i in ids]

    def cancel(self, rid):
        raise NotImplementedError(f"ServingEngine.cancel {later('7')}")

    def drain(self):
        raise NotImplementedError(f"ServingEngine.drain {later('7')}")

    def resume(self):
        raise NotImplementedError(f"ServingEngine.resume {later('7')}")

    def health(self):
        raise NotImplementedError(f"ServingEngine.health {later('7')}")

    def warmup(self, buckets=(), decode=True):
        raise NotImplementedError(f"ServingEngine.warmup {later('7')}")

    def close(self):
        raise NotImplementedError(f"ServingEngine.close {later('7')}")

    @property
    def free_page_count(self):
        return len(self._free_pages)

    def reset_counters(self):
        self.decode_seconds = 0.0
        self.decode_tokens = 0
        self.decode_dispatches = 0

    def _bucket_for(self, n):
        """The pow2, whole-page prefill bucket a prompt of length n lands
        in."""
        ps = self.page_size
        bucket = min(max(_next_pow2(int(n)), ps), self.max_seq_len)
        return min(-(-bucket // ps) * ps, self.max_seq_len)

    # -- sampling -------------------------------------------------------------

    def _sample_rows(self, logits, key_base, index):
        """logits [N, V]; one (key, index) per row. Returns [N] int32."""
        logits = logits.float()
        if self.temperature <= 0.0:
            return logits.argmax(dim=-1).int()
        logits = logits / self.temperature
        if self.top_k:
            vals, cand = torch.topk(logits, self.top_k, dim=-1)
            u = row_uniforms(key_base, index, self.top_k)
            pick = (vals - torch.log(-torch.log(u))).argmax(dim=-1)
            return cand.gather(1, pick[:, None])[:, 0].int()
        u = row_uniforms(key_base, index, logits.shape[-1])
        return (logits - torch.log(-torch.log(u))).argmax(dim=-1).int()

    # -- device work -----------------------------------------------------------

    def _model_token_step(self, tokens, page_table, positions):
        """One batched single-token forward through the paged cache
        (pools updated in place). tokens [B] int32 -> logits [B, V] f32."""
        caches = [PagedLayerCache(k, v, page_table, positions,
                                  k_scale=ks, v_scale=vs)
                  for (k, v, ks, vs) in self._pages]
        logits, _ = self.model(tokens[:, None], cache=caches,
                               cache_index=positions)
        return logits[:, -1].float()

    @torch.no_grad()
    def _dispatch_decode(self):
        emitted_before = self._emitted.copy()
        t0 = time.perf_counter()
        if self._dev_sched is None:
            self._dev_sched = tuple(
                torch.from_numpy(a).to(self.device) for a in
                (self._page_table, self._seq_lens, self._last_tokens,
                 self._active, self._done, self._emitted, self._max_new,
                 self._eos, self._key_base))
        (pt, seq_lens, last, active, done, emitted, max_new, eos,
         key_base) = self._dev_sched
        pad = torch.tensor(self.pad_token_id, dtype=torch.int32,
                           device=self.device)
        toks = []
        for _ in range(self.steps_per_dispatch):
            live = active & ~done
            logits = self._model_token_step(last, pt, seq_lens)
            nxt = self._sample_rows(logits, key_base, emitted)
            nxt = torch.where(live, nxt, pad)
            emitted = emitted + live.int()
            stop = (emitted >= max_new) | ((eos >= 0) & (nxt == eos))
            done = done | (live & stop)
            seq_lens = seq_lens + live.int()
            last = torch.where(live, nxt, last)
            toks.append(nxt)
        self._dev_sched = (pt, seq_lens, last, active, done, emitted,
                           max_new, eos, key_base)
        # the one host sync of the dispatch
        b = self.max_slots
        host = torch.cat([torch.stack(toks).reshape(-1), seq_lens, last,
                          done.int(), emitted]).cpu().numpy()
        toks_h = host[:-4 * b].reshape(self.steps_per_dispatch, b)
        self._seq_lens = host[-4 * b:-3 * b].copy()
        self._last_tokens = host[-3 * b:-2 * b].copy()
        self._done = host[-2 * b:-b].astype(bool)
        self._emitted = host[-b:].copy()
        dt = time.perf_counter() - t0
        self.decode_seconds += dt
        self.decode_tokens += int((self._emitted - emitted_before).sum())
        self.decode_dispatches += 1
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            n = int(self._emitted[i] - emitted_before[i])
            # live steps are the first n of the dispatch (done is
            # monotonic within it)
            slot.out_tokens.extend(int(t) for t in toks_h[:n, i])

    @torch.no_grad()
    def _prefill(self, req, need_pages, key):
        """Bucketed prefill of one request: writes its prompt K/V into
        freshly allocated pages and samples the first token. Returns
        (first token, pages)."""
        ps = self.page_size
        lp = len(req.prompt)
        bucket = self._bucket_for(lp)
        nb = bucket // ps
        pages = [self._free_pages.pop() for _ in range(need_pages)]
        pages_vec = np.full((nb,), TRASH_PAGE, np.int64)
        pages_vec[:min(need_pages, nb)] = pages[:nb]
        ids = np.full((1, bucket), self.pad_token_id, np.int32)
        ids[0, :lp] = req.prompt
        dev = self.device
        logits, dense_kv = self.model(
            torch.from_numpy(ids).to(dev), use_cache=True,
            kv_lens=torch.tensor([lp], dtype=torch.int32, device=dev))
        pv = torch.from_numpy(pages_vec).to(dev)
        for (k, v, ks, vs), (kd, vd) in zip(self._pages, dense_kv):
            write_prompt_kv(k, v, ks, vs, kd, vd, pv)
        tok = self._sample_rows(
            logits[0, lp - 1][None], torch.tensor([key], device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))[0]
        return int(tok), pages  # host sync: the first token exists now

    # -- host-side scheduling --------------------------------------------------

    def _finish_slot(self, b):
        slot = self._slots[b]
        req = slot.req
        self._finished.append({
            "id": req.rid, "prompt": req.prompt.tolist(),
            "tokens": slot.out_tokens[:req.max_new_tokens],
            "status": "ok", "ttft_s": slot.ttft_s,
            "age_s": time.perf_counter() - req.submitted_at})
        self._free_pages.extend(slot.pages)
        self._slots[b] = None
        self._active[b] = False
        self._done[b] = True
        self._page_table[b, :] = TRASH_PAGE
        self._seq_lens[b] = 0
        self._emitted[b] = 0
        self._eos[b] = -1
        self._dev_sched = None

    def _evict(self):
        for b in range(self.max_slots):
            if self._slots[b] is not None and self._done[b]:
                self._finish_slot(b)

    def _admit(self):
        while self._queue:
            req = self._queue[0]
            free_slot = next((b for b in range(self.max_slots)
                              if self._slots[b] is None), None)
            need_pages = -(-(len(req.prompt) + req.max_new_tokens)
                           // self.page_size)
            if free_slot is None or len(self._free_pages) < need_pages:
                return  # back-pressure: retry at the next boundary
            self._queue.popleft()
            self._admit_one(free_slot, req, need_pages)

    def _admit_one(self, b, req, need_pages):
        key = int(torch.randint(0, 2 ** 31 - 1, (1,),
                                generator=self._rng).item())
        tok, pages = self._prefill(req, need_pages, key)
        slot = _Slot(req, pages, time.perf_counter() - req.submitted_at)
        slot.out_tokens.append(tok)
        self._slots[b] = slot
        row = np.full((self.max_pages_per_seq,), TRASH_PAGE, np.int32)
        row[:need_pages] = pages
        self._page_table[b] = row
        self._seq_lens[b] = len(req.prompt)
        self._last_tokens[b] = tok
        self._emitted[b] = 1
        self._max_new[b] = req.max_new_tokens
        self._eos[b] = -1 if req.eos_token_id is None \
            else int(req.eos_token_id)
        self._key_base[b] = key
        self._active[b] = True
        self._done[b] = bool(req.max_new_tokens <= 1
                             or (req.eos_token_id is not None
                                 and tok == req.eos_token_id))
        self._dev_sched = None
