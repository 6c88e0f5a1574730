"""Autoregressive decoding over a static KV cache (counterpart of
``paddle_tpu/nlp/generation.py``).

ref parity: paddlenlp.generation.GenerationMixin — greedy, sampling
(temperature / top-k / top-p), repetition penalty, eos with pad-filled
tails, and beam search. The reference compiles the whole decode into one
XLA program (a ``lax.scan`` over a static cache); here it is an eager
loop over the model, PyTorch's idiom, with the same structure:

- static KV cache: fixed ``[B, S_max, Hkv, D]`` buffers per layer,
  written in place at ``cache_index`` (the models' ``_forward_static_cache``);
  a single-token step of an MHA model attends through the dense decode
  kernel on the card;
- the prompt is prefilled in one forward, then every one of the
  ``max_new_tokens`` steps samples a token and runs one forward, as the
  scan's body does (the last step's logits go unused there too);
- no host sync in the loop (no ``.item()``, no test of ``done``) and no
  early exit: finished rows emit ``pad_token_id``, as in the scan;
- the sampler draws from an explicit ``torch.Generator`` on the model's
  device, seeded by ``seed``. Its stream is not JAX's: sampled tokens are
  the port's own, greedy and beam search are token-exact with the
  reference.

``build_decode_fn`` and ``build_beam_decode_fn`` return closures over the
model (there are no params/buffers pytrees to pass in eager PyTorch).
"""
from __future__ import annotations

import threading

import torch

from ..framework import convert_dtype

__all__ = ["generate", "build_decode_fn", "build_beam_decode_fn",
           "clear_decode_cache"]

# Per-model RLock: generate() holds it for the whole call. The static
# cache is per call, but the loop runs the shared module eagerly (eval
# mode is set and restored around it), so concurrent calls on ONE model
# are serialized; calls on independent models run concurrently. The tiny
# global lock guards only the lock attribute's creation.
_LOCK_ATTR = "_paddle_tpu_decode_lock"
_lock_creation_lock = threading.Lock()


def _model_lock(model):
    lock = getattr(model, _LOCK_ATTR, None)
    if lock is None:
        with _lock_creation_lock:
            lock = getattr(model, _LOCK_ATTR, None)
            if lock is None:
                lock = threading.RLock()
                object.__setattr__(model, _LOCK_ATTR, lock)
    return lock


def clear_decode_cache(model):
    """Kept for the reference's API. The reference memoizes compiled decode
    programs on the model and this drops them; eager PyTorch compiles
    nothing, so there is nothing to clear and the call does nothing."""
    with _model_lock(model):
        return None


def _apply_repetition_penalty(logits, seen, penalty):
    """CTRL-style (ref: paddlenlp.generation repetition_penalty): seen
    tokens' logits are divided by ``penalty`` when positive, multiplied
    when negative — always pushing them down."""
    pen = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, pen, logits)


def _mask_top_p(logits, top_p):
    """Nucleus filtering: keep the smallest prefix of the descending
    softmax whose cumulative probability covers top_p (always the top
    token); the rest go to -inf. ref: paddlenlp TopPProcess."""
    sorted_l = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
    keep_sorted = torch.cat(
        [torch.ones_like(cum[:, :1], dtype=torch.bool),
         (cum < top_p)[:, :-1]], dim=-1)
    # threshold per row: the smallest kept logit
    thresh = torch.where(keep_sorted, sorted_l,
                         torch.full_like(sorted_l, float("inf"))
                         ).amin(dim=-1, keepdim=True)
    return torch.where(logits >= thresh, logits,
                       torch.full_like(logits, -float("inf")))


def _categorical(logits, generator):
    """One draw per row from softmax(logits), by Gumbel-max (what
    jax.random.categorical computes), with no host sync."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _alloc_cache(cfg, batch, s_max, dtype, device):
    """Zeroed per-layer (k, v) buffers [batch, s_max, Hkv, D]. GQA models
    (Llama-style num_key_value_heads < heads) cache only the kv heads."""
    kv_heads = getattr(cfg, "num_key_value_heads", 0) \
        or cfg.num_attention_heads
    shape = (batch, s_max, kv_heads, cfg.head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.num_hidden_layers)]


def _cache_fwd(model, tok, cache, idx):
    """One cached forward -> (f32 logits of the last position, cache)."""
    logits, cache = model(tok, cache=cache, cache_index=idx)
    return logits[:, -1, :].float(), cache


def _seen_from_prompt(ids, vocab_size, pad_token_id=None):
    """[B, V] bool presence mask of the prompt's tokens, by scatter.
    Prompt occurrences of pad_token_id are exempt: left-padded prompts
    (often pad == eos) must not leave the pad/eos logit penalized for the
    whole decode; tokens emitted during decode are penalized whatever
    their id."""
    seen = torch.zeros(ids.shape[0], vocab_size, dtype=torch.bool,
                       device=ids.device)
    seen.scatter_(1, ids.long(), True)
    if pad_token_id is not None:
        seen[:, pad_token_id] = False
    return seen


def _mark_seen(seen, tok, live):
    """seen | one_hot(tok) on the rows (or beams) where ``live``: finished
    rows emit pad filler, which must not accrue penalty."""
    idx = tok.long().unsqueeze(-1)
    return seen.scatter(-1, idx, seen.gather(-1, idx) | live.unsqueeze(-1))


def build_decode_fn(model, max_new_tokens, temperature=1.0, top_k=0,
                    top_p=1.0, repetition_penalty=1.0, eos_token_id=None,
                    pad_token_id=0, do_sample=None, cache_dtype="float32"):
    """-> decode(ids, generator) -> [B, S0 + max_new_tokens] ids, for a
    model that takes the static cache/cache_index contract (GPT, Llama).

    ref parity: GenerationMixin's sampling path — temperature / top_k /
    top_p / repetition_penalty / eos (finished rows emit pad_token_id).
    do_sample=True forces sampling even with no filter (pure temperature
    sampling); None infers it from the filters. ``generator`` (a
    torch.Generator on the model's device) is drawn from only when
    sampling."""
    cfg = model.config
    if do_sample is None:
        do_sample = bool(temperature > 0 and (top_k or top_p < 1.0))
    sampling = do_sample and temperature > 0
    track_seen = repetition_penalty != 1.0
    cache_dt = convert_dtype(cache_dtype)

    def sample(last, seen, generator):
        if track_seen:
            last = _apply_repetition_penalty(last, seen, repetition_penalty)
        if not sampling:
            return torch.argmax(last, dim=-1)
        last = last / temperature
        if top_k:
            vals, cand = torch.topk(last, top_k, dim=-1)
            if top_p < 1.0:
                vals = _mask_top_p(vals, top_p)
            pick = _categorical(vals, generator)
            return torch.gather(cand, 1, pick[:, None])[:, 0]
        if top_p < 1.0:
            last = _mask_top_p(last, top_p)
        return _categorical(last, generator)

    @torch.no_grad()
    def decode(ids, generator=None):
        b, s0 = ids.shape
        cache = _alloc_cache(cfg, b, s0 + max_new_tokens, cache_dt,
                             ids.device)
        last, cache = _cache_fwd(model, ids, cache, 0)
        seen = _seen_from_prompt(ids, cfg.vocab_size, pad_token_id) \
            if track_seen else None
        done = torch.zeros(b, dtype=torch.bool, device=ids.device)
        toks = []
        for t in range(max_new_tokens):
            nxt = sample(last, seen, generator).to(ids.dtype)
            if eos_token_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, pad_token_id),
                                  nxt)
                done = done | (nxt == eos_token_id)
            if track_seen:
                seen = _mark_seen(seen, nxt, ~done)
            toks.append(nxt)
            last, cache = _cache_fwd(model, nxt[:, None], cache, s0 + t)
        return torch.cat([ids] + [x[:, None] for x in toks], dim=1)

    return decode


def build_beam_decode_fn(model, max_new_tokens, num_beams,
                         length_penalty=1.0, eos_token_id=None,
                         pad_token_id=0, temperature=1.0,
                         repetition_penalty=1.0, cache_dtype="float32"):
    """-> decode(ids) -> [B, S0 + max_new_tokens] ids: beam search (ref:
    GenerationMixin decode_strategy='beam_search').

    All B*K beams run as one batch; each step scores [B, K*V]
    continuations, keeps the top K and reorders every layer's cache with
    ``index_select`` over the beam axis (the reference's gather). Finished
    beams (emitted eos) are frozen: they extend only with pad at an
    unchanged score. The answer is each row's best score / len **
    length_penalty. num_beams=1 is greedy. temperature scales the logits
    before scoring; repetition_penalty follows each beam's own tokens."""
    cfg = model.config
    cache_dt = convert_dtype(cache_dtype)
    k = int(num_beams)
    track_seen = repetition_penalty != 1.0

    @torch.no_grad()
    def decode(ids):
        b, s0 = ids.shape
        v = cfg.vocab_size
        dev = ids.device
        # prefill the B prompts once, then tile the cache and logits per
        # beam
        cache = _alloc_cache(cfg, b, s0 + max_new_tokens, cache_dt, dev)
        last, cache = _cache_fwd(model, ids, cache, 0)
        cache = [(kk.repeat_interleave(k, 0), vv.repeat_interleave(k, 0))
                 for kk, vv in cache]
        last = last.repeat_interleave(k, 0)                  # [B*K, V]
        seen = (_seen_from_prompt(ids, v, pad_token_id)
                .repeat_interleave(k, 0).reshape(b, k, v)
                if track_seen else None)
        scores = torch.full((b, k), -float("inf"), device=dev)
        scores[:, 0] = 0.0
        seqs = torch.full((b, k, max_new_tokens), pad_token_id,
                          dtype=ids.dtype, device=dev)
        done = torch.zeros(b, k, dtype=torch.bool, device=dev)
        frozen = torch.full((v,), -float("inf"), device=dev)
        frozen[pad_token_id] = 0.0
        rows = torch.arange(b, device=dev)[:, None] * k
        for t in range(max_new_tokens):
            if track_seen:
                last = _apply_repetition_penalty(
                    last, seen.reshape(b * k, v), repetition_penalty)
            if temperature not in (0.0, 1.0):
                last = last / temperature
            logp = torch.log_softmax(last, dim=-1).reshape(b, k, v)
            if eos_token_id is not None:
                # frozen beams: only pad continues, at zero added score
                logp = torch.where(done[:, :, None], frozen, logp)
            total = scores[:, :, None] + logp                # [B, K, V]
            scores, top_idx = torch.topk(total.reshape(b, k * v), k, dim=-1)
            beam_idx = top_idx // v                          # [B, K]
            tok = (top_idx % v).to(ids.dtype)                # [B, K]
            # reorder everything that is per-beam state
            flat = (rows + beam_idx).reshape(-1)
            cache = [(kk.index_select(0, flat), vv.index_select(0, flat))
                     for kk, vv in cache]
            seqs = torch.gather(seqs, 1, beam_idx[:, :, None].expand(
                b, k, max_new_tokens))
            done = torch.gather(done, 1, beam_idx)
            seqs[:, :, t] = tok
            if eos_token_id is not None:
                done = done | (tok == eos_token_id)
            if track_seen:
                seen = torch.gather(seen, 1, beam_idx[:, :, None].expand(
                    b, k, v))
                seen = _mark_seen(seen, tok, ~done)
            last, cache = _cache_fwd(model, tok.reshape(b * k, 1), cache,
                                     s0 + t)
        # sequence lengths: position of eos + 1, else max_new_tokens
        if eos_token_id is not None:
            is_eos = seqs == eos_token_id
            first = torch.argmax(is_eos.int(), dim=-1) + 1
            lens = torch.where(is_eos.any(dim=-1), first,
                               torch.full_like(first, max_new_tokens))
        else:
            lens = torch.full((b, k), max_new_tokens, device=dev)
        norm = scores / lens.float() ** length_penalty
        best = torch.argmax(norm, dim=-1)                    # [B]
        best_seq = torch.gather(seqs, 1, best[:, None, None].expand(
            b, 1, max_new_tokens))[:, 0]
        return torch.cat([ids, best_seq], dim=1)

    return decode


def generate(model, input_ids, max_new_tokens=20, temperature=1.0,
             top_k=0, top_p=1.0, repetition_penalty=1.0, num_beams=1,
             length_penalty=1.0, eos_token_id=None, pad_token_id=0,
             decode_strategy=None, seed=None, cache_dtype="float32"):
    """One-call decode -> [B, S0 + max_new_tokens] ids on the model's
    device, in input_ids' integer dtype. decode_strategy: None (inferred
    from the arguments) | 'greedy_search' | 'sampling' | 'beam_search' —
    ref: paddlenlp GenerationMixin. ``seed`` seeds the sampler's
    torch.Generator (None means 0, as in the reference's
    GPTForCausalLM.generate). Thread-safe: the call holds a per-model
    lock."""
    with _model_lock(model):
        return _generate_locked(
            model, input_ids, int(max_new_tokens), float(temperature),
            int(top_k), float(top_p), float(repetition_penalty),
            int(num_beams), float(length_penalty),
            None if eos_token_id is None else int(eos_token_id),
            None if pad_token_id is None else int(pad_token_id),
            decode_strategy, 0 if seed is None else int(seed), cache_dtype)


def _generate_locked(model, input_ids, max_new_tokens, temperature, top_k,
                     top_p, repetition_penalty, num_beams, length_penalty,
                     eos_token_id, pad_token_id, decode_strategy, seed,
                     cache_dtype):
    if decode_strategy not in (None, "greedy_search", "sampling",
                               "beam_search"):
        raise ValueError(f"unknown decode_strategy {decode_strategy!r}")
    device = next(model.parameters()).device
    ids = torch.as_tensor(input_ids, device=device)
    was_training = model.training
    model.eval()
    try:
        if decode_strategy == "beam_search" or (decode_strategy is None
                                                and num_beams > 1):
            if top_k or top_p < 1.0:
                raise ValueError(
                    "beam_search scores exhaustively — top_k/top_p do not "
                    "apply (use decode_strategy='sampling' for filtered "
                    "sampling)")
            return build_beam_decode_fn(
                model, max_new_tokens, max(num_beams, 1), length_penalty,
                eos_token_id, pad_token_id, temperature, repetition_penalty,
                cache_dtype=cache_dtype)(ids)
        do_sample = None
        if decode_strategy == "greedy_search":
            temperature, do_sample = 0.0, False
        elif decode_strategy == "sampling":
            do_sample = True
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        return build_decode_fn(
            model, max_new_tokens, temperature, top_k, top_p,
            repetition_penalty, eos_token_id, pad_token_id,
            do_sample=do_sample, cache_dtype=cache_dtype)(ids, generator)
    finally:
        if was_training:
            model.train()
