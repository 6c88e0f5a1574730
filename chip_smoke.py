#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. build   — compile every kernel under paddle_tpu_torch/csrc with nvcc
             (one process per source, all started together);
2. flash   — the flash-attention forward kernel vs its plain PyTorch twin
             at gpt3-345M prefill shapes (B=1, H=16, D=64, S in 64..1024,
             causal, kv_lens < S; f32 and bf16), plus D=128, sq != sk and
             kv_lens=0; times kernel, plain twin and torch SDPA;
3. decode  — the paged decode kernel vs its plain twin (paged_attention_ref)
             at serving shapes (B in {8, 32}, Hkv=16, G=1, ps=16, MP=64;
             f32, bf16, int8 pools), plus G=4 and a batch with lens 0 and
             lens on a page boundary;
4. slice   — gpt3-345M at full width with seeded random weights, f32 on
             cuda, serving 16 greedy requests (prompts 64..512, 64 new
             tokens) through ServingEngine(max_slots=8, page_size=16,
             max_seq_len=1024); both kernels' launch counters must be > 0
             and the free list must come back whole; 2 requests are served
             again on the CPU and must agree (prefill last-row logits
             within 1e-3, first token equal).

Tolerances on the card (kernel vs plain twin, same inputs):
  f32  1e-4 — the kernel sums in another order than the dense plain path;
  bf16 2e-2 — bf16 inputs and outputs round at 8 bits of mantissa;
  int8 1e-4 — both dequantize value * scale in f32 the same way; only
              the summation order differs.
TF32 is switched off for matmuls and cuDNN so the plain twins and the
model's projections compute in full f32.

Prints the kernel table as one JSON line, the card's name and power limit
(nvidia-smi), and as the last line {"ok": true, "device": {...}}. Exits
non-zero without a result when no CUDA device is present or when the
package is not beside this script.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and f32 FLOP/s on the
# CUDA cores, the rate the kernels' f32 arithmetic runs at
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

TOL = {"float32": 1e-4, "bfloat16": 2e-2, "int8": 1e-4}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# -- timing -------------------------------------------------------------------

def time_ms(torch, fn, iters=10, flush=None):
    """Mean device ms of fn() over iters launches, CUDA events around each
    launch only; ``flush`` (run between launches, untimed) evicts L2."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        if flush is not None:
            flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in evs) / iters


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phases -------------------------------------------------------------------

def phase_build():
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    built = _build.build_all()
    secs = time.perf_counter() - t0
    for name in _build.sources():
        check(os.path.exists(_build._lib_path(name)[1]),
              f"build: {name} produced no library")
        logtxt = built.get(name, (0, ""))[1]
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", logtxt)]
        spills = [int(x) for x in
                  re.findall(r"(\d+) bytes spill stores", logtxt)]
        log(f"build: {name}: {len(regs)} kernels, max registers "
            f"{max(regs) if regs else 'n/a'}, max spill stores "
            f"{max(spills) if spills else 0} bytes")
    log(f"build: {len(_build.sources())} sources in {secs:.2f} s "
        "(parallel nvcc, sm_90a)")
    return secs


def _flash_case(torch, b, h, sq, sk, d, dtype, lens, gen, flush,
                timed):
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    dt = getattr(torch, dtype)
    mk = lambda s: torch.randn(b * h, s, d, generator=gen,  # noqa: E731
                               device="cuda").to(dt)
    q, k, v = mk(sq), mk(sk), mk(sk)
    lens_t = None if lens is None else torch.tensor(
        [x for x in lens for _ in range(h)], dtype=torch.int32,
        device="cuda")
    o, lse = kfa.flash_attention_fwd(q, k, v, lens_t, causal=True)
    torch.cuda.synchronize()
    po, plse = kfa.flash_attention_fwd_plain(q, k, v, lens_t, causal=True)
    err = (o.float() - po.float()).abs().max().item()
    lerr = (lse - plse).abs().max().item()
    check(math.isfinite(err) and err <= TOL[dtype],
          f"flash {dtype} b{b} h{h} sq{sq} sk{sk} d{d} lens{lens}: "
          f"max_abs_err {err} > {TOL[dtype]}")
    check(math.isfinite(lerr) and lerr <= 1e-3,
          f"flash lse b{b} sq{sq} sk{sk}: max_abs_err {lerr}")
    row = dict(dtype=dtype, b=b, h=h, sq=sq, sk=sk, d=d, lens=lens,
               max_abs_err=err)
    if timed:
        row["ms"] = time_ms(torch, lambda: kfa.flash_attention_fwd(
            q, k, v, lens_t, causal=True), flush=flush)
        row["plain_ms"] = time_ms(torch, lambda: kfa.flash_attention_fwd_plain(
            q, k, v, lens_t, causal=True), flush=flush)
        # torch SDPA on the same function, as the yardstick
        qt, kt, vt = (x.view(b, h, -1, d) for x in (q, k, v))
        qpos = torch.arange(sq, device="cuda")[:, None]
        kpos = torch.arange(sk, device="cuda")[None, :]
        keep = (kpos <= qpos + (sk - sq))[None, None]
        if lens is not None:
            keep = keep & (kpos[None, None] < torch.tensor(
                lens, device="cuda")[:, None, None, None])
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["library_ms"] = time_ms(torch, lambda: sdpa(
            qt, kt, vt, attn_mask=keep), flush=flush)
        # work this run's data needs: visible (q, k) pairs, causal + lens
        vis = 0
        for bi in range(b):
            kl = sk if lens is None else min(lens[bi], sk)
            for r in range(sq):
                vis += max(0, min(r + sk - sq + 1, kl))
        esz = q.element_size()
        bytes_moved = (b * h * (sq + 2 * sk) * d * esz  # q, k, v read
                       + b * h * sq * d * esz            # o written
                       + b * h * sq * 4)                 # lse written
        row["bound_ms"], row["bound_by"] = bound(bytes_moved,
                                                 4 * d * h * vis)
    return row


def phase_flash(torch, flush):
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for s in (64, 128, 512, 1024):
        lens = [s - 1 - s // 10]
        for dtype in ("float32", "bfloat16"):
            rows.append(_flash_case(torch, 1, 16, s, s, 64, dtype,
                                    lens, gen, flush,
                                    timed=dtype == "float32"))
    rows.append(_flash_case(torch, 1, 16, 256, 256, 128, "float32",
                            [200], gen, flush, False))
    rows.append(_flash_case(torch, 2, 4, 96, 320, 64, "float32",
                            [320, 150], gen, flush, False))
    rows.append(_flash_case(torch, 2, 4, 64, 64, 64, "float32",
                            [0, 64], gen, flush, False))
    for r in rows:
        extra = "" if "ms" not in r else (
            f" ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
            f"sdpa_ms {r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
            f"({r['bound_by']})")
        log(f"flash: {r['dtype']} b{r['b']} h{r['h']} sq{r['sq']} "
            f"sk{r['sk']} d{r['d']} lens{r['lens']} max_abs_err "
            f"{r['max_abs_err']:.3e}{extra}")
    return rows


def _decode_case(torch, b, hkv, g, d, ps, mp, dtype, lens, gen, flush,
                 timed):
    from paddle_tpu_torch.nlp.paged_cache import (paged_attention_ref,
                                                  quantize_rows)
    from paddle_tpu_torch.ops.kernels.flash_decode import paged_flash_decode
    num_pages = b * mp + 1
    q = torch.randn(b, hkv, g, d, generator=gen, device="cuda")
    kf = torch.randn(hkv, num_pages, ps, d, generator=gen, device="cuda")
    vf = torch.randn(hkv, num_pages, ps, d, generator=gen, device="cuda")
    ks = vs = None
    if dtype == "int8":
        kp, ks = quantize_rows(kf)
        vp, vs = quantize_rows(vf)
    else:
        kp, vp = kf.to(getattr(torch, dtype)), vf.to(getattr(torch, dtype))
    del kf, vf
    # each slot owns its own pages; entries past its pages are trash
    pt = (1 + torch.randperm(b * mp, generator=gen, device="cuda")
          .view(b, mp)).int()
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    used = (lens_t.long() + ps - 1) // ps
    pt = torch.where(torch.arange(mp, device="cuda")[None] < used[:, None],
                     pt, torch.zeros_like(pt)).contiguous()
    out = paged_flash_decode(q, kp, vp, pt, lens_t, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    ref = paged_attention_ref(q, kp, vp, pt, lens_t, k_scale=ks, v_scale=vs)
    err = (out - ref).abs().max().item()
    check(math.isfinite(err) and err <= TOL[dtype],
          f"decode {dtype} b{b} hkv{hkv} g{g}: max_abs_err {err} > "
          f"{TOL[dtype]}")
    zero = [i for i, n in enumerate(lens) if n == 0]
    check(not out[zero].any().item() if zero else True,
          "decode: a lens-0 slot gave a nonzero row")
    row = dict(dtype=dtype, b=b, hkv=hkv, g=g, d=d, ps=ps, mp=mp,
               max_abs_err=err)
    if timed:
        row["ms"] = time_ms(torch, lambda: paged_flash_decode(
            q, kp, vp, pt, lens_t, k_scale=ks, v_scale=vs), flush=flush)
        row["plain_ms"] = time_ms(torch, lambda: paged_attention_ref(
            q, kp, vp, pt, lens_t, k_scale=ks, v_scale=vs), flush=flush)
        keys = int(sum(lens))
        esz = kp.element_size()
        bytes_moved = (q.numel() * 4 + out.numel() * 4   # q read, out written
                       + 2 * hkv * keys * d * esz        # live K and V rows
                       + (2 * hkv * keys * 4 if ks is not None else 0)
                       + pt.numel() * 4 + b * 4)         # table, lens
        row["bound_ms"], row["bound_by"] = bound(bytes_moved,
                                                 4 * hkv * g * d * keys)
    return row


def phase_decode(torch, flush):
    import numpy as np
    rng = np.random.default_rng(2)
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for b in (8, 32):
        # the slice's lengths: prompts 64..512 plus up to 64 new tokens
        lens = rng.integers(65, 577, b).tolist()
        for dtype in ("float32", "bfloat16", "int8"):
            rows.append(_decode_case(torch, b, 16, 1, 64, 16, 64, dtype,
                                     lens, gen, flush, timed=True))
    rows.append(_decode_case(torch, 8, 4, 4, 64, 16, 64, "float32",
                             rng.integers(1, 1025, 8).tolist(), gen, flush,
                             timed=True))
    # lens 0, exactly on page boundaries, one key, the full table
    edge = [0, 16, 32, 1, 1024, 0, 160, 17]
    for dtype in ("float32", "int8"):
        rows.append(_decode_case(torch, 8, 16, 1, 64, 16, 64, dtype, edge,
                                 gen, flush, timed=False))
    for r in rows:
        extra = "" if "ms" not in r else (
            f" ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']})")
        log(f"decode: {r['dtype']} b{r['b']} hkv{r['hkv']} g{r['g']} "
            f"d{r['d']} ps{r['ps']} mp{r['mp']} max_abs_err "
            f"{r['max_abs_err']:.3e}{extra}")
    return rows


def phase_slice(torch):
    import numpy as np
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.nlp.gpt import GPTForCausalLM, _resolve_config
    from paddle_tpu_torch.nlp.serving import ServingEngine
    from paddle_tpu_torch.ops.kernels import WRAPPERS

    cfg = _resolve_config("gpt3-345M")
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=seed(0)).eval()
    torch.cuda.synchronize()
    log(f"slice: gpt3-345M built on cuda in {time.perf_counter() - t0:.2f}"
        f" s ({sum(p.numel() for p in model.parameters())} parameters, "
        f"hidden {cfg.hidden_size}, {cfg.num_hidden_layers} layers, "
        f"{cfg.num_attention_heads} heads, vocab {cfg.vocab_size})")
    rng = np.random.default_rng(0)
    lens = [64 + (448 * i) // 15 for i in range(16)]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    new = 64
    eng_kw = dict(max_slots=8, page_size=16, max_seq_len=1024)
    eng = ServingEngine(model, device="cuda", **eng_kw)
    eng.generate([prompts[0][:32]], max_new_tokens=2)   # warm-up
    eng.reset_counters()

    for w in WRAPPERS:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [eng.submit(p, new) for p in prompts]
    res = {r["id"]: r for r in eng.run_to_completion()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in WRAPPERS}
    log(f"slice: kernel launches in the main path: {launches}")
    for name, n in launches.items():
        check(n > 0, f"slice: kernel {name} never launched on the main path")
    check(eng.free_page_count == eng.num_pages - 1,
          f"slice: free pages {eng.free_page_count} != "
          f"{eng.num_pages - 1} after the run")
    toks = [res[i]["tokens"] for i in ids]
    for t in toks:
        check(len(t) == new and all(0 <= x < cfg.vocab_size for x in t),
              f"slice: bad token stream {t[:8]}...")
    ttft = sorted(res[i]["ttft_s"] for i in ids)
    ttft_p50 = float(np.percentile(ttft, 50))
    tok_s = eng.decode_tokens / eng.decode_seconds
    log(f"slice: served {len(ids)} requests x {new} tokens in {wall:.3f} s;"
        f" TTFT p50 {ttft_p50 * 1e3:.2f} ms (min {ttft[0] * 1e3:.2f}, max "
        f"{ttft[-1] * 1e3:.2f}); decode {eng.decode_tokens} tokens in "
        f"{eng.decode_seconds:.3f} s over {eng.decode_dispatches} "
        f"dispatches = {tok_s:.1f} tokens/s")

    busy_share = profile_decode(torch, eng, prompts)

    # the same weights on the CPU: 2 of the requests again
    cpu = GPTForCausalLM(cfg, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    pick = [0, 1]
    with torch.no_grad():
        for i in pick:
            p = prompts[i]
            bucket = eng._bucket_for(len(p))
            x = np.zeros((1, bucket), np.int32)
            x[0, :len(p)] = p
            rows = []
            for m, dev in ((model, "cuda"), (cpu, "cpu")):
                lg = m(torch.from_numpy(x).to(dev), kv_lens=torch.tensor(
                    [len(p)], dtype=torch.int32, device=dev))
                rows.append(lg[0, len(p) - 1].float().cpu())
            err = (rows[0] - rows[1]).abs().max().item()
            check(torch.isfinite(rows[0]).all().item() and err <= 1e-3,
                  f"slice: prefill last-row logits differ by {err} "
                  f"between cuda and cpu (request {i})")
            log(f"slice: request {i} (prompt {len(p)}, bucket {bucket}): "
                f"prefill last-row logits cuda vs cpu max_abs_err "
                f"{err:.3e}")
    cpu_eng = ServingEngine(cpu, device="cpu", **dict(eng_kw, max_slots=2))
    cpu_toks = cpu_eng.generate([prompts[i] for i in pick],
                                max_new_tokens=new)
    agree = total = 0
    for i, ct in zip(pick, cpu_toks):
        check(ct[0] == toks[i][0], f"slice: first token differs cuda "
              f"{toks[i][0]} vs cpu {ct[0]} (request {i})")
        agree += sum(a == b for a, b in zip(ct, toks[i]))
        total += len(ct)
    log(f"slice: greedy tokens cuda vs cpu agree on {agree}/{total} "
        f"({agree / total:.3f}); first tokens equal")
    return dict(launches=launches, ttft_p50_s=ttft_p50, decode_tok_s=tok_s,
                wall_s=wall, decode_busy_share=busy_share)


def profile_decode(torch, eng, prompts):
    """One full-pool decode dispatch (8 live slots x steps_per_dispatch
    tokens) under torch.profiler: the device's busy share of the
    dispatch's wall time and the kernels that take the device time. The
    profiler's own host cost makes the wall longer, so the share is a
    lower bound."""
    from torch.profiler import ProfilerActivity, profile
    for p in prompts[:eng.max_slots]:
        eng.submit(p[:64], 1 + 3 * eng.steps_per_dispatch)
    eng.step()                      # admissions + the first dispatch
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run_to_completion()
    from torch.autograd import DeviceType
    # device-side rows only: the CPU ops that launched them carry the
    # same time again as their own self device time
    rows = sorted((a for a in prof.key_averages()
                   if a.device_type == DeviceType.CUDA),
                  key=lambda a: a.self_device_time_total, reverse=True)
    busy = sum(a.self_device_time_total for a in rows) / 1e6
    if busy <= 0:
        log("profile: the profiler recorded no device time; decode busy "
            "share not measured")
        return None
    log(f"profile: one decode dispatch ({eng.max_slots} slots x "
        f"{eng.steps_per_dispatch} steps): wall {wall * 1e3:.3f} ms under "
        f"the profiler, device busy {busy * 1e3:.3f} ms = "
        f"{busy / wall:.3f} of it")
    for a in rows[:8]:
        log(f"profile:   {a.self_device_time_total / 1e3:9.3f} ms  "
            f"x{a.count:<5d} {a.key[:90]}")
    return busy / wall


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch", "csrc")):
        print("chip_smoke: paddle_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}; TF32 off for matmul and cuDNN")

    phase_build()
    # a 256 MB write between timed launches evicts the 50 MB L2, as the
    # model's weight reads do between a layer's attention calls
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    flush = scratch.zero_
    flash = phase_flash(torch, flush)
    decode = phase_decode(torch, flush)
    del scratch
    sl = phase_slice(torch)

    fmain = next(r for r in flash if r["dtype"] == "float32"
                 and r["sq"] == 512)
    dmain = next(r for r in decode if r["dtype"] == "float32"
                 and r["b"] == 8 and r["g"] == 1 and "ms" in r)
    kernels = [
        dict(name="flash_attention_fwd", route="cuda",
             source="paddle_tpu_torch/csrc/flash_attention_fwd.cu",
             replaces="paddle_tpu/ops/pallas/flash_attention.py:309",
             launches=sl["launches"]["flash_attention_fwd"],
             max_abs_err=max(r["max_abs_err"] for r in flash
                             if r["dtype"] == "float32"),
             ms=fmain["ms"], plain_ms=fmain["plain_ms"],
             bound_ms=fmain["bound_ms"], bound_by=fmain["bound_by"],
             library_ms=fmain["library_ms"]),
        dict(name="paged_flash_decode", route="cuda",
             source="paddle_tpu_torch/csrc/paged_flash_decode.cu",
             replaces="paddle_tpu/ops/pallas/flash_decode.py:99",
             launches=sl["launches"]["paged_flash_decode"],
             max_abs_err=max(r["max_abs_err"] for r in decode
                             if r["dtype"] == "float32"),
             ms=dmain["ms"], plain_ms=dmain["plain_ms"],
             bound_ms=dmain["bound_ms"], bound_by=dmain["bound_by"],
             library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
