"""Flash attention, forward and backward: the CUDA kernels' wrappers, their
plain twins and the autograd function that joins them.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py`` (``_fwd_call``,
``_bwd_call`` and the ``custom_vjp`` around them). Layout is the kernels'
folded ``[B*H, S, D]``; ``ops.attention.flash_attention`` takes the public
``[B, S, H, D]`` layout and folds.

- ``flash_attention_fwd`` — forward -> (o, lse): a CPU tensor runs
  ``flash_attention_fwd_plain``; a CUDA tensor launches
  ``csrc/flash_attention_fwd.cu`` or raises.
- ``flash_attention_bwd_dq`` -> (dq, delta) and ``flash_attention_bwd_dkv``
  -> (dk, dv) — the backward, the same way: plain twins on the CPU, the
  two kernels of ``csrc/flash_attention_bwd.cu`` on CUDA. ``delta =
  rowsum(dO * o)`` is a side output of the dq kernel that the dk/dv kernel
  reads.
- ``flash_attention_bwd`` -> (dq, dk, dv): the two backward wrappers in
  turn, what the autograd function's backward runs on either device;
  ``flash_attention_bwd_plain`` is the same in plain PyTorch.
- ``flash_attention_bhsd`` — the differentiable entry: one
  ``torch.autograd.Function`` whose forward saves (q, k, v, o, lse, lens,
  seed, mask) and whose backward runs the kernels on CUDA and the plain
  twins on the CPU, so both devices differentiate through the same math.
- ``dropout_keep`` — the attention-dropout keep mask, the TPU kernel's
  murmur3 hash of (seed, batch*head, q_pos * sk + k_pos) in plain
  PyTorch; the kernels compute the same bits.
- ``flash_decode`` — single-query decode over a dense padded cache (the
  reference's ``flash_decode``, its ``_fwd_call`` with one query row and
  ``kv_lens``), in the public layout: q ``[B, 1, H, D]``, the cache
  ``[B, S, H, D]`` read in place through its strides. A CPU tensor runs
  ``flash_decode_plain``; a CUDA tensor launches ``csrc/flash_decode.cu``
  or raises.

Each wrapper counts its launches in ``<wrapper>.launches``, and the three
flash wrappers their launches with a dense mask in
``<wrapper>.masked_launches`` too.

Dense masks (``mask=``, the forward and both backward kernels): one
tensor, bool (a keep-mask) or float (an additive bias), shaped [B, H, Sq,
Sk] with B * H the folded rows, usually an ``expand``-ed view whose
broadcast dimensions have stride 0 (``ops.attention.flash_attention``
makes it): the kernels read it through its four strides, so a [B, 1, 1,
Sk] padding mask costs B * Sk values. It is applied as the reference's
dense path applies it, after the scale and the causal mask: a bool mask
by ``where(mask, s, -inf)``, a float mask by addition in f32, with no
floor on the biased scores (a bias of -3.4e38 gives its row a softmax
over those keys, as the reference does). Under a mask lse is [2, BH, Sq]:
the row log-sum-exp m + log(l) as hi (f32) and lo, its rounding error
(``_two_sum``), since a row whose biased scores all lie near -3.4e38 has
hi = m and keeps log(l) in lo alone; the backward recomputes p =
exp((s - hi) - lo). A row with no visible key gives what the reference's
path gives, NaN (o and lse), and its gradient the reference's
(``flash_attention_bwd_plain``); under ``lens`` such a row keeps the TPU
kernel's 0. The mask takes no gradient, and ``mask`` with ``lens``
raises: no caller passes both. On CUDA a masked call runs each kernel's
DENSE instantiation, which every variant has (the C entries pick it when
they are given a mask).

Dtypes on the card: the forward, the backward and the dense decode take
float32, bfloat16 and float16 (``_DTYPES``; the decode's q and cache share
one). Head dims on the card: 64, 128 and 256 for every
kernel (``HEAD_DIMS``); the f32 forward and the f32 backward also take 32
(``F32_HEAD_DIMS``: DETR's d_model 256 over 8 heads). A bf16 or f16 call
at 32 on CUDA raises, naming ROADMAP.md queue 2; the plain twins take any
head dim and any of these dtypes on the CPU, rounding p, ds and the
dropped p to the input dtype before each product as the kernels do (in
float16 a value past 65504 becomes inf, as the reference's astype gives).

Kernel notes (details in the .cu files): the forward and the two backward
kernels run every bf16 and f16 product on the tensor cores (one kernel
template over both 16-bit types: wgmma, tiles streamed
through shared memory by cp.async, the probabilities kept in registers as
the second product's operand). The f32 forward and, at head dims 32 and
64, the f32 backward run on the tensor cores too, in 3xTF32 (mma.sync
m16n8k8, each f32 operand split into two TF32 parts, three products: the
f32 bar, where one TF32 product would miss it; the backward sums each
8-wide step of its products apart, since the tensor cores' accumulation
truncates); the f32 backward at 128 and 256 runs on the CUDA cores. Each
kernel skips tiles the causal mask or the key length rule out and
regenerates the dropout mask in registers. The decode
kernel is bound by the bytes of the live cache: one launch splits each
row's keys over several blocks (flash-decoding), and the last block of a
row to finish combines the row's partial softmax states, in chunk order,
through scratch the wrapper keeps (``_decode_scratch``).
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["HEAD_DIMS", "F32_HEAD_DIMS", "MASK_DTYPES", "head_dims",
           "check_head_dim", "NEG_INF", "dropout_keep", "flash_attention_fwd",
           "flash_attention_fwd_plain", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq_plain",
           "flash_attention_bwd_dkv_plain", "flash_attention_bwd_plain",
           "flash_attention_bwd", "flash_attention_bhsd", "flash_decode",
           "flash_decode_plain", "decode_split"]

# head dims of the bf16/f16 forward and backward kernels and the decode
HEAD_DIMS = (64, 128, 256)
# the f32 forward and backward also take DETR's head_dim 32 (d_model 256,
# 8 heads)
F32_HEAD_DIMS = (32,) + HEAD_DIMS
NEG_INF = -1e30  # the TPU kernel's masked-score sentinel
# the lowest running max of a masked softmax: no finite score lies below it
_LOWEST = torch.finfo(torch.float32).min
# the forward's, the backward's and the dense decode's dtypes on CUDA, and
# the kernels' codes
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# a dense mask's dtypes on CUDA and the kernels' codes (1 a bool
# keep-mask, 2-4 an additive bias); a mask of another dtype is cast to f32
MASK_DTYPES = {torch.bool: 1, torch.float32: 2, torch.bfloat16: 3,
               torch.float16: 4}
_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
_LL = ctypes.c_longlong
# the dense mask: pointer, kind, heads, its four element strides
_MASK_ARGTYPES = [_P, _I, _I] + [_LL] * 4
# q, k, v, lens, o, lse; bh, sq, sk, d, causal; sm_scale; seed; thresh;
# keep_prob; dtype code (0 f32, 1 bf16, 2 f16); the mask; stream
_FWD_ARGTYPES = [_P] * 6 + [_I] * 5 + [_F, _P, _U, _F, _I] + _MASK_ARGTYPES \
    + [_P]
# q, k, v, o, dout, lse, lens, seed, dq, delta; bh, sq, sk, d, causal;
# sm_scale; thresh; keep_prob; dtype code; the mask; stream
_DQ_ARGTYPES = [_P] * 10 + [_I] * 5 + [_F, _U, _F, _I] + _MASK_ARGTYPES \
    + [_P]
# q, k, v, dout, lse, delta, lens, seed, dk, dv; then as above
_DKV_ARGTYPES = _DQ_ARGTYPES
# q, k, v, lens, out, part, counters; b, h, s, d, splits, chunk; the
# strides q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh; dtype code;
# sm_scale; stream
_DECODE_ARGTYPES = ([_P] * 7 + [_I] * 6 + [ctypes.c_longlong] * 8
                    + [_I, _F, _P])
# blocks a decode call aims for: four on each of the H100's 132 SMs (at
# Llama-2-7B's and GPT's generate shapes it beat 1, 132, 264 and 1056 on
# the card, PERF.md section 6)
_DECODE_BLOCKS = 4 * 132
# a decode chunk is a multiple of 64 keys, two of a block's largest rounds
# (4 warps x 8 keys, bf16 at D=64)
_DECODE_UNIT = 64
# device -> (partial states, per-row counters) of the decode kernel
_DECODE_SCRATCH = {}

_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant c,
    in two 16-bit halves so no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 65536) & _M32


def dropout_keep(seed, bh, sq, sk, rate, device):
    """[bh, sq, sk] bool keep mask of the attention dropout: the murmur3
    finalizer of ``_dropout_keep`` in paddle_tpu/ops/pallas/
    flash_attention.py over gid = q_pos * sk + k_pos as uint32 (wrapping),
    xor-ed with seed * 0x9E3779B9 + b * 0x85EBCA6B for the folded
    batch*head index b; kept where the top 24 bits of the hash reach
    int(rate * 2^24). ``seed``: an int32 tensor of one element."""
    i64 = dict(dtype=torch.int64, device=device)
    gid = (torch.arange(sq, **i64)[:, None] * sk
           + torch.arange(sk, **i64)[None, :]) & _M32
    s = seed.to(**i64).reshape(()) & _M32
    mix = (_mul32(s, 0x9E3779B9)
           + _mul32(torch.arange(bh, **i64), 0x85EBCA6B)) & _M32
    x = gid[None] ^ mix[:, None, None]
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x >> 8) >= int(rate * (1 << 24))


def _visible(sq, sk, lens, causal, device, mask=None):
    """[BH or 1, Sq, Sk] bool: which keys each query row may attend (a
    bool ``mask``, [BH, Sq, Sk], among the rules)."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    ok = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        ok = kpos <= qpos + (sk - sq)
    ok = ok[None]
    if lens is not None:
        ok = ok & (kpos[None] < lens.to(device)[:, None, None])
    if mask is not None and mask.dtype == torch.bool:
        ok = ok & mask
    return ok


def _scale(sm_scale, q):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def _folded(mask, q, k):
    """A [B, H, Sq, Sk] mask as [B*H, Sq, Sk] (None stays None)."""
    if mask is None:
        return None
    return mask.reshape(q.shape[0], q.shape[1], k.shape[1])


def _scores(q, k, lens, causal, sm_scale, mask=None):
    """(masked f32 scores [BH, Sq, Sk], visibility mask). A float ``mask``
    ([BH, Sq, Sk]) is added to the scaled scores in f32; a bias of -inf
    leaves its element visible with a score of -inf. Hidden scores are
    -1e30, the TPU kernel's sentinel, or under a mask -inf."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * sm_scale
    if mask is not None and mask.dtype != torch.bool:
        s = s + mask.float()
    ok = _visible(q.shape[1], k.shape[1], lens, causal, q.device, mask)
    hidden = NEG_INF if mask is None else -math.inf
    return torch.where(ok, s, torch.full_like(s, hidden)), ok


def _two_sum(a, b):
    """(hi, lo): hi = a + b in f32 and lo = (a + b) - hi exactly (Knuth's
    two-sum), as the kernels' flash::two_sum."""
    hi = a + b
    bb = hi - a
    return hi, (a - (hi - bb)) + (b - bb)


def _keep(seed, q, k, dropout_p):
    if not dropout_p:
        return None
    return dropout_keep(seed, q.shape[0], q.shape[1], k.shape[1], dropout_p,
                        q.device)


def flash_attention_fwd_plain(q, k, v, lens=None, seed=None, causal=False,
                              sm_scale=None, dropout_p=0.0, mask=None):
    """q [BH, Sq, D], k/v [BH, Sk, D]; lens [BH] int or None; seed an int32
    tensor of one element when dropout_p > 0; mask a dense mask [B, H, Sq,
    Sk] (B * H = BH; the module's notes) or None. Returns (o [BH, Sq, D] in
    q's dtype, lse [BH, Sq] f32, or under a mask [2, BH, Sq]: hi and lo).
    Rows with no visible key give o = 0 and lse = -1e30, as the kernels do
    (the running max starts at -1e30, as theirs); under a dense mask the
    reference's softmax, unfloored, and NaN o and lse on a row with no
    visible key. The softmax denominator is taken over the undropped
    probabilities (the TPU kernel's order); p is rounded to the input dtype
    before its product with V, as the reference rounds it."""
    sm_scale = _scale(sm_scale, q)
    mask = _folded(mask, q, k)
    s, ok = _scores(q, k, lens, causal, sm_scale, mask)
    floor = NEG_INF if mask is None else _LOWEST
    m = s.amax(dim=-1, keepdim=True).clamp_min(floor)
    p = torch.where(ok, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    keep = _keep(seed, q, k, dropout_p)
    if keep is not None:
        p = torch.where(keep, p / (1.0 - dropout_p), torch.zeros_like(p))
    empty = torch.nan if mask is not None else 1.0
    safe_l = torch.where(l == 0, torch.full_like(l, empty), l)
    o = torch.matmul(_rounded(p, q.dtype), v.float()) / safe_l
    if mask is None:
        return o.to(q.dtype), (m + torch.log(safe_l))[..., 0]
    return o.to(q.dtype), torch.stack(_two_sum(m, torch.log(safe_l)))[..., 0]


def _rounded(x, dtype):
    """x rounded to ``dtype`` and back to f32: where the reference (and the
    kernels) round ds and the dropped p before their products."""
    return x.to(dtype).float()


def _recompute_p(q, k, lse, lens, causal, sm_scale, mask):
    """(the backward's p = exp(s - lse), visibility): p a hard 0 where
    masked; under a dense mask p = exp((s - hi) - lo) from lse's pair, and
    a masked element's p is 0, or NaN in a row with no visible key (lse
    NaN), as the reference's softmax gives that row NaN at every key."""
    s, ok = _scores(q, k, lens, causal, sm_scale, mask)
    if mask is None:
        return torch.where(ok, torch.exp(s - lse[..., None]),
                           torch.zeros_like(s)), ok
    hi, lo = lse[0][..., None], lse[1][..., None]
    hidden = (hi - hi).expand_as(s)
    return torch.where(ok, torch.exp((s - hi) - lo), hidden), ok


def _ds(p, dp, delta, ok, mask, dtype):
    """ds = p (dp - delta), rounded to ``dtype``; under a dense mask 0 where
    masked (the reference's where() cuts the gradient there)."""
    ds = p * (dp - delta[..., None])
    if mask is not None:
        ds = torch.where(ok, ds, torch.zeros_like(ds))
    return _rounded(ds, dtype)


def flash_attention_bwd_dq_plain(q, k, v, o, do, lse, lens=None, seed=None,
                                 causal=False, sm_scale=None, dropout_p=0.0,
                                 mask=None):
    """dq by recompute from lse, and delta = rowsum(dO * o) [BH, Sq] f32:
    the dq kernel's two outputs, in plain PyTorch (f32 math, with ds
    rounded to the input dtype before its product, as the reference)."""
    sm_scale = _scale(sm_scale, q)
    mask = _folded(mask, q, k)
    p, ok = _recompute_p(q, k, lse, lens, causal, sm_scale, mask)
    delta = (do.float() * o.float()).sum(-1)
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    keep = _keep(seed, q, k, dropout_p)
    if keep is not None:
        dp = torch.where(keep, dp / (1.0 - dropout_p), torch.zeros_like(dp))
    ds = _ds(p, dp, delta, ok, mask, q.dtype)
    dq = torch.matmul(ds, k.float()) * sm_scale
    return dq.to(q.dtype), delta


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, lens=None,
                                  seed=None, causal=False, sm_scale=None,
                                  dropout_p=0.0, mask=None):
    """dk = dS^T Q * scale and dv = P_drop^T dO by recompute from lse, given
    the dq kernel's delta: the dk/dv kernel's outputs in plain PyTorch."""
    sm_scale = _scale(sm_scale, q)
    mask = _folded(mask, q, k)
    p, ok = _recompute_p(q, k, lse, lens, causal, sm_scale, mask)
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    keep = _keep(seed, q, k, dropout_p)
    p_drop = p
    if keep is not None:
        zero = torch.zeros_like(p)
        p_drop = torch.where(keep, p / (1.0 - dropout_p), zero)
        dp = torch.where(keep, dp / (1.0 - dropout_p), zero)
    ds = _ds(p, dp, delta, ok, mask, q.dtype)
    dk = torch.matmul(ds.transpose(1, 2), q.float()) * sm_scale
    dv = torch.matmul(_rounded(p_drop, q.dtype).transpose(1, 2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, lens=None, seed=None,
                              causal=False, sm_scale=None, dropout_p=0.0,
                              mask=None):
    """The whole backward -> (dq, dk, dv), the kernels' math in plain
    PyTorch: delta = rowsum(dO * o) in f32, p recomputed from lse, the
    dropout mask regenerated from the seed. Rows with no visible key get
    zero gradients; under a dense mask the reference's (module notes)."""
    dq, delta = flash_attention_bwd_dq_plain(q, k, v, o, do, lse, lens, seed,
                                             causal, sm_scale, dropout_p,
                                             mask)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, lens,
                                           seed, causal, sm_scale, dropout_p,
                                           mask)
    return dq, dk, dv


# -- the CUDA side ------------------------------------------------------------

def head_dims(dtype):
    """The head dims the CUDA forward and backward take in ``dtype``."""
    return F32_HEAD_DIMS if dtype == torch.float32 else HEAD_DIMS


def check_head_dim(fn, d, dims):
    """Raise ValueError unless the CUDA kernel of ``fn`` takes head_dim
    ``d`` (one of ``dims``)."""
    if d not in dims:
        note = (" (the bf16 and f16 forward and backward kernels at "
                "head_dim 32 are still to port: ROADMAP.md queue 2)"
                if d in F32_HEAD_DIMS else "")
        raise ValueError(f"{fn}: head_dim {d} not in {dims} for the CUDA "
                         f"kernel{note}")


def check_mask(fn, mask, q, k, lens):
    """Raise on a dense mask the wrappers do not take (on either device):
    not [B, H, Sq, Sk] with B * H the folded rows of q, on another device,
    taking a gradient, or given with ``lens``."""
    if mask is None:
        return
    bh, sq, sk = q.shape[0], q.shape[1], k.shape[1]
    if lens is not None:
        raise ValueError(f"{fn}: a dense mask and kv_lens together: no "
                         "caller passes both; fold the key lengths into the "
                         "mask")
    if (mask.dim() != 4 or mask.shape[0] * mask.shape[1] != bh
            or tuple(mask.shape[2:]) != (sq, sk)):
        raise ValueError(f"{fn}: mask {tuple(mask.shape)} is not [B, H, "
                         f"{sq}, {sk}] with B * H = {bh}")
    if mask.device != q.device:
        raise ValueError(f"{fn}: mask on {mask.device}, q on {q.device}")
    if mask.requires_grad:
        raise ValueError(f"{fn}: the mask takes no gradient; pass it "
                         "detached")


def _mask_args(mask):
    """(pointer, kind, heads, four element strides) of the C entries."""
    if mask is None:
        return (None, 0, 0, 0, 0, 0, 0)
    return (mask.data_ptr(), MASK_DTYPES[mask.dtype], mask.shape[1],
            *mask.stride())


def _check(fn, q, k, v, lens, seed, dropout_p, rows=(), stats=(),
           mask=None):
    """Raise on anything the kernels do not take. ``rows``: (name, tensor)
    pairs shaped like q; ``stats``: (name, tensor) f32 [BH, Sq] pairs
    (lse [2, BH, Sq] under a mask)."""
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(rows):
        if t.device != q.device:
            raise ValueError(f"{fn}: {name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{fn}: {name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{fn}: {name} must be [B*H, S, D], got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be contiguous and 16-byte "
                             "aligned")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{fn}: dtype {q.dtype} not in {_DTYPES}")
    bh, sq, d = q.shape
    check_head_dim(fn, d, head_dims(q.dtype))
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"{fn}: k {tuple(k.shape)} / v {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if sq < 1 or k.shape[1] < 1 or bh < 1 or bh > 65535:
        raise ValueError(f"{fn}: unsupported shape q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    for name, t in rows:
        if t.shape != q.shape:
            raise ValueError(f"{fn}: {name} {tuple(t.shape)} is not shaped "
                             f"like q {tuple(q.shape)}")
    for name, t in stats:
        want = (2, bh, sq) if name == "lse" and mask is not None else (bh, sq)
        if (t.device != q.device or t.dtype != torch.float32
                or t.shape != want or not t.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be a contiguous "
                             f"{list(want)} float32 tensor on {q.device}")
    if lens is not None and (lens.device != q.device
                             or lens.dtype != torch.int32
                             or lens.shape != (bh,)
                             or not lens.is_contiguous()):
        raise ValueError(f"{fn}: lens must be a contiguous [{bh}] int32 "
                         f"tensor on {q.device}")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"{fn}: dropout_p {dropout_p} not in [0, 1)")
    if dropout_p and (seed is None or seed.device != q.device
                      or seed.dtype != torch.int32 or seed.numel() != 1):
        raise ValueError(f"{fn}: dropout needs a one-element int32 seed "
                         f"tensor on {q.device}")
    check_mask(fn, mask, q, k, lens)
    if mask is not None and mask.dtype not in MASK_DTYPES:
        raise TypeError(f"{fn}: mask dtype {mask.dtype} not in "
                        f"{tuple(MASK_DTYPES)}")


def _on_cuda(fn, q):
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")


def _drop_args(seed, dropout_p):
    """(seed pointer, thresh, keep_prob) of the kernels' C entries."""
    if not dropout_p:
        return None, 0, 1.0
    return seed.data_ptr(), int(dropout_p * (1 << 24)), 1.0 - dropout_p


def _launch(fn, name, symbol, argtypes, q, *args, masked=False):
    from .. import _build
    entry = _build.load(name, argtypes, symbol)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = entry(*args, stream)
    if err:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err}")
    fn.launches += 1
    if masked:
        fn.masked_launches += 1


def flash_attention_fwd(q, k, v, lens=None, seed=None, causal=False,
                        sm_scale=None, dropout_p=0.0, mask=None):
    """[B*H, S, D] flash-attention forward -> (o, lse). CPU tensors run
    the plain version; CUDA tensors launch the kernel or raise."""
    sm_scale = _scale(sm_scale, q)
    if q.device.type == "cpu":
        check_mask("flash_attention_fwd", mask, q, k, lens)
        return flash_attention_fwd_plain(q, k, v, lens, seed, causal,
                                         sm_scale, dropout_p, mask)
    _on_cuda("flash_attention_fwd", q)
    _check("flash_attention_fwd", q, k, v, lens, seed, dropout_p, mask=mask)
    bh, sq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq) if mask is None else (2, bh, sq),
                      dtype=torch.float32, device=q.device)
    _launch(flash_attention_fwd, "flash_attention_fwd",
            "flash_attention_fwd", _FWD_ARGTYPES,
            q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if lens is None else lens.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, sq, k.shape[1], d, int(causal),
            float(sm_scale), *_drop_args(seed, dropout_p),
            _DTYPE_CODES[q.dtype], *_mask_args(mask),
            masked=mask is not None)
    return o, lse


def flash_attention_bwd_dq(q, k, v, o, do, lse, lens=None, seed=None,
                           causal=False, sm_scale=None, dropout_p=0.0,
                           mask=None):
    """[B*H, S, D] backward, first kernel -> (dq, delta [BH, Sq] f32). CPU
    tensors run the plain version; CUDA tensors launch the kernel or
    raise."""
    sm_scale = _scale(sm_scale, q)
    if q.device.type == "cpu":
        check_mask("flash_attention_bwd_dq", mask, q, k, lens)
        return flash_attention_bwd_dq_plain(q, k, v, o, do, lse, lens, seed,
                                            causal, sm_scale, dropout_p,
                                            mask)
    _on_cuda("flash_attention_bwd_dq", q)
    _check("flash_attention_bwd_dq", q, k, v, lens, seed, dropout_p,
           rows=(("o", o), ("do", do)), stats=(("lse", lse),), mask=mask)
    bh, sq, d = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty(bh, sq, dtype=torch.float32, device=q.device)
    seed_ptr, thresh, keep_prob = _drop_args(seed, dropout_p)
    _launch(flash_attention_bwd_dq, "flash_attention_bwd",
            "flash_attention_bwd_dq", _DQ_ARGTYPES, q,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(),
            None if lens is None else lens.data_ptr(), seed_ptr,
            dq.data_ptr(), delta.data_ptr(), bh, sq, k.shape[1], d,
            int(causal), float(sm_scale), thresh, keep_prob,
            _DTYPE_CODES[q.dtype], *_mask_args(mask),
            masked=mask is not None)
    return dq, delta


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, lens=None, seed=None,
                            causal=False, sm_scale=None, dropout_p=0.0,
                            mask=None):
    """[B*H, S, D] backward, second kernel -> (dk, dv), given the first
    kernel's delta. CPU tensors run the plain version; CUDA tensors launch
    the kernel or raise."""
    sm_scale = _scale(sm_scale, q)
    if q.device.type == "cpu":
        check_mask("flash_attention_bwd_dkv", mask, q, k, lens)
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, lens,
                                             seed, causal, sm_scale,
                                             dropout_p, mask)
    _on_cuda("flash_attention_bwd_dkv", q)
    _check("flash_attention_bwd_dkv", q, k, v, lens, seed, dropout_p,
           rows=(("do", do),), stats=(("lse", lse), ("delta", delta)),
           mask=mask)
    bh, sq, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    seed_ptr, thresh, keep_prob = _drop_args(seed, dropout_p)
    _launch(flash_attention_bwd_dkv, "flash_attention_bwd",
            "flash_attention_bwd_dkv", _DKV_ARGTYPES, q,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if lens is None else lens.data_ptr(), seed_ptr,
            dk.data_ptr(), dv.data_ptr(), bh, sq, k.shape[1], d,
            int(causal), float(sm_scale), thresh, keep_prob,
            _DTYPE_CODES[q.dtype], *_mask_args(mask),
            masked=mask is not None)
    return dk, dv


# ``launches`` counts every launch of a wrapper; ``masked_launches`` those
# with a dense mask among them
for _w in (flash_attention_fwd, flash_attention_bwd_dq,
           flash_attention_bwd_dkv):
    _w.launches = 0
    _w.masked_launches = 0
del _w


def flash_attention_bwd(q, k, v, o, lse, do, lens=None, seed=None,
                        causal=False, sm_scale=None, dropout_p=0.0,
                        mask=None):
    """The backward -> (dq, dk, dv): the dq wrapper, then the dk/dv wrapper
    on its delta — the kernels on CUDA, their plain twins on the CPU."""
    dq, delta = flash_attention_bwd_dq(q, k, v, o, do, lse, lens, seed,
                                       causal, sm_scale, dropout_p, mask)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, lens, seed,
                                     causal, sm_scale, dropout_p, mask)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the reference's ``custom_vjp`` (``_flash_bhsd``):
    the forward keeps (q, k, v, o, lse, lens, seed, mask), the backward
    recomputes the probabilities from lse. The mask takes no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, lens, seed, causal, sm_scale, dropout_p,
                mask):
        o, lse = flash_attention_fwd(q, k, v, lens, seed, causal, sm_scale,
                                     dropout_p, mask)
        ctx.save_for_backward(q, k, v, o, lse, lens, seed, mask)
        ctx.cfg = (causal, sm_scale, dropout_p)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, lens, seed, mask = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         lens, seed, *ctx.cfg, mask)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_bhsd(q, k, v, lens=None, seed=None, causal=False,
                         sm_scale=None, dropout_p=0.0, mask=None):
    """Differentiable [B*H, S, D] flash attention -> o. ``mask``: a dense
    mask [B, H, Sq, Sk] (the module's notes), which takes no gradient;
    checked here, before any kernel or twin runs, on every device."""
    check_mask("flash_attention", mask, q, k, lens)
    return _FlashAttention.apply(q, k, v, lens, seed, causal,
                                 _scale(sm_scale, q), float(dropout_p), mask)


# -- dense single-query decode ------------------------------------------------

def flash_decode_plain(q, k_cache, v_cache, kv_lens, sm_scale=None):
    """q [B, 1, H, D]; k_cache/v_cache [B, S, H, D]; kv_lens [B] int — keys
    at positions >= kv_lens[b] are masked. Returns [B, 1, H, D] in q's
    dtype: f32 scores and softmax, p rounded to the cache dtype before its
    product with V, as the TPU kernel computes it. A row with kv_lens 0
    gives 0."""
    sm_scale = _scale(sm_scale, q)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float()) * sm_scale
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    ok = (kpos[None, :] < kv_lens.to(q.device)[:, None])[:, None, None, :]
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bhqk,bkhd->bhqd", _rounded(p, v_cache.dtype),
                     v_cache.float()) / safe_l
    return o.transpose(1, 2).to(q.dtype)


def decode_split(b, h, s):
    """(splits, chunk) of a decode call: the keys of each (b, h) row are cut
    into ``splits`` chunks of ``chunk`` keys, one block each, so that the
    call puts about ``_DECODE_BLOCKS`` blocks on the card; every key lies
    in exactly one chunk. ``chunk`` is a multiple of ``_DECODE_UNIT``."""
    want = max(1, -(-_DECODE_BLOCKS // (b * h)))
    chunk = -(-max(1, -(-s // want)) // _DECODE_UNIT) * _DECODE_UNIT
    return -(-s // chunk), chunk


def _decode_scratch(device, rows, splits, d):
    """(part, counters) of a decode call: f32 room for ``rows * splits``
    partial states (acc, then m and l) and one int32 ticket counter a row.
    Made once per device and size, grown to the largest call so far; the
    counters start at zero and the kernel leaves them so."""
    part, counters = _DECODE_SCRATCH.get(device, (None, None))
    if part is None or part.numel() < rows * splits * (d + 2):
        part = torch.empty(rows * splits * (d + 2), dtype=torch.float32,
                           device=device)
    if counters is None or counters.numel() < rows:
        counters = torch.zeros(rows, dtype=torch.int32, device=device)
    _DECODE_SCRATCH[device] = (part, counters)
    return part, counters


def _check_decode(q, k, v, lens):
    """Raise on anything the decode kernel does not take."""
    fn = "flash_decode"
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"{fn}: q must be [B, 1, H, D], got "
                         f"{tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{fn}: dtype {q.dtype} not in {_DTYPES}")
    b, _, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{fn}: head_dim {d} not in {HEAD_DIMS}")
    for name, t in (("k_cache", k), ("v_cache", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{fn}: {name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4 or t.shape[0] != b or t.shape[3] != d:
            raise ValueError(f"{fn}: {name} {tuple(t.shape)} does not match"
                             f" q {tuple(q.shape)}")
        if t.shape[2] != h:
            raise ValueError(f"{fn}: {name} has {t.shape[2]} heads, q has "
                             f"{h}")
    if k.shape != v.shape or k.shape[1] < 1:
        raise ValueError(f"{fn}: k_cache {tuple(k.shape)} / v_cache "
                         f"{tuple(v.shape)}")
    for name, t in (("q", q), ("k_cache", k), ("v_cache", v)):
        if t.device != q.device:
            raise ValueError(f"{fn}: {name} on {t.device}, q on {q.device}")
        esz = t.element_size()
        if (t.stride(3) != 1 or t.data_ptr() % 16
                or any(t.stride(i) * esz % 16 for i in (0, 1, 2))):
            raise ValueError(f"{fn}: {name} needs a contiguous last dim, "
                             "16-byte strides and a 16-byte aligned start")
    if (lens.device != q.device or lens.dtype != torch.int32
            or lens.shape != (b,) or not lens.is_contiguous()):
        raise ValueError(f"{fn}: kv_lens must be a contiguous [{b}] int32 "
                         f"tensor on {q.device}")
    if b > 65535 or h > 65535:
        raise ValueError(f"{fn}: too many rows for the grid: B={b}, H={h}")


def flash_decode(q, k_cache, v_cache, kv_lens, sm_scale=None):
    """Single-query decode attention over a dense padded cache -> [B, 1, H,
    D] in q's dtype. CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise. q and the cache share one dtype (f32, bf16
    or f16) and one head count; the cache is read in place, never copied;
    the wrapper never syncs with the device. One launch a call; its scratch
    (``_decode_scratch``) serves one call at a time, on one stream."""
    sm_scale = _scale(sm_scale, q)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, kv_lens, sm_scale)
    _on_cuda("flash_decode", q)
    _check_decode(q, k_cache, v_cache, kv_lens)
    b, _, h, d = q.shape
    s = k_cache.shape[1]
    splits, chunk = decode_split(b, h, s)
    out = torch.empty(b, 1, h, d, dtype=q.dtype, device=q.device)
    part, counters = _decode_scratch(q.device, b * h, splits, d)
    _launch(flash_decode, "flash_decode", None, _DECODE_ARGTYPES, q,
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            kv_lens.data_ptr(), out.data_ptr(), part.data_ptr(),
            counters.data_ptr(), b, h, s, d, splits, chunk, q.stride(0),
            q.stride(2), *k_cache.stride()[:3], *v_cache.stride()[:3],
            _DTYPE_CODES[q.dtype], float(sm_scale))
    return out


flash_decode.launches = 0
