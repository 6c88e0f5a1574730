"""The paged decode's split over blocks, on the CPU.

The kernel (csrc/paged_flash_decode.cu) cuts each slot's page table row
into ``splits`` chunks of ``ppc`` whole pages, one block per chunk; a
block runs the chunk's keys below min(lens, mp * ps), and the last block
of a slot combines the chunks' partial states from scratch the wrapper
keeps. Here: the split covers every live page exactly once, in whole
pages, across shapes; the scratch is sized for every partial state and
counter; the CUDA branch's checks raise before any build (the meta device
stands in for the card); and the plain twin, what the card holds the
kernel to, still matches the Pallas kernel in interpret mode at the
lengths that cut the split's chunks (on a chunk boundary, either side of
it, one full slot among empty ones, one slot).
"""
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.nlp import paged_cache as jpc
from paddle_tpu.ops.pallas.flash_decode import \
    paged_flash_decode as jax_paged_flash_decode
from paddle_tpu_torch.ops import _build
from torch_threads import one_torch_thread  # noqa: F401

kpd = importlib.import_module("paddle_tpu_torch.ops.kernels.flash_decode")


def _block_keys(length, splits, ppc, ps, mp):
    """The keys each block of one (slot, kv head) runs, as the kernel
    picks them: chunk c covers keys [c * ppc * ps, (c + 1) * ppc * ps)
    below min(length, mp * ps); a chunk starting at or past that runs
    nothing."""
    live = min(max(length, 0), mp * ps)
    chunk = ppc * ps
    return [range(c * chunk, min(live, (c + 1) * chunk))
            for c in range(splits) if c * chunk < live]


@pytest.mark.parametrize("b,hkv,g", [(8, 16, 1), (32, 16, 1), (1, 16, 1),
                                     (8, 4, 4), (2, 2, 6), (1, 1, 1)])
@pytest.mark.parametrize("mp,ps", [(64, 16), (1, 16), (40, 7), (256, 1),
                                   (8, 128), (20000, 16)])
def test_split_covers_every_live_page_once(b, hkv, g, mp, ps):
    splits, ppc = kpd.paged_decode_split(b, hkv, g, mp, ps)
    assert 1 <= ppc <= min(mp, kpd._PAGED_MAX_PAGES)
    assert splits * ppc >= mp > (splits - 1) * ppc   # no empty chunk
    # a chunk holds whole pages, at least a block's step of keys where the
    # table allows it
    assert ppc * ps >= min(kpd._PAGED_MIN_KEYS, mp * ps)
    for length in {0, 1, ps - 1, ps, ppc * ps, ppc * ps + 1, 2 * ppc * ps,
                   mp * ps - 1, mp * ps, mp * ps + 5}:
        keys = [k for r in _block_keys(length, splits, ppc, ps, mp)
                for k in r]
        assert keys == list(range(min(max(length, 0), mp * ps)))
        # the pages the blocks read are the slot's live pages, each once
        pages = sorted({k // ps for k in keys})
        assert pages == list(range(-(-min(length, mp * ps) // ps)))


def test_split_aims_at_the_block_target():
    """About four blocks an SM at the serving shape, from shapes alone,
    and never more than that: a second wave costs more than the split
    saves."""
    splits, ppc = kpd.paged_decode_split(8, 16, 1, 64, 16)
    assert (splits, ppc) == (4, 16)
    assert 8 * 16 * splits <= kpd._PAGED_BLOCKS
    # 512 slots and kv heads: one chunk a slot
    assert kpd.paged_decode_split(32, 16, 1, 64, 16) == (1, 64)
    # one slot: chunks of the minimum size spread it over many blocks
    assert kpd.paged_decode_split(1, 16, 1, 64, 16) == (16, 4)
    # a large batch: one chunk a slot
    assert kpd.paged_decode_split(64, 16, 1, 64, 16) == (1, 64)


def test_scratch_sizes():
    dev = torch.device("cpu")
    kpd._PAGED_SCRATCH.pop(dev, None)
    try:
        part, counters = kpd._paged_scratch(dev, 8, 16, 1, 5, 64)
        assert part.dtype == torch.float32 and part.numel() == 8 * 16 * 5 * 66
        assert counters.dtype == torch.int32 and counters.numel() == 8 * 16
        assert not counters.any()
        # kept and reused by a call that fits: six query heads are two
        # groups of up to four, each with a counter
        assert 3 * 2 * 6 * 8 * 130 <= part.numel() and 3 * 2 * 2 <= 128
        p2, c2 = kpd._paged_scratch(dev, 3, 2, 6, 8, 128)
        assert p2 is part and c2 is counters
        # grown by one that does not
        p3, c3 = kpd._paged_scratch(dev, 32, 16, 1, 2, 64)
        assert p3.numel() == 32 * 16 * 2 * 66
        assert c3.numel() == 32 * 16 and not c3.any()
        assert kpd._PAGED_SCRATCH[dev] == (p3, c3)
    finally:
        kpd._PAGED_SCRATCH.pop(dev, None)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_cuda_branch_checks_raise(monkeypatch):
    """The kernel branch raises on an unsupported D, q dtype (float64) or
    pool dtype (float64, or k and v pools of two dtypes), mismatched
    pools, missing or stray int8 scales, a bad page table or lens, and a
    grid too large; the checks run before any build
    (the meta device stands in for CUDA past the device test)."""
    def no_build(name, *args):
        raise AssertionError(f"reached the kernel build ({name})")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(kpd, "_on_cuda", lambda q: None)
    q = _meta(2, 4, 1, 64)
    pool = _meta(4, 9, 16, 64)
    pt = _meta(2, 4, dtype=torch.int32)
    lens = _meta(2, dtype=torch.int32)
    i8 = _meta(4, 9, 16, 64, dtype=torch.int8)
    sc = _meta(4, 9, 16, 1)
    bad = [
        ((_meta(2, 4, 1, 96), _meta(4, 9, 16, 96), _meta(4, 9, 16, 96), pt,
          lens), {}, ValueError, "head_dim"),
        ((_meta(2, 4, 1, 64, dtype=torch.float64), pool, pool, pt, lens), {},
         TypeError, "q dtype"),
        ((q, _meta(4, 9, 16, 64, dtype=torch.float64),
          _meta(4, 9, 16, 64, dtype=torch.float64), pt, lens), {}, TypeError,
         "pools"),
        ((q, pool, _meta(4, 9, 16, 64, dtype=torch.float16), pt, lens), {},
         TypeError, "pools"),
        ((q, pool, _meta(4, 9, 8, 64), pt, lens), {}, ValueError,
         "do not match"),
        ((q, _meta(2, 9, 16, 64), _meta(2, 9, 16, 64), pt, lens), {},
         ValueError, "do not match"),
        ((q, i8, i8, pt, lens), {}, ValueError, "k_scale"),
        ((q, pool, pool, pt, lens), dict(k_scale=sc, v_scale=sc), ValueError,
         "k_scale"),
        ((q, i8, i8, pt, lens), dict(k_scale=_meta(4, 9, 16, 2), v_scale=sc),
         ValueError, "k_scale"),
        ((q, pool, pool, _meta(2, 4, dtype=torch.int64), lens), {},
         ValueError, "page_table"),
        ((q, pool, pool, _meta(3, 4, dtype=torch.int32), lens), {},
         ValueError, "page_table"),
        ((q, pool, pool, pt, _meta(2, dtype=torch.int64)), {}, ValueError,
         "lens"),
        ((q, pool, pool, pt, _meta(3, dtype=torch.int32)), {}, ValueError,
         "lens"),
        ((_meta(70000, 4, 1, 64), pool, pool, _meta(70000, 4,
                                                    dtype=torch.int32),
          _meta(70000, dtype=torch.int32)), {}, ValueError, "grid"),
    ]
    for args, kw, exc, match in bad:
        with pytest.raises(exc, match=match):
            kpd.paged_flash_decode(*args, **kw)


def test_off_cpu_without_kernel_raises(monkeypatch):
    """A tensor on neither the CPU nor CUDA never reaches the twin."""
    def no_build(name, *args):
        raise AssertionError(f"reached the kernel build ({name})")
    monkeypatch.setattr(_build, "load", no_build)
    pool = _meta(4, 9, 16, 64)
    with pytest.raises(ValueError, match="unsupported device"):
        kpd.paged_flash_decode(_meta(2, 4, 1, 64), pool, pool,
                               _meta(2, 4, dtype=torch.int32),
                               _meta(2, dtype=torch.int32))


_TOL = {"float32": 1e-5, "bfloat16": 1e-2, "int8": 1e-5}

# the split at (b=4, hkv=2, g, mp=12, ps=16) is 3 chunks of 4 pages (64
# keys): lengths on a chunk boundary and either side of it, the full
# table, a full slot among empty ones, one slot
EDGE_LENS = [
    (4, [64, 128, 63, 65]),
    (4, [0, 0, 0, 192]),
    (4, [191, 1, 129, 0]),
    (1, [150]),
]


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b,lens", EDGE_LENS)
def test_twin_matches_pallas_at_split_edges(b, lens, dtype, g):
    hkv, d, ps, mp = 2, 64, 16, 12
    assert kpd.paged_decode_split(4, hkv, g, mp, ps)[1] * ps == 64
    rng = np.random.default_rng(sum(lens) + g)
    p = b * mp + 1
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    kp = rng.standard_normal((hkv, p, ps, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, p, ps, d)).astype(np.float32)
    pt = (1 + rng.permutation(b * mp)).reshape(b, mp).astype(np.int32)
    for i, n in enumerate(lens):     # trash past each slot's pages
        pt[i, -(-n // ps):] = jpc.TRASH_PAGE
    ks = vs = None
    if dtype == "int8":
        kq, ks = jpc.quantize_rows(jnp.asarray(kp))
        vq, vs = jpc.quantize_rows(jnp.asarray(vp))
        kp, vp, ks, vs = (np.asarray(x) for x in (kq, vq, ks, vs))
    elif dtype == "bfloat16":
        kp = np.asarray(jnp.asarray(kp, jnp.bfloat16))
        vp = np.asarray(jnp.asarray(vp, jnp.bfloat16))
    lens_np = np.asarray(lens, np.int32)
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    want = np.asarray(jax_paged_flash_decode(
        j(q), j(kp), j(vp), j(pt), j(lens_np), k_scale=j(ks), v_scale=j(vs),
        interpret=True))

    def t(x):
        if x is None:
            return None
        if x.dtype == jnp.bfloat16:
            return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(x))
    got = kpd.paged_flash_decode(t(q), t(kp), t(vp), t(pt), t(lens_np),
                                 k_scale=t(ks), v_scale=t(vs)).numpy()
    np.testing.assert_allclose(got, want, atol=_TOL[dtype], rtol=0)
    for i, n in enumerate(lens):
        if n == 0:
            assert not got[i].any()
