"""Flash-attention forward of the PyTorch port vs the JAX package.

The port's plain twin of the CUDA kernel (what the CPU runs) is held
against the Pallas kernel run in interpret mode, on the same numpy
inputs: causal and not, sq != sk (bottom-right causal), kv_lens including
0, head_dim 64 and 128, f32 (1e-5) and bf16 (1e-2). The wrappers' CPU
dispatch must run the plain version and never touch the kernel build.
Dropout and the backward are held in test_torch_flash_attention_bwd.py.
"""
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu_torch.ops import _build, attention as port_attn
from torch_threads import one_torch_thread  # noqa: F401

# both packages export a function named like the kernel module
jax_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
port_fa = importlib.import_module(
    "paddle_tpu_torch.ops.kernels.flash_attention")

_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _inputs(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, h, d)).astype(np.float32))


def _jax(q, k, v, dtype, **kw):
    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    out = jax_fa.flash_attention(*args, interpret=True, **kw)
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, dtype, **kw):
    dt = getattr(torch, dtype)
    args = [torch.from_numpy(x).to(dt) for x in (q, k, v)]
    return port_attn.flash_attention(*args, **kw).float().numpy()


CASES = [
    # b, sq, sk, h, d, causal, kv_lens
    (2, 64, 64, 2, 64, False, None),
    (2, 64, 64, 2, 64, True, None),
    (1, 32, 96, 2, 64, True, None),        # sq < sk: bottom-right causal
    (1, 96, 32, 1, 64, True, None),        # sq > sk: leading rows see nothing
    (2, 64, 64, 2, 64, True, [40, 64]),    # prefill padding as key lengths
    (2, 48, 48, 1, 64, False, [0, 17]),    # a batch with no visible key
    (1, 64, 64, 2, 128, True, [33]),
    (1, 40, 72, 1, 128, False, [72]),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,d,causal,kv_lens", CASES)
def test_plain_matches_pallas_interpret(dtype, b, sq, sk, h, d, causal,
                                        kv_lens):
    q, k, v = _inputs(b, sq, sk, h, d, seed=sq * 7 + sk + d)
    kw = dict(causal=causal, kv_lens=kv_lens)
    want = _jax(q, k, v, getattr(jnp, dtype), **kw)
    got = _port(q, k, v, dtype, **kw)
    np.testing.assert_allclose(got, want, atol=_TOL[dtype], rtol=0)
    if kv_lens is not None and 0 in kv_lens:
        assert not got[kv_lens.index(0)].any(), "no visible key -> 0"


@pytest.mark.parametrize("causal", [False, True])
def test_row_lse_matches_pallas(causal):
    """The plain twin's row logsumexp (the kernel's second output, kept
    for the backward slice) equals the Pallas kernel's, lens 0 included."""
    q, k, v = (x[0].transpose(1, 0, 2) for x in _inputs(1, 64, 64, 3, 64, 5))
    lens = np.array([64, 23, 0], np.int32)
    _, lse_j = jax_fa._fwd_call(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(lens), None,
                                causal, 0.125, 0.0, 64, 64, True)
    _, lse_p = port_fa.flash_attention_fwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v)),
        lens=torch.from_numpy(lens), causal=causal, sm_scale=0.125)
    np.testing.assert_allclose(lse_p.numpy(), np.asarray(lse_j)[..., 0],
                               atol=1e-5, rtol=1e-6)


def test_plain_matches_dense_reference():
    """Plain flash twin == the port's dense reference_attention."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 24, 40, 2, 64, 9))
    lens = [40, 11]
    got = port_attn.flash_attention(q, k, v, causal=True, kv_lens=lens)
    want = port_attn.reference_attention(q, k, v, causal=True,
                                         kv_lens=lens)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_cpu_dispatch_never_builds(monkeypatch):
    def no_build(name, *args):
        raise AssertionError(f"CPU call reached the kernel build ({name})")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build_all", no_build)
    before = port_fa.flash_attention_fwd.launches
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 16, 16, 1, 64, 3))
    port_attn.flash_attention(q, k, v, causal=True)
    # the plain path takes any head_dim on the CPU
    port_attn.flash_attention(q[..., :16], k[..., :16], v[..., :16])
    assert port_fa.flash_attention_fwd.launches == before


def test_dropout_raises():
    """Dropout is ported (tests/test_torch_flash_attention_bwd.py holds it
    against the Pallas hash); a rate outside [0, 1) raises."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 8, 8, 1, 64, 4))
    for rate in (1.0, -0.1):
        with pytest.raises(ValueError, match="dropout"):
            port_attn.flash_attention(q, k, v, dropout_p=rate)
