"""The transformer layers of the PyTorch port vs the JAX package.

The reference's weights cross into the port through numpy
(``nlp.convert.load_numpy_state``, strictly, key for key), with every bias
and LayerNorm parameter drawn at random from a numpy seed (at their
initial zeros and ones a wrong bias or affine path would not show), and
both sides get the same numpy inputs. Checked on the CPU, f32, within
1e-5 of max(1, |reference|):

- ``MultiHeadAttention``: self- and cross-attention (``kdim``/``vdim``
  too), a dense additive mask, the incremental ``Cache`` over two steps
  and the ``StaticCache`` of a memory, at head_dim 32 (DETR's) and 64;
- ``TransformerEncoderLayer``/``TransformerDecoderLayer`` with
  ``normalize_before`` both ways (the decoder with a causal ``tgt_mask``
  and with its caches), the stacks with their final norms, and
  ``Transformer``, ``generate_square_subsequent_mask`` included;
- the f32 flash forward's plain twin (``flash_attention_fwd_plain``) at
  head_dim 32 against the JAX package's ``reference_attention``, which is
  what the JAX package runs at that head dim (its Pallas gate takes 64,
  128 and 256), causal or not, with key lengths.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jax_nn
from paddle_tpu.ops.attention import reference_attention
from paddle_tpu_torch import nn as port_nn
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.ops.kernels import flash_attention as kfa
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


def _np(t):
    return np.asarray(jnp.asarray(t._value if hasattr(t, "_value") else t,
                                  jnp.float32))


def _close(got, want, what=""):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    want = _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scaled = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert scaled.max() <= TOL, (what, scaled.max())


def _carry(jm, pm, seed=0):
    """The reference's state with every 1-D parameter (biases, LayerNorm
    weights) drawn from ``seed``, set into the reference and loaded into
    the port; both put in eval mode."""
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in jm.state_dict().items():
        a = np.asarray(v._value, np.float32)
        if a.ndim == 1:
            base = 1.0 if k.split(".")[-2].startswith("norm") and \
                k.endswith("weight") else 0.0
            a = base + 0.1 * rng.standard_normal(a.shape)
        state[k] = a.astype(np.float32)
    jm.set_state_dict(state)
    load_numpy_state(pm, state)
    jm.eval()
    pm.eval()
    return jm, pm


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(x):
    return paddle.to_tensor(x), torch.from_numpy(x)


# -- MultiHeadAttention -------------------------------------------------------

HEADS = {"hd32": (64, 2), "hd64": (128, 2)}


def _mha(embed, heads, **kw):
    paddle.seed(0)
    return _carry(jax_nn.MultiHeadAttention(embed, heads, **kw),
                  port_nn.MultiHeadAttention(embed, heads, device="cpu",
                                             **kw))


@pytest.mark.parametrize("hd", sorted(HEADS))
def test_self_attention_matches(hd):
    e, h = HEADS[hd]
    jm, pm = _mha(e, h)
    assert pm.head_dim == int(hd[2:])
    jx, px = _both(_x((2, 7, e)))
    _close(pm(px), jm(jx))


@pytest.mark.parametrize("hd", sorted(HEADS))
def test_cross_attention_matches(hd):
    e, h = HEADS[hd]
    jm, pm = _mha(e, h, kdim=48, vdim=40)
    jq, pq = _both(_x((2, 5, e)))
    jk, pk = _both(_x((2, 9, 48), seed=2))
    jv, pv = _both(_x((2, 9, 40), seed=3))
    _close(pm(pq, pk, pv), jm(jq, jk, jv))


@pytest.mark.parametrize("hd", sorted(HEADS))
def test_additive_mask_matches(hd):
    e, h = HEADS[hd]
    jm, pm = _mha(e, h)
    jx, px = _both(_x((2, 6, e)))
    jmask = jax_nn.Transformer.generate_square_subsequent_mask(6)
    pmask = port_nn.Transformer.generate_square_subsequent_mask(6)
    assert np.array_equal(pmask.numpy(), _np(jmask))
    _close(pm(px, attn_mask=pmask), jm(jx, attn_mask=jmask))


@pytest.mark.parametrize("hd", sorted(HEADS))
def test_incremental_cache_matches(hd):
    e, h = HEADS[hd]
    jm, pm = _mha(e, h)
    jcache = jm.gen_cache(paddle.to_tensor(_x((2, 3, e))))
    pcache = pm.gen_cache(torch.from_numpy(_x((2, 3, e))))
    assert isinstance(pcache, port_nn.MultiHeadAttention.Cache)
    assert tuple(pcache.k.shape) == tuple(jcache.k.shape) == (2, 0, h,
                                                              e // h)
    for step in range(2):
        jx, px = _both(_x((2, 1, e), seed=10 + step))
        jo, jcache = jm(jx, jx, jx, None, jcache)
        po, pcache = pm(px, px, px, None, pcache)
        _close(po, jo, what=f"step {step}")
        _close(pcache.k, jcache.k, what=f"cache k {step}")
        _close(pcache.v, jcache.v, what=f"cache v {step}")
    assert pcache.k.shape[1] == 2


@pytest.mark.parametrize("hd", sorted(HEADS))
def test_static_cache_matches(hd):
    e, h = HEADS[hd]
    jm, pm = _mha(e, h)
    jmem, pmem = _both(_x((2, 9, e), seed=4))
    jst = jm.gen_cache(jmem, jmem, jax_nn.MultiHeadAttention.StaticCache)
    pst = pm.gen_cache(pmem, pmem, port_nn.MultiHeadAttention.StaticCache)
    _close(pst.k, jst.k)
    _close(pst.v, jst.v)
    jq, pq = _both(_x((2, 4, e)))
    out = pm(pq, pmem, pmem, None, pst)
    assert torch.is_tensor(out)  # a static cache returns no new cache
    _close(out, jm(jq, jmem, jmem, None, jst))


# -- layers, stacks, Transformer -----------------------------------------------

@pytest.mark.parametrize("pre", [False, True], ids=["post_ln", "pre_ln"])
def test_encoder_layer_matches(pre):
    paddle.seed(0)
    args = (64, 2, 96)
    jm, pm = _carry(
        jax_nn.TransformerEncoderLayer(*args, normalize_before=pre),
        port_nn.TransformerEncoderLayer(*args, normalize_before=pre,
                                        device="cpu"))
    jx, px = _both(_x((2, 7, 64)))
    _close(pm(px), jm(jx))


@pytest.mark.parametrize("pre", [False, True], ids=["post_ln", "pre_ln"])
def test_decoder_layer_matches(pre):
    paddle.seed(0)
    args = (64, 2, 96)
    jm, pm = _carry(
        jax_nn.TransformerDecoderLayer(*args, normalize_before=pre),
        port_nn.TransformerDecoderLayer(*args, normalize_before=pre,
                                        device="cpu"))
    jt, pt = _both(_x((2, 5, 64)))
    jmem, pmem = _both(_x((2, 9, 64), seed=2))
    _close(pm(pt, pmem), jm(jt, jmem), what="no mask")
    jmask = jax_nn.Transformer.generate_square_subsequent_mask(5)
    pmask = port_nn.Transformer.generate_square_subsequent_mask(5)
    _close(pm(pt, pmem, pmask), jm(jt, jmem, jmask), what="causal tgt_mask")


@pytest.mark.parametrize("pre", [False, True], ids=["post_ln", "pre_ln"])
def test_decoder_with_caches_matches(pre):
    """Two incremental steps of a 2-layer decoder through its gen_cache
    (each layer: an incremental self-attention cache and the static cache
    of the memory)."""
    paddle.seed(0)
    jl = jax_nn.TransformerDecoderLayer(64, 2, 96, normalize_before=pre)
    pl = port_nn.TransformerDecoderLayer(64, 2, 96, normalize_before=pre,
                                         device="cpu")
    jnorm = jax_nn.LayerNorm(64) if pre else None
    pnorm = port_nn.LayerNorm(64, device="cpu") if pre else None
    jm, pm = _carry(jax_nn.TransformerDecoder(jl, 2, jnorm),
                    port_nn.TransformerDecoder(pl, 2, pnorm))
    jmem, pmem = _both(_x((2, 9, 64), seed=2))
    jc, pc = jm.gen_cache(jmem), pm.gen_cache(pmem)
    for step in range(2):
        jt, pt = _both(_x((2, 1, 64), seed=20 + step))
        jo, jc = jm(jt, jmem, None, None, jc)
        po, pc = pm(pt, pmem, None, None, pc)
        _close(po, jo, what=f"step {step}")
    assert pc[0][0].k.shape[1] == 2


@pytest.mark.parametrize("pre", [False, True], ids=["post_ln", "pre_ln"])
def test_encoder_stack_matches(pre):
    paddle.seed(0)
    jl = jax_nn.TransformerEncoderLayer(64, 2, 96, normalize_before=pre)
    pl = port_nn.TransformerEncoderLayer(64, 2, 96, normalize_before=pre,
                                         device="cpu")
    jnorm = jax_nn.LayerNorm(64) if pre else None
    pnorm = port_nn.LayerNorm(64, device="cpu") if pre else None
    jm, pm = _carry(jax_nn.TransformerEncoder(jl, 3, jnorm),
                    port_nn.TransformerEncoder(pl, 3, pnorm))
    assert set(pm.state_dict()) == set(jm.state_dict())
    jx, px = _both(_x((2, 7, 64)))
    _close(pm(px), jm(jx))


@pytest.mark.parametrize("pre", [False, True], ids=["post_ln", "pre_ln"])
@pytest.mark.parametrize("hd", sorted(HEADS))
def test_transformer_matches(hd, pre):
    e, h = HEADS[hd]
    paddle.seed(0)
    args = (e, h, 2, 2, 96)
    jm, pm = _carry(
        jax_nn.Transformer(*args, normalize_before=pre),
        port_nn.Transformer(*args, normalize_before=pre, device="cpu"))
    js, ps = _both(_x((2, 11, e)))
    jt, pt = _both(_x((2, 4, e), seed=2))
    _close(pm(ps, pt), jm(js, jt), what="no masks")
    jmask = jax_nn.Transformer.generate_square_subsequent_mask(4)
    pmask = port_nn.Transformer.generate_square_subsequent_mask(4)
    _close(pm(ps, pt, tgt_mask=pmask), jm(js, jt, tgt_mask=jmask),
           what="tgt_mask")


# -- the f32 forward's twin at head_dim 32 ---------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lens", [None, (33, 0, 70)],
                         ids=["no_lens", "lens"])
def test_plain_forward_at_head_dim_32_matches_reference_attention(lens,
                                                                  causal):
    b, h, sq, sk, d = 3, 2, 41, 70, 32
    q, k, v = (_x((b, s, h, d), seed=i)
               for i, s in enumerate((sq, sk, sk)))
    want = reference_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal,
                               kv_lens=None if lens is None
                               else jnp.asarray(lens))

    def fold(x):
        return torch.from_numpy(x).transpose(1, 2).reshape(b * h, -1, d)
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    o, _ = kfa.flash_attention_fwd_plain(
        fold(q), fold(k), fold(v),
        None if tl is None else tl.repeat_interleave(h), causal=causal)
    assert d in kfa.F32_HEAD_DIMS and d not in kfa.HEAD_DIMS
    _close(o.reshape(b, h, sq, d).transpose(1, 2), want)
