"""Dense attention masks through the port's flash path vs the JAX
package's dense path.

The reference sends every dense mask to its jnp path
(``paddle_tpu/nn/functional.py``'s ``scaled_dot_product_attention``:
logits scaled, causal and a bool mask by ``where(-inf)``, a float mask
added, softmax in f32). The port sends it to its flash kernels, whose
plain twins run here. Forward and the q, k, v gradients agree at 1e-5 in
f32 and at bf16's bar of the port's flash tests (atol 1e-2, rtol 1e-2:
the reference rounds its bf16 logits before the mask and takes its
backward in bf16; the port keeps f32 scores) for padding masks
given as the tokenizer's ``[B, Sk]`` and ``[B, Sq, Sk]`` 0/1 masks
(through ``normalize_attention_mask``) and as a ``[B, 1, 1, Sk]`` bool
mask, a ``[B, H, Sq, Sk]`` float bias and
``Transformer.generate_square_subsequent_mask``, each with and without
``is_causal``. A bias as low as float32's or bfloat16's lowest value adds
as the reference adds it, rows it covers whole included. A row with no
visible key gives the reference's NaN, and its gradients the reference's
NaN pattern. Dropout with a mask is held by
its properties: the reference draws its keep mask with ``jax.random``, the
port with the kernels' hash, so the draws cannot match.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp.modeling_utils import normalize_attention_mask as jnorm
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import seed
from paddle_tpu_torch.nlp.modeling_utils import normalize_attention_mask
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.nn.layers_transformer import Transformer
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from torch_threads import one_torch_thread  # noqa: F401

_B, _SQ, _H, _D = 2, 20, 2, 16


def _mask(kind, rng, sq=_SQ, sk=_SQ):
    """(mask for the port, mask for the reference) of one kind, each
    broadcastable to [B, H, Sq, Sk]; the padding kinds leave every row a
    visible key (keys 0..7 stay)."""
    lens = np.array([sk, 8 + sk // 3])
    keep = np.arange(sk)[None, :] < lens[:, None]               # [B, Sk]
    if kind == "pad_2d":
        m = keep.astype(np.int64)
        return normalize_attention_mask(torch.from_numpy(m)), \
            jnorm(paddle.to_tensor(m))._value
    if kind == "pad_3d":
        m = (keep[:, None, :] & (rng.random((_B, sq, sk)) < 0.8)
             | (np.arange(sk) < 8)).astype(np.int64)
        return normalize_attention_mask(torch.from_numpy(m)), \
            jnorm(paddle.to_tensor(m))._value
    if kind == "pad_4d":
        m = keep[:, None, None, :]
    elif kind == "bias":
        m = rng.standard_normal((_B, _H, sq, sk)).astype(np.float32)
    else:  # "subsequent"
        return Transformer.generate_square_subsequent_mask(sq), \
            np.triu(np.full((sq, sk), -np.inf, np.float32), 1)
    return torch.from_numpy(m), m


def _data(rng, dtype, sq=_SQ, sk=_SQ):
    shapes = [(_B, sq, _H, _D), (_B, sk, _H, _D), (_B, sk, _H, _D),
              (_B, sq, _H, _D)]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if dtype == "bfloat16":  # both sides start from the same bf16 values
        arrs = [torch.from_numpy(a).bfloat16().float().numpy() for a in arrs]
    return arrs


def _reference(q, k, v, do, mask, causal, dtype):
    """The JAX package's dense SDPA: (o, dq, dk, dv) as f32 numpy."""
    ts = [paddle.to_tensor(a).astype(dtype) for a in (q, k, v)]
    for t in ts:
        t.stop_gradient = False
    out = JF.scaled_dot_product_attention(*ts, attn_mask=paddle.to_tensor(
        mask), is_causal=causal)
    (out.astype("float32") * paddle.to_tensor(do)).sum().backward()
    return [np.asarray(out.astype("float32").numpy())] + [
        np.asarray(t.grad.astype("float32").numpy()) for t in ts]


def _port(q, k, v, do, mask, causal, dtype, **kw):
    dt = getattr(torch, dtype)
    ts = [torch.tensor(a).to(dt).requires_grad_() for a in (q, k, v)]
    out = PF.scaled_dot_product_attention(*ts, attn_mask=mask,
                                          is_causal=causal, **kw)
    (out.float() * torch.from_numpy(do)).sum().backward()
    return [out.detach().float().numpy()] + [t.grad.float().numpy()
                                              for t in ts]


def _close(got, want, tol, names=("o", "dq", "dk", "dv")):
    """NaN in the same places, elsewhere |got - want| <= tol (1 + |want|)."""
    for name, g, w in zip(names, got, want):
        assert np.array_equal(np.isnan(g), np.isnan(w)), name
        ok = ~np.isnan(w)
        np.testing.assert_allclose(g[ok], w[ok], atol=tol, rtol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-2)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["pad_2d", "pad_3d", "pad_4d", "bias",
                                  "subsequent"])
def test_sdpa_mask_matches_dense_reference(kind, causal, dtype, tol):
    rng = np.random.default_rng(7)
    pm, jm = _mask(kind, rng)
    q, k, v, do = _data(rng, dtype)
    want = _reference(q, k, v, do, jm, causal, dtype)
    got = _port(q, k, v, do, pm, causal, dtype)
    if kind != "subsequent" or not causal:
        # every mask here leaves each row a visible key
        assert not any(np.isnan(w).any() for w in want)
    _close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-2)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias", ["f32_min", "bf16_min", "-1e9", "-1e4"])
def test_large_negative_bias_matches_reference(bias, causal, dtype, tol):
    """A [B, 1, Sq, Sk] bias of 0 or a large negative value: float32's
    lowest (-3.4e38, a common mask value), bfloat16's (given to the port in
    bfloat16), -1e9 and -1e4 (the old (1 - m) * -1e4 convention). Row 3 of
    batch 0 has every key biased, and batch 1 is padded on the left (its
    first 6 keys biased), so under is_causal its first 6 rows have every
    key biased too. Those rows' softmax runs over the biased scores as the
    reference's does: from -1e9 down, f32 rounds the scores to the bias and
    the softmax is uniform; at -1e4 it keeps them. The gradients follow
    (the backward keeps lse's low part). bfloat16 is held against the
    reference's f32 path on the same bfloat16 inputs: its bf16 path rounds
    logits and backward in bf16 and sits 1.06e-2 of 1 + |g| from the port
    on this data (4.4e-3 from its own f32 path), past the 1e-2 bar."""
    value = {"f32_min": float(np.finfo(np.float32).min),
             "bf16_min": float(torch.finfo(torch.bfloat16).min),
             "-1e9": -1e9, "-1e4": -1e4}[bias]
    rng = np.random.default_rng(11)
    keep = rng.random((_B, 1, _SQ, _SQ)) < 0.7
    keep[..., 12] = True
    keep[0, 0, 3, :] = False
    keep[1, :, :, :6] = False
    m = np.where(keep, 0.0, value).astype(np.float32)
    pm = torch.from_numpy(m)
    if bias == "bf16_min":
        pm = pm.bfloat16()
        assert torch.equal(pm.float(), torch.from_numpy(m))
    q, k, v, do = _data(rng, dtype)
    want = _reference(q, k, v, do, m, causal, "float32")
    got = _port(q, k, v, do, pm, causal, dtype)
    assert not any(np.isnan(w).any() for w in want)
    if bias != "-1e4":
        vis = _SQ if not causal else 4
        np.testing.assert_allclose(want[0][0, 3],
                                   np.asarray(v)[0, :vis].mean(0), atol=1e-6)
    _close(got, want, tol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["bool", "float"])
def test_fully_masked_row_matches_reference(kind, causal):
    """Row 3 of batch 0 sees no key: o is NaN there in both packages, and
    the gradients carry the reference's NaNs (a bool mask: dq of the row
    0, every dv of its heads NaN; a float -inf mask: dq of the row, dk
    and dv NaN where the row's scores were not cut by the causal mask)."""
    rng = np.random.default_rng(3)
    keep = rng.random((_B, 1, _SQ, _SQ)) < 0.7
    keep[..., 0] = True
    keep[0, 0, 3, :] = False
    m = keep if kind == "bool" else np.where(keep, 0.0, -np.inf).astype(
        np.float32)
    q, k, v, do = _data(rng, "float32")
    want = _reference(q, k, v, do, m, causal, "float32")
    got = _port(q, k, v, do, torch.from_numpy(m), causal, "float32")
    assert np.isnan(want[0][0, 3]).all() and np.isnan(got[0][0, 3]).all()
    assert not np.isnan(want[0][1]).any()
    _close(got, want, 1e-5)


def test_kernel_twins_nan_rows_and_kv_lens():
    """At the kernel level a dense mask's empty row gives o = NaN and lse
    (its pair, hi and lo) NaN, while a kv_lens row with no key keeps the
    TPU kernel's 0 and -1e30; a mask with lens, or a float mask that takes
    a gradient, raises."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, 6, 8)).astype(
        np.float32)) for _ in range(3))
    mask = torch.ones(2, 2, 6, 6, dtype=torch.bool)
    mask[1, 0, 2] = False
    o, lse = fa.flash_attention_fwd(q, k, v, mask=mask)
    assert lse.shape == (2, 4, 6)
    assert torch.isnan(o[2, 2]).all() and torch.isnan(lse[:, 2, 2]).all()
    assert not torch.isnan(o[[0, 1, 3]]).any()
    assert torch.isnan(lse).sum() == 2
    lens = torch.tensor([6, 0, 3, 6], dtype=torch.int32)
    o, lse = fa.flash_attention_fwd(q, k, v, lens=lens)
    assert (o[1] == 0).all() and (lse[1] == fa.NEG_INF).all()
    with pytest.raises(ValueError, match="kv_lens"):
        fa.flash_attention_fwd(q, k, v, lens=lens, mask=mask)
    bias = torch.zeros(2, 2, 6, 6, requires_grad=True)
    with pytest.raises(ValueError, match="no gradient"):
        fa.flash_attention_bhsd(q, k, v, mask=bias)


def test_mask_is_read_through_strides_not_copied():
    """ops.attention.flash_attention hands the kernels a [B, H, Sq, Sk]
    view of a [B, 1, 1, Sk] padding mask with stride 0 on the broadcast
    dimensions; the twins give the same output as for the materialised
    mask."""
    from paddle_tpu_torch.ops import attention
    seen = []
    real = fa.flash_attention_fwd

    def spy(*args, **kw):
        seen.append(kw["mask"] if "mask" in kw else args[-1])
        return real(*args, **kw)

    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 5, 3, 8)).astype(
        np.float32)) for _ in range(3))
    pad = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], dtype=torch.bool)
    fa.flash_attention_fwd = spy
    try:
        o = attention.flash_attention(q, k, v,
                                      attn_mask=pad[:, None, None, :])
    finally:
        fa.flash_attention_fwd = real
    m = seen[0]
    assert tuple(m.shape) == (2, 3, 5, 5) and m.stride() == (5, 0, 0, 1)
    assert m.untyped_storage().nbytes() == pad.numel()
    want = attention.flash_attention(
        q, k, v, attn_mask=pad[:, None, None, :].expand(2, 3, 5, 5).clone())
    torch.testing.assert_close(o, want, rtol=0, atol=0)


def _dropout_probe(mask, p, gen_seed):
    """o of a masked, dropped attention whose probabilities are uniform
    over the visible keys (q = 0) and whose V is the identity: o[b, r, h,
    j] = keep(r, j) / ((1 - p) * visible keys of r) on a visible key j, 0
    elsewhere."""
    b, h, s = mask.shape[0], 2, mask.shape[-1]
    q = torch.zeros(b, s, h, s)
    v = torch.eye(s).expand(b, h, s, s).transpose(1, 2).contiguous()
    return PF.scaled_dot_product_attention(
        q, q, v, attn_mask=mask, dropout_p=p, training=True,
        generator=seed(gen_seed, device="cpu"))


def test_dropout_with_mask_properties():
    """The same generator seed repeats bit for bit; the kept share of the
    visible (row, key) pairs is 1 - p within 3 sigma; a masked key gets no
    weight; a kept one weighs 1 / ((1 - p) n_visible)."""
    s, p = 64, 0.3
    pad = torch.arange(s)[None, :] < torch.tensor([[s], [40]])
    mask = pad[:, None, None, :]
    o1 = _dropout_probe(mask, p, 11)
    o2 = _dropout_probe(mask, p, 11)
    assert torch.equal(o1, o2)
    assert not torch.equal(o1, _dropout_probe(mask, p, 12))
    vis = pad[:, None, None, :].expand(2, s, 2, s)         # [B, S, H, key]
    assert (o1[~vis] == 0).all()
    n_vis = vis.sum(-1, keepdim=True).float()
    kept = o1[vis] > 0
    want = (1.0 / ((1 - p) * n_vis)).expand_as(o1)[vis][kept]
    torch.testing.assert_close(o1[vis][kept], want, rtol=1e-6, atol=0)
    n = vis.sum().item()
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(kept.float().mean().item() - (1 - p)) < 3 * sigma


def test_cuda_branch_mask_arguments():
    """What a masked CUDA call hands the C entries, read on the meta
    device (no kernel runs): the mask's kind code, its heads and its four
    element strides, and the backward's lse as the [2, BH, Sq] pair; the
    checks refuse a mask of the wrong shape or dtype, or with lens, and a
    one-row lse with a mask."""
    q = torch.empty(6, 128, 64, dtype=torch.bfloat16, device="meta")
    pad = torch.empty(2, 1, 1, 128, dtype=torch.bool, device="meta")
    mask = pad.expand(2, 3, 128, 128)
    fa._check("fwd", q, q, q, None, None, 0.0, mask=mask)
    pair = torch.empty(2, 6, 128, device="meta")
    fa._check("bwd", q, q, q, None, None, 0.0, stats=(("lse", pair),),
              mask=mask)
    with pytest.raises(ValueError, match=r"\[2, 6, 128\]"):
        fa._check("bwd", q, q, q, None, None, 0.0,
                  stats=(("lse", pair[0]),), mask=mask)
    with pytest.raises(ValueError, match=r"\[6, 128\]"):
        fa._check("bwd", q, q, q, None, None, 0.0, stats=(("lse", pair),))
    args = fa._mask_args(mask)
    assert args[1:] == (1, 3, 128, 0, 0, 1)
    bias = torch.empty(2, 3, 128, 128, dtype=torch.float16, device="meta")
    assert fa._mask_args(bias)[1:] == (4, 3, 3 * 128 * 128, 128 * 128, 128,
                                       1)
    assert fa._mask_args(None) == (None, 0, 0, 0, 0, 0, 0)
    with pytest.raises(ValueError, match="is not"):
        fa._check("fwd", q, q, q, None, None, 0.0, mask=mask[:1])
    with pytest.raises(TypeError, match="mask dtype"):
        fa._check("fwd", q, q, q, None, None, 0.0,
                  mask=mask.to(torch.float64))
    lens = torch.empty(6, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="kv_lens"):
        fa._check("fwd", q, q, q, lens, None, 0.0, mask=mask)


def test_masked_kernels_are_a_second_build():
    """The dense-mask kernels are the DENSE instantiations of the flash
    kernel templates, in the plain libraries: every kernel of the two
    sources takes ``bool DENSE`` as its first template argument, and the C
    entries pick the instantiation by the mask pointer. No second library
    is built."""
    import re
    from paddle_tpu_torch.ops import _build
    names = _build.sources()
    assert not [n for n in names if n.endswith("_mask")]
    for stem in ("flash_attention_fwd", "flash_attention_bwd"):
        assert stem in names
        text = open(_build._lib_path(stem)[0]).read()
        kernels = re.findall(r"template <([^>]*)>\s*__global__[^;{]*?"
                             r"\b(flash_\w+_kernel)\(", text, re.S)
        assert len(kernels) == (2 if stem.endswith("fwd") else 6)
        assert all(t.startswith("bool DENSE,") for t, _ in kernels), kernels
        assert "mask != nullptr ? run<true>" in text or \
            "a.dm.ptr != nullptr ? run_as<DQ, true>" in text
