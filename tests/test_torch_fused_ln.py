"""Fused residual-add + LayerNorm of the PyTorch port vs the JAX package.

The port's four plain twins (``ops.kernels.fused_ln``) are held against
the four Pallas kernels of ``paddle_tpu/ops/pallas/fused_ln.py`` run in
interpret mode on the same numpy inputs: the forward outputs (y, s, mu,
rstd) and the backward's (dx, dgamma, dbeta), each twin given the Pallas
forward's own saved tensors. The two autograd functions are held against
the two ``custom_vjp`` functions, forward and every gradient, for rows
that tile (4 x 32) and rows that do not (7, where the JAX side takes its
jnp fallback, the same math). f32 within 1e-5, bf16 within 1e-2 of
max(1, |reference|); eps 1e-12 (BERT/ERNIE) and 1e-5 (GPT).

On the CPU the wrappers run the twins and launch nothing; the CUDA
kernels are checked against the twins on the card by chip_smoke.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nlp.gpt import _resolve_config as jax_gpt_config
from paddle_tpu.ops.pallas import fused_ln as pallas_ln
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.nlp.gpt import GPTForCausalLM
from paddle_tpu_torch.nlp.gpt import _resolve_config as port_gpt_config
from paddle_tpu_torch.nlp.modeling_utils import fused_residual_ln
from paddle_tpu_torch.nn import LayerNorm
from paddle_tpu_torch.ops.kernels import WRAPPERS
from paddle_tpu_torch.ops.kernels import fused_ln as port_ln
from torch_threads import one_torch_thread  # noqa: F401

_H = 64
_BLOCK_ROWS = 32  # the Pallas grid: 4 steps over 128 rows
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, dtype, what):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    want = _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                   err_msg=what)
    else:
        scaled = np.abs(got - want) / np.maximum(1.0, np.abs(want))
        assert scaled.max() <= 1e-2, (what, scaled.max())


def _inputs(shape, dtype, seed=0, w_dtype=None):
    """x, res, gamma, beta and the two cotangents as numpy f32 (rounded to
    ``dtype`` where the tensors will be stored in it)."""
    rng = np.random.default_rng(seed)
    jdt = _DT[dtype][0]
    wdt = _DT[w_dtype or dtype][0]
    rnd = lambda a, dt: np.asarray(  # noqa: E731
        jnp.asarray(a, dt).astype(jnp.float32))
    h = shape[-1]
    x = rnd(rng.standard_normal(shape) * 2 + 0.5, jdt)
    res = rnd(rng.standard_normal(shape), jdt)
    g = rnd(rng.standard_normal(h) * 0.1 + 1.0, wdt)
    b = rnd(rng.standard_normal(h) * 0.1, wdt)
    cy = rnd(rng.standard_normal(shape), jdt)
    cs = rnd(rng.standard_normal(shape), jdt)
    return x, res, g, b, cy, cs


def _j(a, dtype):
    return jnp.asarray(a, _DT[dtype][0])


def _t(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(_DT[dtype][1])


@pytest.mark.parametrize("eps", [1e-12, 1e-5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["sum", "y"])
def test_twins_match_pallas_kernels(variant, dtype, eps):
    """#6/#7 (variant 'sum') and #8/#9 ('y'): each twin against its
    Pallas kernel on the same inputs."""
    x, res, g, b, dy, ds = _inputs((128, _H), dtype, seed=1)
    jx, jr, jg, jb, jdy, jds = (_j(a, dtype) for a in (x, res, g, b, dy, ds))
    px, pr, pg, pb, pdy, pds = (_t(a, dtype) for a in (x, res, g, b, dy, ds))
    if variant == "sum":
        y, s, mu, rstd = pallas_ln._fwd_call(jx, jr, jg, jb, eps,
                                             _BLOCK_ROWS, True)
        ty, ts, tmu, trstd = port_ln.fused_add_layer_norm_fwd_plain(
            px, pr, pg, pb, eps)
        _close(ts, s, dtype, "s")
        assert ts.dtype == px.dtype
        dx, dg, db = pallas_ln._bwd_call(jdy, jds, s, mu, rstd, jg,
                                         _BLOCK_ROWS, True)
        # the twin reads the Pallas forward's own saved s, mu and rstd
        tdx, tdg, tdb = port_ln.fused_add_layer_norm_bwd_plain(
            pdy, pds, _t(_np(s), dtype), _t(_np(mu)[:, 0], "float32"),
            _t(_np(rstd)[:, 0], "float32"), pg)
    else:
        y, mu, rstd = pallas_ln._fwd_call_y(jx, jr, jg, jb, eps,
                                            _BLOCK_ROWS, True)
        ty, tmu, trstd = port_ln.fused_add_layer_norm_y_fwd_plain(
            px, pr, pg, pb, eps)
        dx, dg, db = pallas_ln._bwd_call_y(jdy, jx, jr, mu, rstd, jg,
                                           _BLOCK_ROWS, True)
        tdx, tdg, tdb = port_ln.fused_add_layer_norm_y_bwd_plain(
            pdy, px, pr, _t(_np(mu)[:, 0], "float32"),
            _t(_np(rstd)[:, 0], "float32"), pg)
    _close(ty, y, dtype, "y")
    assert ty.dtype == px.dtype and tdx.dtype == pdy.dtype
    # row statistics in f32 whatever the dtype: mu to 1e-5; rstd, which
    # reaches ~1/sqrt(eps) on a flat row, to 1e-5 relative
    np.testing.assert_allclose(tmu.numpy(), _np(mu)[:, 0], atol=1e-5)
    np.testing.assert_allclose(trstd.numpy(), _np(rstd)[:, 0], rtol=1e-5)
    assert tmu.dtype == trstd.dtype == tdg.dtype == tdb.dtype == \
        torch.float32
    _close(tdx, dx, dtype, "dx")
    # dgamma/dbeta: f32 sums over the 128 rows on both sides
    _close(tdg, _np(dg)[0], "float32", "dgamma")
    _close(tdb, _np(db)[0], "float32", "dbeta")


def _jax_vjp(variant, x, res, g, b, cy, cs, eps, dtype, w_dtype):
    args = (_j(x, dtype), _j(res, dtype), _j(g, w_dtype), _j(b, w_dtype))
    if variant == "sum":
        fn = lambda *a: pallas_ln.fused_add_layer_norm(  # noqa: E731
            *a, eps, 0, True)
        out, vjp = jax.vjp(fn, *args)
        grads = vjp((_j(cy, dtype), _j(cs, dtype)))
    else:
        fn = lambda *a: pallas_ln.fused_add_layer_norm_y(  # noqa: E731
            *a, eps, 0, True)
        y, vjp = jax.vjp(fn, *args)
        out, grads = (y,), vjp(_j(cy, dtype))
    return out, grads


@pytest.mark.parametrize("shape", [(4, 32, _H), (7, _H)],
                         ids=["tiles", "ragged"])
@pytest.mark.parametrize("eps", [1e-12, 1e-5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["sum", "y"])
def test_autograd_functions_match_custom_vjp(variant, dtype, eps, shape):
    """Forward and every gradient of the two autograd functions against
    the two custom_vjp functions (Pallas in interpret mode)."""
    x, res, g, b, cy, cs = _inputs(shape, dtype, seed=2)
    out, grads = _jax_vjp(variant, x, res, g, b, cy, cs, eps, dtype, dtype)
    leaves = [_t(a, dtype).requires_grad_() for a in (x, res, g, b)]
    if variant == "sum":
        y, s = port_ln.fused_add_layer_norm(*leaves, eps)
        torch.autograd.backward((y, s), (_t(cy, dtype), _t(cs, dtype)))
        got = (y, s)
    else:
        y = port_ln.fused_add_layer_norm_y(*leaves, eps)
        y.backward(_t(cy, dtype))
        got = (y,)
    for name, a, w in zip(("y", "s"), got, out):
        _close(a, w, dtype, name)
    for name, leaf, w in zip(("dx", "dres", "dgamma", "dbeta"), leaves,
                             grads):
        assert leaf.grad.dtype == leaf.dtype, name
        _close(leaf.grad, w, dtype, name)


@pytest.mark.parametrize("variant", ["sum", "y"])
def test_f32_params_with_bf16_rows(variant):
    """gamma and beta kept in f32 while the rows are bf16 (the kernels take
    both); grads come back in each leaf's dtype."""
    x, res, g, b, cy, cs = _inputs((4, 32, _H), "bfloat16", seed=3,
                                   w_dtype="float32")
    out, grads = _jax_vjp(variant, x, res, g, b, cy, cs, 1e-5, "bfloat16",
                          "float32")
    leaves = [_t(x, "bfloat16"), _t(res, "bfloat16"), _t(g, "float32"),
              _t(b, "float32")]
    for t in leaves:
        t.requires_grad_()
    fn = (port_ln.fused_add_layer_norm if variant == "sum"
          else port_ln.fused_add_layer_norm_y)
    res_out = fn(*leaves, 1e-5)
    got = res_out if variant == "sum" else (res_out,)
    torch.autograd.backward(got, (_t(cy, "bfloat16"),
                                  _t(cs, "bfloat16"))[:len(got)])
    for name, a, w in zip(("y", "s"), got, out):
        _close(a, w, "bfloat16", name)
    for name, leaf, w in zip(("dx", "dres", "dgamma", "dbeta"), leaves,
                             grads):
        assert leaf.grad.dtype == leaf.dtype, name
        _close(leaf.grad, w, "bfloat16", name)


def test_fused_residual_ln_reads_the_layer():
    """``fused_residual_ln`` takes weight, bias and epsilon from the
    LayerNorm and picks the variant by ``want_sum``."""
    ln = LayerNorm(_H, epsilon=1e-12, device="cpu")
    with torch.no_grad():
        ln.weight.normal_(1.0, 0.1, generator=torch.Generator().manual_seed(0))
    x, res, *_ = _inputs((3, 5, _H), "float32", seed=4)
    xt, rt = _t(x, "float32"), _t(res, "float32")
    y, s = fused_residual_ln(xt, rt, ln)
    want = torch.nn.functional.layer_norm(xt + rt, (_H,), ln.weight, ln.bias,
                                          1e-12)
    torch.testing.assert_close(y, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(s, xt + rt, atol=0, rtol=0)
    y2 = fused_residual_ln(xt, rt, ln, want_sum=False)
    torch.testing.assert_close(y2, y, atol=0, rtol=0)


def test_cpu_calls_launch_nothing():
    x, res, g, b, cy, cs = (_t(a, "float32") for a in
                            _inputs((9, _H), "float32", seed=5))
    before = {w.__name__: w.launches for w in WRAPPERS}
    for fn in (port_ln.fused_add_layer_norm, port_ln.fused_add_layer_norm_y):
        leaves = [t.clone().requires_grad_() for t in (x, res, g, b)]
        out = fn(*leaves, 1e-5)
        (out[0] if isinstance(out, tuple) else out).sum().backward()
    assert {w.__name__: w.launches for w in WRAPPERS} == before


def test_gpt_fused_ln_forward_matches_jax():
    """GPT with ``fused_ln=True`` (the reference's fused block, kernels
    #6/#7) gives the JAX model's logits."""
    ovr = dict(num_attention_heads=1, fused_ln=True)
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_config("gpt-tiny", **ovr))
    jm.eval()
    pm = GPTForCausalLM(port_gpt_config("gpt-tiny", **ovr), device="cpu")
    load_numpy_state(pm, {k: np.asarray(v._value)
                          for k, v in jm.state_dict().items()})
    pm.eval()
    ids = np.random.default_rng(7).integers(0, 256, (2, 24)).astype(np.int32)
    want = np.asarray(jm(paddle.to_tensor(ids))._value)
    with torch.no_grad():
        got = pm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
