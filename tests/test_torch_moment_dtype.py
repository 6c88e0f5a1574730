"""bf16 Adam moments (``moment_dtype="bfloat16"``) and ``multi_precision``
master weights in the PyTorch port, against the JAX package.

- ``sround_bf16`` fed the reference's own noise (``jax.random.bits`` of the
  key ``_sround_bf16`` draws with) gives ``_sround_bf16``'s bf16 bit for
  bit, over normal, tiny, huge, subnormal and bf16-exact values; inf and
  -inf pass through unrounded and NaN stays NaN, whatever the noise.
- The rounding is unbiased, with the noise from the optimizer's own
  generator: the mean of 128 roundings within 3e-3 of the values' scale
  (the reference test's bar), and an EMA of 1e-3 increments, which
  nearest rounding freezes, tracked within 3e-3 over the mean of 4096
  lanes (the reference test holds one lane to 3%; one lane's walk spreads
  by about 4%).
- Three AdamW steps with bf16 moments, and three with ``multi_precision``
  (bf16 parameters, f32 master weights; f32 and bf16 moments), against the
  reference's ``update`` with its per-step, per-leaf noise fed in:
  parameters, master weights and moments bit for bit (the f32 math is
  the same ops in the same order on both sides, eagerly).
- AMSGrad's vhat stays f32 under bf16 moments. #10 (the multi-leaf
  kernel's route) takes no leaf with bf16 moments or a master weight.
- An Engine keeps bf16 moments bf16 step after step, its loss falls, and
  it lists the optimizer's generator among those a CUDA graph of the step
  must register; ``Model.save``/``load`` carry bf16 moments and master
  weights through ``.pdopt``.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.optimizer.optimizer import _sround_bf16
from paddle_tpu_torch import nn, seed
from paddle_tpu_torch.hapi import Engine, Model
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import optimizer as port_opt
from paddle_tpu_torch.optimizer.optimizer import sround_bf16
from torch_threads import one_torch_thread  # noqa: F401


def _bits16(t):
    """A bf16 tensor or array's 16-bit patterns as int32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().astype(np.int32) & 0xFFFF
    return np.asarray(t).view(np.uint16).astype(np.int32)


def _port_round(x, key):
    noise = np.asarray(jax.random.bits(key, x.shape, jnp.uint16))
    return sround_bf16(torch.from_numpy(np.asarray(x, np.float32)),
                       torch.from_numpy(noise.astype(np.int32)))


def _values(seed_):
    rng = np.random.default_rng(seed_)
    x = rng.standard_normal(4096).astype(np.float32)
    x[:512] *= 1e-30
    x[512:1024] *= 1e30
    x[1024:1280] = (rng.integers(1, 2 ** 20, 256)
                    * np.float32(1e-45)).astype(np.float32)  # subnormal
    x[1280:1536] = np.asarray(jnp.asarray(x[1280:1536], jnp.bfloat16),
                              np.float32)                    # bf16-exact
    x[1536] = np.finfo(np.float32).max
    x[1537] = -np.finfo(np.float32).max
    x[1538] = 0.0
    x[1539] = -0.0
    return x


@pytest.mark.parametrize("seed_", range(4))
def test_rounding_is_the_references_bit_for_bit(seed_):
    x = _values(seed_)
    key = jax.random.PRNGKey(100 + seed_)
    want = _sround_bf16(jnp.asarray(x), key)
    got = _port_round(x, key)
    np.testing.assert_array_equal(_bits16(got), _bits16(want))


def test_non_finite_values_pass_through():
    x = np.array([np.inf, -np.inf, np.nan, 1.0, -3.5], np.float32)
    for noise in (np.zeros(5, np.int32), np.full(5, 0xFFFF, np.int32),
                  np.full(5, -1, np.int32)):
        got = sround_bf16(torch.from_numpy(x), torch.from_numpy(noise))
        assert got[0].item() == np.inf and got[1].item() == -np.inf
        assert np.isnan(got[2].item())
    # the reference on the same values, for each key
    for k in range(3):
        key = jax.random.PRNGKey(k)
        want = np.asarray(_sround_bf16(jnp.asarray(x), key), np.float32)
        got = _port_round(x, key).float().numpy()
        np.testing.assert_array_equal(got[[0, 1, 3, 4]], want[[0, 1, 3, 4]])
        assert np.isnan(got[2]) and np.isnan(want[2])


def test_rounding_is_unbiased_with_the_generators_noise():
    opt = AdamW(parameters=[torch.nn.Parameter(torch.zeros(2048))],
                moment_dtype="bfloat16")
    p = [torch.zeros(2048)]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(2048)
                         .astype(np.float32)) * 0.01
    acc = torch.zeros_like(x)
    n = 128
    for _ in range(n):
        nm, _ = opt.rounding_noise(["x"], p)[0]
        acc += sround_bf16(x, nm).float()
    err = ((acc / n - x).abs().max() / x.abs().max()).item()
    assert err < 3e-3
    # an EMA of 1e-3 increments, below bf16's resolution at 1.0: nearest
    # rounding freezes it; stochastic rounding tracks it. One lane's walk
    # spreads by ~4% of the value after 1500 steps (the rounding's noise
    # summed over the EMA's ~500-step memory), so 4096 lanes are read by
    # their mean
    lanes = [torch.zeros(4096)]
    v32, vbf = 1.0, torch.ones(4096, dtype=torch.bfloat16)
    near = torch.ones(4096, dtype=torch.bfloat16)
    for _ in range(1500):
        v32 = 0.999 * v32 + 0.001 * 2.0
        vnew = 0.999 * vbf.float() + 0.001 * 2.0
        vbf = sround_bf16(vnew, opt.rounding_noise(["v"], lanes)[0][1])
        near = (0.999 * near.float() + 0.001 * 2.0).to(torch.bfloat16)
    assert (near == 1.0).all()
    assert abs(vbf.float().mean().item() - v32) / v32 < 3e-3
    # the default generator is seeded: a second optimizer draws the same
    again = AdamW(parameters=[torch.nn.Parameter(torch.zeros(3))],
                  moment_dtype="bfloat16")
    first = AdamW(parameters=[torch.nn.Parameter(torch.zeros(3))],
                  moment_dtype="bfloat16")
    three = [torch.zeros(3)]
    assert torch.equal(again.rounding_noise(["a"], three)[0][0],
                       first.rounding_noise(["a"], three)[0][0])


# -- optimizer steps against the reference's update ------------------------

_SHAPES = {"fc.weight": (8, 16), "fc.bias": (16,), "emb.weight": (32, 8)}
_LR = 1e-2


def _reference_noise(step, names, params):
    """The reference's rounding noise of ``step`` for each leaf: the bits
    ``_store_moment`` draws for m and for v."""
    skey = jax.random.fold_in(jax.random.PRNGKey(0xAD04), step)
    out = []
    for name, p in zip(names, params):
        kk = jax.random.fold_in(skey, zlib.crc32(name.encode()) & 0x7FFFFFFF)
        km, kv = jax.random.split(kk)
        out.append(tuple(torch.from_numpy(np.asarray(
            jax.random.bits(k, tuple(p.shape), jnp.uint16)).astype(np.int32))
            for k in (km, kv)))
    return out


def _steps(moment_dtype, multi_precision, param_dtype, amsgrad=False,
           steps=3):
    rng = np.random.default_rng(1)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in _SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** -i).astype(np.float32)
              for k, s in _SHAPES.items()} for i in range(steps)]
    jdt = jnp.bfloat16 if param_dtype == torch.bfloat16 else jnp.float32
    decay = lambda n: not n.endswith("bias")  # noqa: E731
    ref = paddle.optimizer.AdamW(
        learning_rate=_LR, weight_decay=0.01, parameters=[],
        moment_dtype=moment_dtype, multi_precision=multi_precision,
        amsgrad=amsgrad, apply_decay_param_fun=decay)
    jp = {k: jnp.asarray(v, jdt) for k, v in p0.items()}
    state = ref.init_state(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(v).to(param_dtype))
              for k, v in p0.items()}
    opt = AdamW(_LR, parameters=list(params.items()), weight_decay=0.01,
                moment_dtype=moment_dtype, multi_precision=multi_precision,
                amsgrad=amsgrad, apply_decay_param_fun=decay,
                fused_kernel=True)
    opt.rounding_noise = lambda names, ps: _reference_noise(
        opt._step_count + 1, names, ps)
    for i, g in enumerate(grads):
        jp, state = ref.update(jp, {k: jnp.asarray(v, jdt)
                                    for k, v in g.items()},
                               state, _LR, i + 1)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k]).to(param_dtype)
        opt.step()
    return jp, state, params, opt


def _check_same(jp, state, params, opt):
    for k, p in params.items():
        np.testing.assert_array_equal(
            p.detach().float().numpy(), np.asarray(jp[k], np.float32),
            err_msg=k)
        for slot, ref_slots in state.items():
            got, want = opt._state[k][slot], ref_slots[k]
            assert got.dtype == opt._slot_dtype(slot, p), (k, slot)
            np.testing.assert_array_equal(
                got.float().numpy(), np.asarray(want, np.float32),
                err_msg=f"{k} {slot}")


def test_bf16_moment_steps_match_the_reference():
    jp, state, params, opt = _steps("bfloat16", False, torch.float32)
    assert all(opt._state[k]["m"].dtype == torch.bfloat16 for k in params)
    assert np.asarray(state["m"]["fc.weight"]).dtype == jnp.bfloat16
    _check_same(jp, state, params, opt)


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_multi_precision_steps_match_the_reference(moment_dtype):
    jp, state, params, opt = _steps(moment_dtype, True, torch.bfloat16)
    assert set(opt._slot_names()) == set(state) == {"m", "v", "master"}
    assert all(p.dtype == torch.bfloat16 for p in params.values())
    _check_same(jp, state, params, opt)
    # the master moved by less than bf16 resolves: the parameter is its
    # rounding, the master keeps the small steps
    for k, p in params.items():
        master = opt._state[k]["master"]
        assert master.dtype == torch.float32
        assert torch.equal(p.detach(), master.to(torch.bfloat16))


def test_amsgrad_vhat_stays_f32():
    jp, state, params, opt = _steps("bfloat16", False, torch.float32,
                                    amsgrad=True)
    assert all(opt._state[k]["vhat"].dtype == torch.float32 for k in params)
    _check_same(jp, state, params, opt)


def test_the_multi_leaf_kernel_takes_no_rounded_or_mastered_leaf(
        monkeypatch):
    calls = []
    real = port_opt.fused_adamw_multi_update

    def spy(ps, *args, **kw):
        calls.append(len(ps))
        return real(ps, *args, **kw)
    monkeypatch.setattr(port_opt, "fused_adamw_multi_update", spy)
    for kw in (dict(moment_dtype="bfloat16"), dict(multi_precision=True),
               dict()):
        p = torch.nn.Parameter(torch.randn(64))
        opt = AdamW(1e-3, parameters=[("w", p)], fused_kernel=True, **kw)
        p.grad = torch.randn(64)
        opt.step()
    assert calls == [1]


def test_engine_keeps_bf16_moments_and_registers_the_generator(tmp_path):
    net = nn.Sequential(nn.Linear(8, 16, device="cpu"), nn.ReLU(),
                        nn.Linear(16, 4, device="cpu"))
    opt = AdamW(1e-2, moment_dtype="bfloat16", multi_precision=True,
                fused_kernel=True)
    eng = Engine(net, loss=nn.CrossEntropyLoss(), optimizer=opt)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 8))
                         .astype(np.float32))
    y = torch.tensor([0, 1, 2, 3])
    losses = [eng.train_batch([x], [y])[0].item() for _ in range(6)]
    assert losses[-1] < losses[0]
    for st in opt._state.values():
        assert st["m"].dtype == st["v"].dtype == torch.bfloat16
        assert st["master"].dtype == torch.float32
    assert opt.generator is not None and opt.generator in eng.generators()
    # .pdopt carries the bf16 moments and the masters
    model = Model(net)
    model.prepare(opt, nn.CrossEntropyLoss())
    model._engine = eng
    model.save(str(tmp_path / "ck"))
    net2 = nn.Sequential(nn.Linear(8, 16, device="cpu"), nn.ReLU(),
                         nn.Linear(16, 4, device="cpu"))
    opt2 = AdamW(1e-2, parameters=net2.named_parameters(),
                 moment_dtype="bfloat16", multi_precision=True)
    model2 = Model(net2)
    model2.prepare(opt2, nn.CrossEntropyLoss())
    model2.load(str(tmp_path / "ck"))
    for name, st in opt._state.items():
        for slot, t in st.items():
            got = opt2._state[name][slot]
            assert got.dtype == t.dtype and torch.equal(got, t), (name, slot)


def test_optimizer_generator_is_the_callers():
    g = seed(5, device="cpu")
    opt = AdamW(parameters=[torch.nn.Parameter(torch.zeros(4))],
                moment_dtype="bfloat16")
    opt.generator = g
    nm, _ = opt.rounding_noise(["w"], [torch.zeros(4)])[0]
    assert opt.generator is g
    want = torch.empty(4, dtype=torch.int16).random_(
        -2 ** 15, 2 ** 15, generator=seed(5, device="cpu"))
    assert torch.equal(nm, want)
    with pytest.raises(ValueError, match="float16"):
        AdamW(parameters=[], moment_dtype="float16")
