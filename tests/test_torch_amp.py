"""The port's ``amp`` package vs the JAX package's.

- GradScaler's eager API: the reference's cases of ``tests/test_hapi_io.py``
  (``minimize`` unscales 16 to 2, ``unscale_guarded_step`` skips an inf
  gradient and backs off), unscale-then-step dividing once, ``update``'s
  growth and backoff step by step against the reference's over one flag
  sequence, the counters, ``state_dict``/``load_state_dict``.
- The functional core: ``functional_update`` on device tensors against the
  reference's ``jnp.where`` arithmetic over random flag sequences, for
  several (incr_every, decr_every, ratios): scale, good and bad equal
  exactly at every step (f32 and int32 both ways).
- ``decorate`` at O2 (float16 parameters, f32 masters in Adam's ``master``
  slot) and two eager float16 steps of a small MLP through
  ``scaler.scale(loss).backward()``, ``scaler.step``, ``scaler.update``
  against the reference's: the float16 parameters within 1e-3 of
  max(1, |ref|) (one float16 ulp at 1 is 9.8e-4), the f32 masters within
  1e-3 (the two packages' float16 forwards round apart), the scale
  equal.
- The ``auto_cast`` state (enabled, dtype, level, nesting) and
  ``debugging`` (``check_numerics`` raising, warning, passing, on scalars;
  the spike detector; the tensor checker's mode).
- A float16 ``load_numpy_state`` round trip of gpt-tiny's weights, bit for
  bit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.amp as ref_amp
from paddle_tpu.nlp.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nlp.gpt import _resolve_config as jax_config
import paddle_tpu_torch as pt
from paddle_tpu_torch import amp
from paddle_tpu_torch.amp import GradScaler, debugging
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.nlp.gpt import GPTForCausalLM
from paddle_tpu_torch.nlp.gpt import _resolve_config as port_config
from paddle_tpu_torch.optimizer import Adam, Momentum
from torch_threads import one_torch_thread  # noqa: F401


def _sgd(lr, params):
    """The reference's SGD: Momentum with momentum 0."""
    return Momentum(learning_rate=lr, momentum=0.0, parameters=params)


def test_gradscaler_minimize():
    s = GradScaler(init_loss_scaling=8.0, incr_every_n_steps=2,
                   decr_every_n_nan_or_inf=1)
    w = torch.nn.Parameter(torch.tensor([1.0]))
    opt = _sgd(0.1, [("w", w)])
    loss = (w * w).sum()
    scaled = s.scale(loss)
    assert float(scaled.detach()) == float(loss.detach()) * 8.0
    s.minimize(opt, scaled)
    # grad 2 * 8 = 16 unscaled to 2: w = 1 - 0.2
    torch.testing.assert_close(w.detach(), torch.tensor([0.8]), atol=1e-6,
                               rtol=0)
    assert w.grad is None


def test_scaler_skips_inf():
    s = GradScaler(init_loss_scaling=4.0, decr_every_n_nan_or_inf=1)
    w = torch.nn.Parameter(torch.tensor([1.0]))
    opt = _sgd(0.1, [("w", w)])
    w.grad = torch.tensor([np.inf])
    s.unscale_guarded_step(opt)
    s.update()
    assert w.item() == 1.0  # step skipped
    assert s._scale == 2.0  # backed off
    assert s.found_inf_count == 1 and s.skip_count == 1


def test_unscale_then_step_divides_once():
    s = GradScaler(init_loss_scaling=1024.0)
    w = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    opt = _sgd(1.0, [("w", w)])
    s.scale((w * w).sum()).backward()
    s.unscale_(opt)
    torch.testing.assert_close(w.grad, torch.tensor([2.0, -4.0]))
    s.step(opt)
    torch.testing.assert_close(w.detach(), torch.tensor([-1.0, 2.0]))
    s.update()
    assert s.skip_count == 0 and s._good == 1


def test_update_and_state_dict_match_reference():
    """update()'s growth and backoff, the counters and the state dict,
    step by step against the reference over one flag sequence."""
    flags = [False, False, True, False, False, False, True, True, False]
    kw = dict(init_loss_scaling=16.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=2, decr_ratio=0.25)
    ref, port = ref_amp.GradScaler(**kw), GradScaler(**kw)
    for found in flags:
        for s in (ref, port):
            s._found_inf = found
            s.note_step(found)
            s.update()
        assert port.state_dict() == ref.state_dict()
    # as the reference's: the ratios are the constructor's, not the dict's
    fresh = GradScaler(**kw)
    fresh.load_state_dict(port.state_dict())
    assert fresh.state_dict() == port.state_dict()
    assert (fresh.found_inf_count, fresh.skip_count) == (3, 3)


@pytest.mark.parametrize("incr_every,decr_every,incr,decr", [
    (2, 1, 2.0, 0.5), (3, 2, 2.0, 0.5), (1, 3, 4.0, 0.125)])
def test_functional_update_matches_reference(incr_every, decr_every, incr,
                                             decr):
    rng = np.random.default_rng(incr_every * 10 + decr_every)
    flags = rng.random(60) < 0.4
    flags[:12] = True  # decay to the floor of 1.0
    kw = dict(incr_ratio=incr, decr_ratio=decr, incr_every=incr_every,
              decr_every=decr_every)
    ref = ref_amp.GradScaler.functional_init(8.0)
    port = GradScaler.functional_init(8.0)
    assert port["scale"].dtype == torch.float32
    assert port["good"].dtype == port["bad"].dtype == torch.int32
    for f in flags:
        ref = ref_amp.GradScaler.functional_update(ref, jnp.bool_(f), **kw)
        port = GradScaler.functional_update(port, torch.tensor(bool(f)),
                                            **kw)
        for k in ("scale", "good", "bad"):
            want = np.asarray(ref[k])
            got = port[k].numpy()
            assert got.dtype == want.dtype and got == want, (k, got, want)


def test_auto_cast_state():
    assert not amp.is_auto_cast_enabled()
    with amp.auto_cast(level="O2", dtype="float16"):
        assert amp.is_auto_cast_enabled()
        assert (amp.get_amp_dtype(), amp.get_amp_level()) == ("float16",
                                                              "O2")
        with amp.amp_guard(enable=False):
            assert not amp.is_auto_cast_enabled()
        assert amp.is_auto_cast_enabled()
    assert not amp.is_auto_cast_enabled()
    assert amp.autocast is amp.auto_cast
    assert amp.is_float16_supported() and amp.is_bfloat16_supported()


def _mlp_state():
    paddle.seed(3)
    net = paddle.nn.Sequential(paddle.nn.Linear(16, 32), paddle.nn.ReLU(),
                               paddle.nn.Linear(32, 8))
    return net, {k: np.asarray(v._value) for k, v in net.state_dict().items()}


def test_decorate_o2_float16_eager_steps():
    rnet, state = _mlp_state()
    ropt = paddle.optimizer.Adam(1e-2, parameters=rnet.parameters())
    rnet, ropt = ref_amp.decorate(rnet, ropt, level="O2", dtype="float16")
    pnet = pt.nn.Sequential(pt.nn.Linear(16, 32, device="cpu"),
                            pt.nn.ReLU(), pt.nn.Linear(32, 8, device="cpu"))
    load_numpy_state(pnet, state)
    popt = Adam(1e-2, parameters=pnet.named_parameters())
    pnet, popt = amp.decorate(pnet, popt, level="O2", dtype="float16")
    assert popt._multi_precision and ropt._multi_precision
    assert all(p.dtype == torch.float16 for p in pnet.parameters())
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=1)
    rs, ps = ref_amp.GradScaler(**kw), GradScaler(**kw)
    rng = np.random.default_rng(0)
    for _ in range(2):
        x = rng.standard_normal((4, 16)).astype(np.float16)
        rl = rnet(paddle.to_tensor(x)).astype("float32").square().mean()
        rs.scale(rl).backward()
        rs.step(ropt)
        rs.update()
        ropt.clear_grad()
        pl = pnet(torch.from_numpy(x)).float().square().mean()
        ps.scale(pl).backward()
        ps.step(popt)
        ps.update()
        popt.clear_grad()
        np.testing.assert_allclose(float(pl.detach()), float(rl), rtol=1e-3)
    assert ps._scale == rs._scale == 4096.0
    ref_state = {k: np.asarray(v._value) for k, v in
                 rnet.state_dict().items()}
    for k, p in pnet.state_dict().items():
        want = ref_state[k].astype(np.float32)
        got = p.float().numpy()
        assert p.dtype == torch.float16
        assert (np.abs(got - want) / np.maximum(1, np.abs(want))).max() \
            <= 1e-3, k
        master = popt._state[k]["master"]
        assert master.dtype == torch.float32
        np.testing.assert_allclose(master.numpy(), want, atol=1e-3)


def test_check_numerics():
    bad = {"w": torch.tensor([1.0, float("nan")])}
    with pytest.raises(FloatingPointError, match=r"\['w'\]: 1 NaN, 0 Inf"):
        debugging.check_numerics(bad)
    with pytest.warns(UserWarning):
        debugging.check_numerics(torch.tensor([float("inf")]),
                                 debug_mode=debugging.DebugMode.CHECK_NAN_INF)
    debugging.check_numerics({"a": torch.ones(4),
                              "b": [torch.zeros(2, dtype=torch.float16)],
                              "i": torch.tensor([1, 2])})
    with pytest.raises(FloatingPointError):
        debugging.check_numerics({"loss": float("nan")})
    debugging.check_numerics({"loss": 1.0, "n": 3})
    debugging.enable_tensor_checker(debugging.TensorCheckerConfig(
        debug_mode=debugging.DebugMode.CHECK_NAN_INF))
    try:
        assert debugging.tensor_checker_enabled()
        with pytest.warns(UserWarning):
            debugging.check_numerics(torch.tensor([float("nan")]))
    finally:
        debugging.disable_tensor_checker()
    assert not debugging.tensor_checker_enabled()
    with debugging.collect_operator_stats() as stats:
        pass
    assert stats.summary() == []


def test_grad_spike_detector():
    det = debugging.GradNormSpikeDetector(window=16, factor=5.0)
    ref = ref_amp.debugging.GradNormSpikeDetector(window=16, factor=5.0)
    g = {"w": torch.ones(4)}
    for _ in range(10):
        assert not det.check(g)
    assert det.check({"w": torch.full((4,), 100.0)})
    np.testing.assert_allclose(
        det.global_norm([torch.full((3,), 2.0), torch.ones(2)]),
        ref.global_norm([jnp.full((3,), 2.0), jnp.ones(2)]), rtol=1e-7)
    small = debugging.GradNormSpikeDetector(window=8)
    for _ in range(100):
        small.check({"w": torch.ones(2)})
    assert len(small._history) <= 8


def test_float16_load_numpy_state_round_trip():
    paddle.seed(0)
    jm = JaxGPT(jax_config("gpt-tiny"))
    state = {k: np.asarray(v._value).astype(np.float16)
             for k, v in jm.state_dict().items()}
    pm = GPTForCausalLM(port_config("gpt-tiny"), device="cpu").to(
        torch.float16)
    load_numpy_state(pm, state)
    back = {k: v.numpy() for k, v in pm.state_dict().items()}
    assert set(back) == set(state)
    for k, v in back.items():
        assert v.dtype == np.float16
        assert np.array_equal(v.view(np.uint16), state[k].view(np.uint16)), k
