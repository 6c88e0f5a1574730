"""The port's fault registry, retry and TrainGuard vs the JAX package's.

The reference's chaos cases (``tests/test_resilience.py``:
``TestFaultRegistry``, ``TestRetry``, ``TestTrainGuard``) run on the
port's modules and its Engine. Each guarded run is also held to the JAX
Engine under the same guard, the same weights (through numpy) and the
same batches: the observed losses (a skipped step's NaN included) within
1e-5 relative, and exactly the same guard counters, GradScaler scale,
``opt_step`` and LR scheduler position. Two cases the port adds: a
rollback copies the snapshot into the live tensors (every parameter's and
optimizer slot's ``data_ptr`` unchanged, the values the snapshot's bit
for bit), a guarded step reads exactly one value back to the host
(its finite flag; a ``TorchDispatchMode`` counts the reads), and a bad
step leaves every parameter, optimizer slot and BatchNorm statistic bit
for bit on each update path (Momentum, plain and fused AdamW, master
weights, bf16 moments, AMSGrad).
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
from paddle_tpu.amp import GradScaler as JaxGradScaler
from paddle_tpu.hapi.engine import Engine as JaxEngine
from paddle_tpu.resilience import TrainGuard as JaxTrainGuard
from paddle_tpu.resilience import faults as jax_faults
import paddle_tpu_torch as pt
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.hapi import Engine
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.optimizer import AdamW, Momentum
from paddle_tpu_torch.resilience import TrainGuard, faults, preemption
from paddle_tpu_torch.resilience.retry import (RetryStats, TransientError,
                                               call_with_retries,
                                               is_transient)
from torch_threads import one_torch_thread  # noqa: F401

_TOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_slate():
    for f in (faults, jax_faults):
        f.clear()
    preemption.clear()
    yield
    for f in (faults, jax_faults):
        f.clear()
    preemption.clear()


# -- fault registry -------------------------------------------------------

class TestFaultRegistry:
    def test_pull_consumes_and_pins(self):
        faults.inject("nan_grads", step=5)
        assert faults.pull("nan_grads", 4) is None
        assert faults.pull("nan_grads", 5) == {}
        assert faults.pull("nan_grads", 5) is None, "count=1 exhausted"

    def test_unpinned_fires_count_times(self):
        faults.inject("slow_step", count=2, seconds=0.0)
        assert faults.pull("slow_step", 1) is not None
        assert faults.pull("slow_step", 9) is not None
        assert faults.pull("slow_step", 10) is None
        assert faults.fired_log() == [("slow_step", 1), ("slow_step", 9)]

    def test_env_grammar(self, monkeypatch):
        monkeypatch.setenv(
            "PADDLE_TPU_FAULTS",
            "nan_grads@10x3, sigterm@25, slow_step@5:seconds=0.5,"
            "page_exhaustion")
        faults.clear()
        faults.load_env(force=True)
        assert faults.pull("nan_grads", 10) == {}
        assert faults.pull("nan_grads", 11) == {}
        assert faults.pull("nan_grads", 12) == {}
        assert faults.pull("nan_grads", 13) is None
        assert faults.pull("sigterm", 25) == {}
        assert faults.pull("slow_step", 5) == {"seconds": 0.5}
        assert faults.pull("sigterm", 25) is None
        assert faults.pull("page_exhaustion", 1) == {}

    def test_scenario_restores_registry(self):
        outer = faults.inject("nan_grads", step=99)
        with faults.scenario(("dispatch_error", {"count": 1})):
            assert faults.armed("dispatch_error")
            assert not faults.armed("nan_grads")
        assert not faults.armed("dispatch_error")
        assert faults.armed("nan_grads") and outer.fired == 0

    def test_nan_scale_seam(self):
        assert faults.nan_scale(1) == 1.0
        faults.inject("nan_grads", step=2)
        assert np.isnan(faults.nan_scale(2))


# -- retry ----------------------------------------------------------------

class TestRetry:
    def test_transient_grammar(self):
        assert is_transient(TransientError("boom"))
        assert is_transient(RuntimeError("RESOURCE_EXHAUSTED: oom"))
        assert is_transient(RuntimeError("backend UNAVAILABLE"))
        assert not is_transient(RuntimeError("shape mismatch"))
        assert not is_transient(ValueError("RESOURCE_EXHAUSTED"))

    def test_retries_then_succeeds(self):
        calls = []
        stats = RetryStats()

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise TransientError("RESOURCE_EXHAUSTED: injected")
            return "ok"

        assert call_with_retries(flaky, retries=3, base_delay=0.001,
                                 stats=stats) == "ok"
        assert len(calls) == 3 and stats.retries == 2

    def test_gives_up_and_reraises(self):
        stats = RetryStats()
        with pytest.raises(TransientError):
            call_with_retries(
                lambda: (_ for _ in ()).throw(TransientError("x")),
                retries=1, base_delay=0.001, stats=stats)
        assert stats.gave_up == 1

    def test_non_transient_propagates_immediately(self):
        calls = []

        def bad():
            calls.append(1)
            raise ValueError("nope")

        with pytest.raises(ValueError):
            call_with_retries(bad, retries=5, base_delay=0.001)
        assert len(calls) == 1


# -- train guard ----------------------------------------------------------

def _ref_net(seed=0):
    paddle.seed(seed)
    return paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.Tanh(),
                                paddle.nn.Linear(16, 4))


def _state(net):
    return {k: np.asarray(v._value) for k, v in net.state_dict().items()}


def _port_net(state):
    net = pt.nn.Sequential(pt.nn.Linear(8, 16, device="cpu"),
                           torch.nn.Tanh(), pt.nn.Linear(16, 4, device="cpu"))
    return load_numpy_state(net, state)


def _engines(guards=(None, None), seed=0):
    """(JAX Engine, port Engine) from one set of weights, AdamW(1e-2)."""
    jnet = _ref_net(seed)
    jopt = paddle.optimizer.AdamW(1e-2, parameters=jnet.parameters())
    jeng = JaxEngine(jnet, loss=paddle.nn.CrossEntropyLoss(),
                     optimizer=jopt, guard=guards[0])
    pnet = _port_net(_state(jnet))
    peng = Engine(pnet, loss=pt.nn.CrossEntropyLoss(),
                  optimizer=AdamW(1e-2, parameters=pnet.named_parameters()),
                  guard=guards[1])
    return jeng, peng


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((8, 8)).astype("float32"),
             rng.integers(0, 4, (8,)).astype("int64")) for _ in range(n)]


def _guards(**kw):
    """(reference guard, port guard) of the same settings; ``scaler``: the
    GradScaler keywords, or None."""
    sk = kw.pop("scaler", None)
    return (JaxTrainGuard(**kw, scaler=None if sk is None
                          else JaxGradScaler(**sk)),
            TrainGuard(**kw, scaler=None if sk is None else GradScaler(**sk)))


def _both(inject, run):
    """run(fault module, package index) on each package, each with
    ``inject(faults)`` armed first."""
    out = []
    for i, f in enumerate((jax_faults, faults)):
        f.clear()
        inject(f)
        out.append(run(f, i))
    return out


def _losses(eng, batches):
    return [float(np.asarray(eng.train_batch([x], [y])[0]))
            for x, y in batches]


def _same_guard(jg, pg):
    assert jg.stats() == pg.stats()
    assert jg.log_scalars() == pg.log_scalars()
    assert jg.last_outcome == pg.last_outcome


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=_TOL, atol=1e-7)
    assert [np.isnan(v) for v in got] == [np.isnan(v) for v in want]


class TestTrainGuard:
    BAD = (5, 6, 7)  # 1-indexed steps hit by the injected NaN storm

    def test_nan_storm_skip_rollback_loss_continuity(self):
        """Under a 3-step NaN storm the guard skips and rolls back, and the
        surviving losses match a run that never saw those batches; both
        packages under the same guard agree step by step."""
        batches = _batches(12)
        _, golden_eng = _engines()
        golden = _losses(golden_eng, [b for i, b in enumerate(batches)
                                      if i + 1 not in self.BAD])
        guards = _guards(snapshot_every=1, rollback_after=3)
        jeng, peng = _engines(guards)
        ref, got = _both(
            lambda f: f.inject("nan_grads", step=self.BAD[0],
                               count=len(self.BAD)),
            lambda f, i: _losses((jeng, peng)[i], batches))
        assert all(np.isnan(got[s - 1]) for s in self.BAD)
        _close([v for i, v in enumerate(got) if i + 1 not in self.BAD],
               golden)
        _close(got, ref)
        jg, pg = guards
        assert (pg.skipped_steps, pg.rollbacks, pg.good_steps) == (3, 1, 9)
        _same_guard(jg, pg)
        assert peng._opt_step == jeng._opt_step == 9

    def test_rollback_restores_update_counter(self):
        guard = TrainGuard(snapshot_every=1, rollback_after=1)
        _, eng = _engines((None, guard))
        (x, y), = _batches(1)
        eng.train_batch([x], [y])
        opt_step_before = eng._opt_step
        faults.inject("nan_grads", step=2)
        eng.train_batch([x], [y])
        assert eng._opt_step == opt_step_before
        assert guard.rollbacks == 1

    def test_rollback_copies_in_place(self):
        """A rollback writes the snapshot into the live tensors: the same
        data_ptrs, the snapshot's values bit for bit; the next good step
        updates those tensors."""
        guard = TrainGuard(snapshot_every=2, ring_size=1, rollback_after=2,
                           scaler=GradScaler(init_loss_scaling=256.0,
                                             incr_every_n_steps=3))
        _, eng = _engines((None, guard))
        batches = _batches(8, seed=2)
        for x, y in batches[:4]:
            eng.train_batch([x], [y])

        def live():
            return eng._guard_tensors()
        ptrs = {k: t.data_ptr() for k, t in live().items()}
        snap = {k: t.clone() for k, t in live().items()}
        assert any(k.startswith("slot:") for k in snap)
        assert any(k.startswith("scaler:") for k in snap)
        faults.inject("nan_grads", step=5, count=2)
        eng.train_batch([batches[4][0]], [batches[4][1]])
        # the scale halves; nothing else moves
        assert all(torch.equal(t, snap[k]) for k, t in live().items()
                   if not k.startswith("scaler:")), \
            "a skipped step changed the state"
        assert float(eng._scaler_state["scale"]) == float(
            snap["scaler:scale"]) / 2
        eng.train_batch([batches[5][0]], [batches[5][1]])
        assert guard.rollbacks == 1 and guard.last_outcome == "rolled_back"
        now = live()
        assert {k: t.data_ptr() for k, t in now.items()} == ptrs
        # the snapshot is step 4's; the storm's halvings are undone
        assert all(torch.equal(t, snap[k]) for k, t in now.items())
        eng.train_batch([batches[6][0]], [batches[6][1]])
        assert {k: t.data_ptr() for k, t in live().items()} == ptrs
        assert not torch.equal(live()["param:0.weight"],
                               snap["param:0.weight"])

    def test_dispatch_error_retried(self):
        guards = _guards(snapshot_every=10, retries=2,
                         retry_base_delay=0.001)
        jeng, peng = _engines(guards)
        (x, y), = _batches(1)
        ref, got = _both(lambda f: f.inject("dispatch_error", count=2),
                         lambda f, i: _losses((jeng, peng)[i], [(x, y)]))
        assert np.isfinite(got[0])
        _close(got, ref)
        assert guards[1].retry_stats.retries == 2
        assert not faults.armed("dispatch_error")
        _same_guard(*guards)

    def test_retry_budget_exhausted_raises(self):
        guard = TrainGuard(retries=1, retry_base_delay=0.001)
        _, eng = _engines((None, guard))
        (x, y), = _batches(1)
        faults.inject("dispatch_error", count=5)
        with pytest.raises(TransientError):
            eng.train_batch([x], [y])
        assert guard.retry_stats.gave_up == 1
        assert eng._opt_step == 0

    def test_scaler_composition(self):
        """GradScaler rides the guarded step: a found-inf halves the scale
        in the step and the host counters track it, as in the
        reference."""
        guards = _guards(snapshot_every=5, rollback_after=5,
                         scaler=dict(init_loss_scaling=1024.0,
                                     incr_every_n_steps=10_000))
        jeng, peng = _engines(guards)
        ref, got = _both(lambda f: f.inject("nan_grads", step=2),
                         lambda f, i: _losses((jeng, peng)[i],
                                              _batches(4, seed=3)))
        _close(got, ref)
        scaler = guards[1].scaler
        assert scaler.found_inf_count == 1 and scaler.skip_count == 1
        assert float(peng._scaler_state["scale"]) == 512.0 == float(
            np.asarray(jeng._scaler_state["scale"]))
        _same_guard(*guards)

    def test_scale_trajectory_matches_reference(self):
        """The scale over a run with growth, a storm and a rollback that
        restores the snapshot's scaler state, step by step against the
        reference's in-step state."""
        guards = _guards(snapshot_every=3, ring_size=1, rollback_after=3,
                         scaler=dict(init_loss_scaling=65536.0,
                                     incr_every_n_steps=2))
        jeng, peng = _engines(guards)
        batches = _batches(12, seed=4)

        def run(f, i):
            eng = (jeng, peng)[i]
            out = []
            for x, y in batches:
                loss = float(np.asarray(eng.train_batch([x], [y])[0]))
                st = eng._scaler_state
                out.append((loss, float(np.asarray(st["scale"])),
                            int(np.asarray(st["good"])),
                            int(np.asarray(st["bad"])), eng._opt_step))
            return out
        ref, got = _both(lambda f: f.inject("nan_grads", step=6, count=3),
                         run)
        _close([r[0] for r in got], [r[0] for r in ref])
        assert [r[1:] for r in got] == [r[1:] for r in ref]
        assert guards[1].rollbacks == 1
        _same_guard(*guards)

    def test_rollback_restores_lr_schedule(self):
        """A rollback that rewinds opt_step rewinds the LR scheduler with
        it, through Model.fit, and the losses match the skip-equivalent
        run and the reference's guarded run."""
        def build(pkg, guard=None):
            if pkg == "jax":
                net = _ref_net(0)
                model = paddle.Model(net)
                sched = paddle.optimizer.lr.StepDecay(0.05, step_size=2,
                                                      gamma=0.5)
                model.prepare(paddle.optimizer.AdamW(
                    sched, parameters=net.parameters()),
                    paddle.nn.CrossEntropyLoss(), guard=guard)
            else:
                net = _port_net(_state(_ref_net(0)))
                model = pt.Model(net)
                sched = pt.optimizer.lr.StepDecay(0.05, step_size=2,
                                                  gamma=0.5)
                model.prepare(AdamW(sched,
                                    parameters=net.named_parameters()),
                              pt.nn.CrossEntropyLoss(), guard=guard)
            return model, sched

        rng = np.random.default_rng(7)
        X = rng.standard_normal((48, 8)).astype("float32")
        Y = rng.integers(0, 4, (48,)).astype("int64")
        bad = (3, 4, 5)
        keep = [i for i in range(12) if i + 1 not in bad]
        Xg = np.concatenate([X[i * 4:(i + 1) * 4] for i in keep])
        Yg = np.concatenate([Y[i * 4:(i + 1) * 4] for i in keep])
        kw = dict(epochs=1, batch_size=4, verbose=0, shuffle=False)

        def fit(pkg, model, x, y):
            cb_mod = paddle.callbacks if pkg == "jax" else pt.callbacks
            io = paddle.io if pkg == "jax" else pt.io
            seen = []

            class Rec(cb_mod.Callback):
                def on_train_batch_end(self, s, logs=None):
                    seen.append(float(logs["loss"][0]))
            model.fit(io.TensorDataset([x, y]), callbacks=[Rec()], **kw)
            return seen

        golden_model, golden_sched = build("port")
        gl = fit("port", golden_model, Xg, Yg)
        guards = _guards(snapshot_every=1, rollback_after=3)
        runs = {}
        for i, (pkg, f) in enumerate((("jax", jax_faults),
                                      ("port", faults))):
            model, sched = build(pkg, guards[i])
            f.inject("nan_grads", step=bad[0], count=len(bad))
            runs[pkg] = (fit(pkg, model, X, Y), sched)
        il, sched = runs["port"]
        assert guards[1].rollbacks == 1
        _close([v for i, v in enumerate(il) if i + 1 not in bad], gl)
        _close(il, runs["jax"][0])
        assert float(sched()) == float(golden_sched()) == float(
            runs["jax"][1]())
        assert sched.last_epoch == runs["jax"][1].last_epoch
        _same_guard(*guards)

    def test_guard_refuses_accumulation_paths(self):
        _, eng = _engines((None, TrainGuard()))
        (x, y), = _batches(1)
        with pytest.raises(ValueError, match="TrainGuard"):
            eng.train_batch_accum([x], [y], apply_update=True)
        with pytest.raises(ValueError, match="TrainGuard"):
            eng.train_batch_multi([x[None]], [y[None]])

    def test_guard_swap_resets_scaler_state(self):
        s1 = GradScaler(init_loss_scaling=1024.0)
        _, eng = _engines((None, TrainGuard(scaler=s1, snapshot_every=10)))
        (x, y), = _batches(1)
        faults.inject("nan_grads", step=1)
        eng.train_batch([x], [y])
        assert float(eng._scaler_state["scale"]) == 512.0
        eng.guard = TrainGuard(scaler=GradScaler(init_loss_scaling=256.0),
                               snapshot_every=10)
        eng.train_batch([x], [y])
        assert float(eng._scaler_state["scale"]) == 256.0

    def test_detach_via_assignment(self):
        _, eng = _engines((None, TrainGuard(snapshot_every=10)))
        (x, y), = _batches(1)
        eng.train_batch([x], [y])
        eng.guard = None
        loss, _ = eng.train_batch([x], [y])
        assert np.isfinite(float(loss))
        eng.attach_guard(TrainGuard())
        loss, _ = eng.train_batch([x], [y])
        assert np.isfinite(float(loss))
        assert eng._opt_step == 3

    def test_eager_unscale_then_step_divides_once(self):
        """unscale_() then step() divides by the loss scale once
        (Momentum with momentum 0 at lr 1 is the reference's SGD)."""
        net = pt.nn.Linear(4, 4, device="cpu")
        opt = Momentum(learning_rate=1.0, momentum=0.0,
                       parameters=net.named_parameters())
        scaler = GradScaler(init_loss_scaling=1024.0)
        x = torch.ones(2, 4)
        scaler.scale(net(x).sum()).backward()
        w0 = net.weight.detach().clone()
        scaler.unscale_(opt)
        g = net.weight.grad.clone()
        scaler.step(opt)
        torch.testing.assert_close(w0 - net.weight.detach(), g, rtol=1e-5,
                                   atol=0)
        torch.testing.assert_close(g, torch.full_like(g, 2.0))
        assert scaler.skip_count == 0

    def test_fit_logs_guard_scalars(self):
        net = _port_net(_state(_ref_net(0)))
        model = pt.Model(net)
        scaler = GradScaler(init_loss_scaling=256.0)
        model.prepare(AdamW(1e-2, parameters=net.named_parameters()),
                      pt.nn.CrossEntropyLoss(),
                      guard=TrainGuard(snapshot_every=2, rollback_after=4,
                                       scaler=scaler))
        rng = np.random.default_rng(0)
        X = rng.standard_normal((16, 8)).astype("float32")
        Y = rng.integers(0, 4, (16,)).astype("int64")
        seen = {}

        class Rec(pt.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                seen.update(logs or {})

        faults.inject("nan_grads", step=2)
        model.fit(pt.io.TensorDataset([X, Y]), epochs=1, batch_size=4,
                  verbose=0, shuffle=False, callbacks=[Rec()])
        assert seen["skipped"] == 1
        assert seen["found_inf"] == 1
        assert seen["rollbacks"] == 0

    def test_load_clears_the_ring(self, tmp_path):
        net = _port_net(_state(_ref_net(0)))
        model = pt.Model(net)
        guard = TrainGuard(snapshot_every=1)
        model.prepare(AdamW(1e-2, parameters=net.named_parameters()),
                      pt.nn.CrossEntropyLoss(), guard=guard)
        (x, y), = _batches(1)
        model.train_batch([x], [y])
        assert guard.ring
        model.save(str(tmp_path / "m"))
        model.load(str(tmp_path / "m"))
        assert not guard.ring


class _HostReads(TorchDispatchMode):
    READS = ("aten::_local_scalar_dense", "aten::nonzero",
             "aten::masked_select")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name in self.READS:
            self.seen.append(func._schema.name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("clip", [False, True])
def test_guarded_step_reads_one_value(clip):
    """The one host read a guarded step adds is its finite flag: a plain
    step reads nothing back, a guarded one (GradScaler, clip, grad-norm
    telemetry on) exactly one value."""
    net = _port_net(_state(_ref_net(0)))
    opt = AdamW(1e-2, parameters=net.named_parameters(), fused_kernel=True,
                grad_clip=pt.nn.ClipGradByGlobalNorm(1.0) if clip else None)
    eng = Engine(net, loss=pt.nn.CrossEntropyLoss(), optimizer=opt)
    eng.enable_grad_norm()
    (x, y), = _batches(1)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    eng.train_batch([x], [y])
    with _HostReads() as mode:
        eng.train_batch([x], [y])
    assert mode.seen == []
    eng.attach_guard(TrainGuard(snapshot_every=100,
                                scaler=GradScaler(init_loss_scaling=1024.0)))
    eng.train_batch([x], [y])
    with _HostReads() as mode:
        eng.train_batch([x], [y])
    assert mode.seen == ["aten::_local_scalar_dense"]
    assert eng.last_grad_norm is not None and eng._opt_step == 4


class _BNNet(torch.nn.Module):
    """A Linear, a BatchNorm (its running statistics written by every
    training forward) and a Linear."""

    def __init__(self):
        super().__init__()
        self.fc1 = pt.nn.Linear(8, 16, device="cpu")
        self.bn = pt.nn.BatchNorm2D(16, device="cpu")
        self.fc2 = pt.nn.Linear(16, 4, device="cpu")

    def forward(self, x):
        h = self.bn(self.fc1(x)[:, :, None, None])
        return self.fc2(torch.tanh(h[:, :, 0, 0]))


@pytest.mark.parametrize("opt", ["momentum", "adamw-plain", "master",
                                 "bf16-moments", "amsgrad", "adamw-fused"])
def test_bad_step_leaves_every_plain_path_bit_for_bit(opt):
    """The masked update on each path: a bad step leaves every parameter,
    optimizer slot and BatchNorm statistic bit for bit; the next good step
    moves them."""
    torch.manual_seed(0)
    net = _BNNet()
    named = net.named_parameters()
    make = {
        "momentum": lambda: Momentum(0.1, momentum=0.9, parameters=named),
        "adamw-plain": lambda: AdamW(1e-2, parameters=named),
        "master": lambda: AdamW(1e-2, parameters=named,
                                multi_precision=True),
        "bf16-moments": lambda: AdamW(1e-2, parameters=named,
                                      moment_dtype="bfloat16"),
        "amsgrad": lambda: AdamW(1e-2, parameters=named, amsgrad=True),
        "adamw-fused": lambda: AdamW(1e-2, parameters=named,
                                     fused_kernel=True),
    }[opt]
    eng = Engine(net, loss=pt.nn.CrossEntropyLoss(), optimizer=make(),
                 guard=TrainGuard(snapshot_every=100, scaler=GradScaler(
                     init_loss_scaling=256.0)))
    batches = _batches(3, seed=6)
    eng.train_batch([batches[0][0]], [batches[0][1]])

    def state():
        return {k: t.clone() for k, t in eng._guard_tensors().items()
                if not k.startswith("scaler:")}
    before = state()
    assert any(k.startswith("buffer:") for k in before)
    faults.inject("nan_grads", step=2)
    eng.train_batch([batches[1][0]], [batches[1][1]])
    assert eng.guard.last_outcome == "skipped"
    assert all(torch.equal(t, before[k]) for k, t in state().items())
    eng.train_batch([batches[2][0]], [batches[2][1]])
    after = state()
    assert eng.guard.last_outcome == "ok"
    for k, t in after.items():
        if k.startswith(("param:", "buffer:bn._mean")):
            assert not torch.equal(t, before[k]), k
