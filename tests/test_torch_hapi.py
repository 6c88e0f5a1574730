"""The port's high-level API (``paddle_tpu_torch.Model``, metrics,
callbacks, ``summary``/``flops``, ``save``/``load``) vs the JAX package's.

Weights cross from the reference through numpy (``load_numpy_state``);
data is the same numpy arrays. On the CPU:

- metrics: ``Accuracy`` (top-k, numpy and torch inputs), ``Precision``,
  ``Recall``, ``Auc`` and ``accuracy`` equal the reference's exactly;
- ``Model.fit`` of LeNet from the same weights (Adam 1e-3, shuffle=False,
  2 epochs of a 512-image MNIST subset at batch 64): per-batch losses
  within 1e-5 relative, the parameters within 1e-5 (2 * lr where Adam's
  second moment says every gradient of the element was below 1e-6), then
  ``evaluate`` (acc exactly, loss within 1e-5) and ``predict`` stacked
  (within 1e-5);
- ``Model.fit`` of a small fused-bottleneck ResNet equals the port's own
  ``Engine.train_batch`` sequence bit for bit, and its BatchNorm running
  statistics move;
- files: a ``.pdparams`` crosses both ways (``evaluate`` gives the same
  loss after the crossing), a ``.pdopt`` resumes (the next step of a saved
  and reloaded run equals an uninterrupted run's, within the port and
  across packages both ways), bf16 arrays and nested objects round-trip,
  the pickled skeleton names no class of the JAX package, a plain pickle
  raises naming ROADMAP.md queue 1 item 11;
- callbacks: EarlyStopping stops, ModelCheckpoint writes at
  ``save_freq``, the LR scheduler steps once a batch as the reference's,
  ReduceLROnPlateau cuts the rate, ProgBarLogger prints, and the item-8
  callbacks raise naming their item;
- ``summary`` and ``flops`` totals for LeNet equal the reference's
  (resnet50's are held in tests/test_torch_resnet.py, beside the other
  tests of the reference resnet50);
- the parts not ported raise naming their ROADMAP.md items.
"""
import os
import pickle
import pickletools

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.hapi.callbacks as rcb
import paddle_tpu.metric as rmetric
import paddle_tpu_torch as pt
import paddle_tpu_torch.hapi.callbacks as pcb
import paddle_tpu_torch.metric as pmetric
from paddle_tpu.vision.datasets import MNIST as JaxMNIST
from paddle_tpu.vision.models import LeNet as JaxLeNet
from paddle_tpu_torch.hapi import Engine
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.optimizer import Adam, Momentum
from paddle_tpu_torch.vision.datasets import MNIST
from paddle_tpu_torch.vision.models import LeNet
from paddle_tpu_torch.vision.models.resnet import BottleneckBlock, ResNet
from torch_threads import one_torch_thread  # noqa: F401

LR = 1e-3


def _jnp(t):
    return np.asarray(t._value if hasattr(t, "_value") else t)


def _ref_state(jm):
    return {k: _jnp(v) for k, v in jm.state_dict().items()}


# -- metrics ------------------------------------------------------------------

def _scores(b=64, c=7, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, c)).astype(np.float32),
            rng.integers(0, c, (b, 1)).astype(np.int64))


@pytest.mark.parametrize("topk", [(1,), (1, 5), 3])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_accuracy_matches(topk, as_tensor):
    pm, rm = pmetric.Accuracy(topk=topk), rmetric.Accuracy(topk=topk)
    for seed in range(3):
        p, lab = _scores(seed=seed)
        lab_in = lab if seed % 2 else lab[:, 0]
        got = pm.update(pm.compute(torch.from_numpy(p) if as_tensor else p,
                                   lab_in))
        want = rm.update(rm.compute(paddle.to_tensor(p),
                                    paddle.to_tensor(lab_in)))
        assert got == want
    assert pm.accumulate() == rm.accumulate()
    assert pm.name() == rm.name()
    pm.reset()
    assert pm.accumulate() == (0.0 if len(pm.topk) == 1
                               else [0.0] * len(pm.topk))


def test_accuracy_compute_stays_on_the_device():
    p, lab = _scores()
    c = pmetric.Accuracy(topk=(1, 2)).compute(torch.from_numpy(p),
                                              torch.from_numpy(lab))
    assert torch.is_tensor(c) and c.shape == (64, 2)
    want = _jnp(rmetric.Accuracy(topk=(1, 2)).compute(
        paddle.to_tensor(p), paddle.to_tensor(lab)))
    np.testing.assert_array_equal(c.numpy(), want)


@pytest.mark.parametrize("cls", ["Precision", "Recall", "Auc"])
def test_binary_metrics_match(cls):
    pm, rm = getattr(pmetric, cls)(), getattr(rmetric, cls)()
    rng = np.random.default_rng(5)
    for _ in range(3):
        preds = rng.random(40).astype(np.float32)
        labs = rng.integers(0, 2, 40)
        pm.update(torch.from_numpy(preds), labs)
        rm.update(paddle.to_tensor(preds), paddle.to_tensor(labs))
    assert pm.accumulate() == rm.accumulate()
    assert pm.name() == rm.name()
    if cls == "Auc":  # [N, 2] scores read the positive column
        two = rng.random((10, 2)).astype(np.float32)
        labs = rng.integers(0, 2, 10)
        a, b = pmetric.Auc(), rmetric.Auc()
        a.update(torch.from_numpy(two), labs)
        b.update(paddle.to_tensor(two), paddle.to_tensor(labs))
        assert a.accumulate() == b.accumulate()


def test_accuracy_function_matches():
    p, lab = _scores(seed=9)
    for k in (1, 3):
        got = pmetric.accuracy(torch.from_numpy(p), lab, k=k)
        want = rmetric.accuracy(paddle.to_tensor(p), paddle.to_tensor(lab),
                                k=k)
        assert float(got) == float(_jnp(want))


# -- Model.fit of LeNet against the reference --------------------------------

class _RefLosses(rcb.Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"][0])


class _PortLosses(pcb.Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"][0])


def _lenet_pair(seed=0, metrics=True):
    paddle.seed(seed)
    jnet = JaxLeNet()
    jm = paddle.Model(jnet)
    jm.prepare(paddle.optimizer.Adam(LR, parameters=jnet.parameters()),
               paddle.nn.CrossEntropyLoss(),
               rmetric.Accuracy() if metrics else None)
    pnet = LeNet(device="cpu")
    load_numpy_state(pnet, _ref_state(jnet))
    pm = pt.Model(pnet)
    pm.prepare(Adam(LR, parameters=pnet.parameters()),
               pt.nn.CrossEntropyLoss(),
               pmetric.Accuracy() if metrics else None)
    return jm, pm


def _subset(mod, ds, n):
    return mod.Subset(ds, list(range(n)))


def _params_close(pm, jm, tol=1e-5):
    """Parameters within tol; where Adam's second moment says every
    gradient of an element stayed below 1e-6 (the update is a step
    function of g near eps there), within 2 * lr."""
    ref = _ref_state(jm.network)
    opt = pm._optimizer
    bc2 = 1.0 - 0.999 ** pm._engine._opt_step
    worst = 0.0
    for n, p in pm.network.named_parameters():
        diff = np.abs(p.detach().numpy() - ref[n])
        steep = np.sqrt(opt._state[n]["v"].numpy() / bc2) < 1e-6
        if (~steep).any():
            worst = max(worst, float(diff[~steep].max()))
        if steep.any():
            assert diff[steep].max() <= 2 * LR, n
    assert worst <= tol, worst


@pytest.fixture(scope="module")
def lenet_fit():
    import paddle_tpu.io as rio
    import paddle_tpu_torch.io as pio
    jm, pm = _lenet_pair()
    jdata = _subset(rio, JaxMNIST(mode="train"), 512)
    pdata = _subset(pio, MNIST(mode="train"), 512)
    rl, pl = _RefLosses(), _PortLosses()
    jm.fit(jdata, epochs=2, batch_size=64, shuffle=False, verbose=0,
           callbacks=[rl])
    pm.fit(pdata, epochs=2, batch_size=64, shuffle=False, verbose=0,
           callbacks=[pl])
    return jm, pm, rl.losses, pl.losses


def test_fit_losses_match(lenet_fit):
    jm, pm, rl, pl = lenet_fit
    assert len(pl) == len(rl) == 16
    rel = np.abs(np.array(pl) - np.array(rl)) / np.abs(np.array(rl))
    assert rel.max() <= 1e-5, rel.max()
    assert all(isinstance(x, float) for x in pl)
    assert pm._engine._step == pm._engine._opt_step == 16


def test_fit_params_match(lenet_fit):
    jm, pm, _, _ = lenet_fit
    _params_close(pm, jm)


def test_evaluate_and_predict_match(lenet_fit):
    jm, pm, _, _ = lenet_fit
    jtest, ptest = JaxMNIST(mode="test"), MNIST(mode="test")
    want = jm.evaluate(jtest, batch_size=128, verbose=0)
    got = pm.evaluate(ptest, batch_size=128, verbose=0)
    assert got["acc"] == want["acc"]
    assert abs(got["loss"][0] - want["loss"][0]) <= 1e-5
    pp = pm.predict(ptest, batch_size=300, stack_outputs=True)
    jp = jm.predict(jtest, batch_size=300, stack_outputs=True)
    assert pp[0].shape == (1000, 10)
    np.testing.assert_allclose(pp[0], np.asarray(jp[0]), rtol=0, atol=1e-5)
    unstacked = pm.predict(ptest, batch_size=300)
    assert [a.shape[0] for a in unstacked[0]] == [300, 300, 300, 100]


def test_train_and_eval_batch_return_floats():
    _, pm = _lenet_pair(metrics=True)
    x = np.random.default_rng(0).random((8, 1, 28, 28)).astype(np.float32)
    y = np.arange(8, dtype=np.int64)
    loss, metrics = pm.train_batch([x], [y])
    assert isinstance(loss[0], float) and len(metrics) == 1
    loss, _ = pm.eval_batch([x], [y])
    assert isinstance(loss[0], float)
    out = pm.predict_batch([x])
    assert isinstance(out, np.ndarray) and out.shape == (8, 10)
    _, bare = _lenet_pair(metrics=False)
    out = bare.train_batch(x, y)  # no metrics: the loss list alone
    assert isinstance(out, list) and len(out) == 1
    assert isinstance(out[0], float)


# -- Model.fit of a fused ResNet against the port's own Engine -----------------

def _small_resnet(seed):
    return ResNet(BottleneckBlock, 18, num_classes=10, layout="NHWC",
                  fused_bottleneck=True, device="cpu",
                  generator=pt.seed(seed, device="cpu")).train()


def test_fit_equals_engine_steps_fused_resnet():
    rng = np.random.default_rng(8)
    xs = rng.standard_normal((12, 3, 32, 32)).astype(np.float32)
    ys = rng.integers(0, 10, 12).astype(np.int64)
    a, b = _small_resnet(1), _small_resnet(2)
    b.load_state_dict(a.state_dict())
    stats0 = {k: v.clone() for k, v in a.named_buffers()}
    model = pt.Model(a)
    model.prepare(Momentum(0.1, momentum=0.9), pt.nn.CrossEntropyLoss())
    losses = _PortLosses()
    model.fit(pt.io.TensorDataset([xs, ys]), batch_size=4, epochs=2,
              shuffle=False, verbose=0, callbacks=[losses])
    eng = Engine(b, pt.nn.CrossEntropyLoss(), Momentum(0.1, momentum=0.9))
    direct = [eng.train_batch([xs[i:i + 4]], [ys[i:i + 4]])[0].item()
              for _ in range(2) for i in range(0, 12, 4)]
    assert losses.losses == direct
    for (n, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), n
    moved = [k for k, v in a.named_buffers() if not torch.equal(v,
                                                                stats0[k])]
    assert len(moved) == len(stats0) > 0


def test_amp_configs_map_to_the_engine():
    for cfg, want in (("O1", torch.bfloat16), ("O2", torch.bfloat16),
                      ("O0", None), ({"level": "O1", "dtype": "float16"},
                                     torch.float16),
                      ({"level": "O0"}, None), (None, None)):
        m = pt.Model(LeNet(device="cpu"))
        m.prepare(Adam(LR), pt.nn.CrossEntropyLoss(), amp_configs=cfg)
        assert m._engine.amp_dtype == want, cfg


# -- files ---------------------------------------------------------------------

def test_pdparams_crosses_both_ways(tmp_path, lenet_fit):
    jm, pm, _, _ = lenet_fit
    jtest, ptest = JaxMNIST(mode="test"), MNIST(mode="test")
    # reference -> port
    jm.save(str(tmp_path / "ref"))
    fresh = pt.Model(LeNet(device="cpu"))
    fresh.prepare(Adam(LR), pt.nn.CrossEntropyLoss(), pmetric.Accuracy())
    fresh.load(str(tmp_path / "ref"))
    want = jm.evaluate(jtest, batch_size=250, verbose=0)
    got = fresh.evaluate(ptest, batch_size=250, verbose=0)
    assert abs(got["loss"][0] - want["loss"][0]) <= 1e-5
    assert got["acc"] == want["acc"]
    # port -> reference
    pm.save(str(tmp_path / "port"))
    paddle.seed(11)
    jnet = JaxLeNet()
    back = paddle.Model(jnet)
    back.prepare(paddle.optimizer.Adam(LR, parameters=jnet.parameters()),
                 paddle.nn.CrossEntropyLoss(), rmetric.Accuracy())
    back.load(str(tmp_path / "port"))
    want = pm.evaluate(ptest, batch_size=250, verbose=0)
    got = back.evaluate(jtest, batch_size=250, verbose=0)
    assert abs(got["loss"][0] - want["loss"][0]) <= 1e-5
    assert got["acc"] == want["acc"]
    assert back._engine._step == pm._engine._step


def _batches(n=4, b=32, seed=12):
    rng = np.random.default_rng(seed)
    return [(rng.random((b, 1, 28, 28)).astype(np.float32),
             rng.integers(0, 10, b).astype(np.int64)) for _ in range(n)]


def _port_lenet_model(state, lr):
    net = LeNet(device="cpu")
    load_numpy_state(net, state)
    m = pt.Model(net)
    m.prepare(Adam(lr, parameters=net.parameters()),
              pt.nn.CrossEntropyLoss())
    return m


def _ref_lenet_model(state, lr):
    jnet = JaxLeNet()
    jnet.set_state_dict(state)
    m = paddle.Model(jnet)
    m.prepare(paddle.optimizer.Adam(lr, parameters=jnet.parameters()),
              paddle.nn.CrossEntropyLoss())
    return m


def _step_size():
    return pt.optimizer.lr.StepDecay(LR, step_size=2, gamma=0.5)


def test_pdopt_resumes_within_the_port(tmp_path):
    paddle.seed(21)
    state = _ref_state(JaxLeNet())
    data = _batches()
    whole = _port_lenet_model(state, _step_size())
    for x, y in data:
        last = whole.train_batch([x], [y])[0]
    first = _port_lenet_model(state, _step_size())
    for x, y in data[:3]:
        first.train_batch([x], [y])
    first.save(str(tmp_path / "run"))
    resumed = _port_lenet_model(_ref_state(JaxLeNet()), _step_size())
    resumed.load(str(tmp_path / "run"))
    assert resumed._engine._step == resumed._engine._opt_step == 3
    assert resumed._optimizer._lr.last_epoch == 3
    assert resumed.train_batch([data[3][0]], [data[3][1]])[0] == last
    for (n, a), b in zip(whole.network.state_dict().items(),
                         resumed.network.state_dict().values()):
        assert torch.equal(a, b), n
    for n, st in whole._optimizer._state.items():
        for k, t in st.items():
            assert torch.equal(t, resumed._optimizer._state[n][k]), (n, k)


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_pdopt_crosses(tmp_path, direction):
    """Three steps in one package, saved; the next step in the other
    package after load equals the first package's own next step."""
    paddle.seed(22)
    state = _ref_state(JaxLeNet())
    data = _batches(seed=13)
    ref_lr = lambda: paddle.optimizer.lr.StepDecay(  # noqa: E731
        LR, step_size=2, gamma=0.5)
    if direction == "ref_to_port":
        src = _ref_lenet_model(state, ref_lr())
        dst = _port_lenet_model(state, _step_size())
    else:
        src = _port_lenet_model(state, _step_size())
        dst = _ref_lenet_model(state, ref_lr())
    for x, y in data[:3]:
        src.train_batch([x], [y])
    src.save(str(tmp_path / "run"))
    dst.load(str(tmp_path / "run"))
    want = src.train_batch([data[3][0]], [data[3][1]])[0]
    got = dst.train_batch([data[3][0]], [data[3][1]])[0]
    assert abs(got - want) <= 1e-5 * abs(want)
    port, ref = (dst, src) if direction == "ref_to_port" else (src, dst)
    assert port._engine._opt_step == ref._engine._opt_step == 4
    assert port._optimizer._lr.last_epoch == ref._optimizer._lr.last_epoch
    _params_close(port, ref)


def test_pdopt_leaves_in_the_reference_order(tmp_path):
    paddle.seed(23)
    m = _port_lenet_model(_ref_state(JaxLeNet()), LR)
    x, y = _batches(1)[0]
    m.train_batch([x], [y])
    m.save(str(tmp_path / "o"))
    blob = pt.load(str(tmp_path / "o.pdopt"))
    names = sorted(n for n, _ in m.network.named_parameters())
    want = [m._optimizer._state[n][s] for s in ("m", "v") for n in names]
    assert len(blob["leaves"]) == len(want) == 20
    for a, b in zip(blob["leaves"], want):
        assert torch.equal(a, b)
    assert blob["engine_step"] == blob["opt_step"] == 1
    other = _port_lenet_model(_ref_state(JaxLeNet()), LR)
    pt.save({"engine_step": 1, "opt_step": 1,
             "leaves": blob["leaves"][:3]}, str(tmp_path / "bad.pdopt"))
    m.save(str(tmp_path / "bad"))
    pt.save({"engine_step": 1, "opt_step": 1,
             "leaves": blob["leaves"][:3]}, str(tmp_path / "bad.pdopt"))
    with pytest.raises(ValueError, match="3 leaves"):
        other.load(str(tmp_path / "bad"))


def test_save_load_roundtrip_objects(tmp_path):
    obj = {"a": torch.tensor([1.0, 2.0]), "b": [torch.tensor([3]),
                                                {"c": 4.5}],
           "d": "hello", "e": (1, 2), "n": np.arange(3, dtype=np.int32),
           "h": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}
    p = str(tmp_path / "blob.pd")
    pt.save(obj, p)
    back = pt.load(p)
    assert torch.equal(back["a"], obj["a"]) and back["b"][1]["c"] == 4.5
    assert back["d"] == "hello" and back["e"] == (1, 2)
    assert isinstance(back["n"], np.ndarray) and back["n"].dtype == np.int32
    assert back["h"].dtype == torch.bfloat16 and torch.equal(back["h"],
                                                             obj["h"])
    # the reference reads the port's file, bf16 included, and back
    ref = paddle.load(p)
    np.testing.assert_array_equal(_jnp(ref["a"]), [1.0, 2.0])
    np.testing.assert_array_equal(np.asarray(_jnp(ref["h"]), np.float32),
                                  [1.5, -2.25])
    q = str(tmp_path / "ref.pd")
    paddle.save({"w": paddle.to_tensor(np.array([0.5, 3.0], np.float32))
                 .astype("bfloat16"), "x": ref["a"]}, q)
    both = pt.load(q)
    assert both["w"].dtype == torch.bfloat16
    assert both["w"].float().tolist() == [0.5, 3.0]
    assert pt.load(q, return_numpy=True)["x"].tolist() == [1.0, 2.0]


def test_skeleton_names_no_reference_class(tmp_path):
    jm, _ = _lenet_pair()
    jm._optimizer._lr = paddle.optimizer.lr.StepDecay(LR, step_size=2)
    x, y = _batches(1)[0]
    jm.train_batch([x], [y])
    jm.save(str(tmp_path / "r"))
    for ext in (".pdparams", ".pdopt"):
        body = open(str(tmp_path / ("r" + ext)), "rb").read()[6:]
        skel = body[:body.index(b"\n__NPZ__\n")]
        globals_ = [arg for op, arg, _ in pickletools.genops(skel)
                    if op.name in ("GLOBAL", "STACK_GLOBAL")]
        assert not any("paddle_tpu" in str(g) or "jax" in str(g)
                       for g in globals_), globals_
    # a skeleton that names one is refused, not imported
    bad = str(tmp_path / "bad.pd")
    with open(bad, "wb") as f:
        f.write(b"PTPU1\n" + pickle.dumps({"__leaf__": rcb.Callback})
                + b"\n__NPZ__\n")
        import io
        buf = io.BytesIO()
        np.savez(buf)
        f.write(buf.getvalue())
    with pytest.raises(pickle.UnpicklingError, match="never imports"):
        pt.load(bad)


def test_plain_pickle_names_item_11(tmp_path):
    p = str(tmp_path / "legacy.pdparams")
    with open(p, "wb") as f:
        pickle.dump({"w": np.zeros(2)}, f, protocol=2)
    with pytest.raises(NotImplementedError, match="item 11"):
        pt.load(p)
    with open(p, "wb") as f:
        f.write(b"garbage")
    with pytest.raises(ValueError, match="not a paddle_tpu checkpoint"):
        pt.load(p)


def test_load_into_and_mismatch(tmp_path):
    net = LeNet(device="cpu")
    p = str(tmp_path / "w.pdparams")
    pt.save(net.state_dict(), p)
    other = LeNet(device="cpu")
    assert pt.serialization.load_into(other, p) == ([], [])
    assert all(torch.equal(a, b) for a, b in
               zip(net.state_dict().values(), other.state_dict().values()))
    pt.save({k: v for k, v in net.state_dict().items()
             if not k.startswith("fc.2")}, p)
    with pytest.raises(ValueError, match="refusing a partial load"):
        pt.serialization.load_into(other, p)
    assert pt.serialization.load_into(other, p, strict=False)[0] == \
        ["fc.2.weight", "fc.2.bias"]
    pt.save({"fc.2.bias": torch.zeros(3)}, p)
    with pytest.raises(ValueError, match="shape mismatch"):
        pt.serialization.load_into(other, p, strict=False)


# -- callbacks ---------------------------------------------------------------

def _tiny(seed=0, n=64):
    rng = np.random.default_rng(seed)
    xs = rng.random((n, 1, 28, 28)).astype(np.float32)
    ys = rng.integers(0, 10, n).astype(np.int64)
    return pt.io.TensorDataset([xs, ys])


def _tiny_model(lr=LR):
    net = LeNet(device="cpu", generator=pt.seed(0, device="cpu"))
    m = pt.Model(net)
    m.prepare(Adam(lr, parameters=net.parameters()),
              pt.nn.CrossEntropyLoss(), pmetric.Accuracy())
    return m


def test_early_stopping_stops():
    m = _tiny_model()
    es = pcb.EarlyStopping(monitor="loss", patience=0, min_delta=1e9)
    m.fit(_tiny(), eval_data=_tiny(1, 32), epochs=5, batch_size=16,
          verbose=0, callbacks=[es])
    # the first eval sets the best, the second is not better by 1e9
    assert m.stop_training and m._engine._step == 2 * 4


def test_model_checkpoint_writes_at_save_freq(tmp_path):
    m = _tiny_model()
    m.fit(_tiny(), epochs=3, batch_size=32, verbose=0,
          save_dir=str(tmp_path), save_freq=2)
    names = sorted(os.listdir(tmp_path))
    assert names == ["0.pdopt", "0.pdparams", "2.pdopt", "2.pdparams",
                     "final.pdopt", "final.pdparams"]


def test_lr_scheduler_steps_each_batch():
    m = _tiny_model(pt.optimizer.lr.StepDecay(0.01, step_size=3,
                                               gamma=0.5))
    seen = []

    class Rec(pcb.Callback):
        def on_train_batch_begin(self, step, logs=None):
            seen.append(m._optimizer.get_lr())

    m.fit(_tiny(), epochs=2, batch_size=16, verbose=0, callbacks=[Rec()])
    ref = paddle.optimizer.lr.StepDecay(0.01, step_size=3, gamma=0.5)
    want = []
    for _ in range(8):
        want.append(ref())
        ref.step()
    assert seen == want and m._optimizer._lr.last_epoch == 8
    # by_epoch steps once an epoch instead
    m2 = _tiny_model(pt.optimizer.lr.StepDecay(0.01, step_size=1))
    m2._lr_step_after_update = lambda: None
    m2.fit(_tiny(), epochs=3, batch_size=32, verbose=0,
           callbacks=[pcb.LRScheduler(by_step=False, by_epoch=True)])
    assert m2._optimizer._lr.last_epoch == 3


def test_reduce_lr_on_plateau_and_progbar(capsys):
    m = _tiny_model(0.01)
    cb = pcb.ReduceLROnPlateau(monitor="loss", patience=0, factor=0.5,
                               min_delta=1e9)
    m.fit(_tiny(), eval_data=_tiny(2, 16), epochs=3, batch_size=32,
          verbose=2, log_freq=1, callbacks=[cb])
    assert m._optimizer._lr == pytest.approx(0.01 * 0.5 ** 2)
    out = capsys.readouterr().out
    assert "Epoch 1/3 step 0 - loss:" in out and "acc:" in out
    assert "Epoch 3/3 done" in out


@pytest.mark.parametrize("name", ["VisualDL", "WandbCallback",
                                  "PreemptionCheckpoint",
                                  "TelemetryCallback"])
def test_item_8_callbacks_raise(name):
    assert name in rcb.__all__ and name in pcb.__all__
    with pytest.raises(NotImplementedError, match="item 8"):
        getattr(pcb, name)()


def test_preemption_flag_stops_fit():
    from paddle_tpu_torch.resilience import preemption
    m = _tiny_model()

    class Preempt(pcb.Callback):
        def on_train_batch_end(self, step, logs=None):
            if step == 1:
                preemption.request()

    m.fit(_tiny(), epochs=3, batch_size=16, verbose=0,
          callbacks=[Preempt()])
    assert m._engine._step == 2 and not preemption.requested()
    preemption.install()
    assert preemption.installed()
    preemption.uninstall()
    assert not preemption.installed()
    with pytest.raises(NotImplementedError, match="item 8"):
        preemption.save_training_state(m, None)
    with pytest.raises(NotImplementedError, match="item 8"):
        preemption.restore_training_state(m, None)


# -- summary and flops ---------------------------------------------------------

def test_summary_and_flops_lenet(capsys):
    paddle.seed(0)
    jnet = JaxLeNet()
    pnet = LeNet(device="cpu")
    want = paddle.summary(jnet, (1, 1, 28, 28))
    ref_out = capsys.readouterr().out
    got = pt.summary(pnet, (1, 1, 28, 28))
    out = capsys.readouterr().out
    assert got == want == {"total_params": 61610, "trainable_params": 61610}
    assert out == ref_out  # the same table, row for row
    assert pt.flops(pnet, [4, 1, 28, 28]) == paddle.flops(jnet,
                                                          [4, 1, 28, 28])
    assert pt.Model(pnet).summary((1, 1, 28, 28)) == want


# -- what is not ported ----------------------------------------------------------

def test_not_ported_parts_name_their_items(tmp_path):
    m = _tiny_model()
    # item 1.3 (TrainGuard) is ported: prepare takes a guard
    guard = pt.resilience.TrainGuard()
    m.prepare(Adam(LR), pt.nn.CrossEntropyLoss(), guard=guard)
    assert m._engine.guard is guard
    with pytest.raises(NotImplementedError, match="item 8"):
        m.save(str(tmp_path / "x"), training=False)
    with pytest.raises(NotImplementedError, match="item 8"):
        m.serve_metrics()


def test_exports():
    for name in ("Model", "summary", "flops", "save", "load", "io",
                 "metric", "callbacks", "vision", "nn", "optimizer"):
        assert hasattr(pt, name), name
    assert pt.vision.LeNet is LeNet
    assert pt.callbacks.EarlyStopping is pcb.EarlyStopping
