"""ResNet and its layers in the PyTorch port vs the JAX package.

The reference's weights cross into the port through numpy
(``nlp.convert.load_numpy_state``, strictly, key for key), with the
BatchNorm statistics and affine parameters drawn at random from a numpy
seed: at their initial values (mean 0, variance 1, gamma 1, beta 0) a
folded BatchNorm is the identity times rsqrt(1 + eps) and would hide a
wrong fold. Checked on the CPU:

- ``Conv2D`` in NCHW/OIHW and NHWC/HWIO, with stride, padding (int, list,
  2n list, 'SAME', 'VALID'), dilation, groups and bias; ``BatchNorm2D`` in
  eval, and in training with the running-statistics update;
  ``MaxPool2D`` (ceil mode, 'SAME') and ``AdaptiveAvgPool2D`` — f32
  within 1e-5 of max(1, |reference|);
- ``BasicBlock``, and a fused ``BottleneckBlock`` in eval (its 1x1 chains
  through ``fused_conv1x1_bn_act``, the reference's through the Pallas
  kernel in interpret mode), f32 within 1e-5 and bf16 within 1e-2 of
  max(1, |reference|);
- ``resnet50`` at full depth, batch 2 x 3 x 64 x 64, NCHW plain and NHWC
  with the fused bottleneck, against the reference's same configurations:
  logits within 1e-5 of the reference's max-abs (f32; 50 layers of convs
  summed in another order by oneDNN than by XLA, measured ~1e-6), argmax
  equal, and every one of the 32 bottleneck 1x1 chains through the fused
  route on contiguous views;
- a bf16 reference state of the whole model loads bit for bit;
- the parts not ported raise NotImplementedError naming ROADMAP.md queue 1
  item 6 (Conv1D/3D, the transposed convolutions, ``return_mask``),
  ``pretrained=True`` raises as the reference's does, and
  ``layout="auto"`` resolves NCHW for a model on the CPU;
- ``resnet50`` fused NHWC in training at 2 x 3 x 48 x 48: logits within
  1e-3 and running statistics within 1e-4 (BatchNorm over 8 rows at
  layer4; see the test), and the 17 fused chains of a training forward
  against the reference's 7 ``_fwd_call`` launches;
- ``summary`` and ``flops`` of ``resnet50`` equal to the reference's.

The tests of the whole resnet50 share a module: the reference's eager
build compiles each initializer's shape once in a process (most of a
minute). The fused blocks in training, the Engine steps and ``s2d_stem``
are held in tests/test_torch_resnet_train.py and
tests/test_torch_resnet_steps.py.
"""
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu import nn as jax_nn
from paddle_tpu.nn.layers_conv import to_channels_last as jax_channels_last
from paddle_tpu.ops.pallas import conv_bn_act as pallas_cba
from paddle_tpu.vision.models import resnet as jax_resnet
from paddle_tpu_torch import nn as port_nn
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.nn import functional as port_F
from paddle_tpu_torch.ops.kernels import conv_bn_act as port_cba
from paddle_tpu_torch.vision.models import resnet as port_resnet
from torch_threads import one_torch_thread  # noqa: F401


def _np(t):
    return np.asarray(jnp.asarray(t._value if hasattr(t, "_value") else t,
                                  jnp.float32))


def _close(got, want, tol=1e-5, what=""):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    want = _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scaled = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert scaled.max() <= tol, (what, scaled.max())


def _randomized_state(jm, seed):
    """The reference module's state as numpy, with every BatchNorm's
    statistics and affine parameters (and any bias) drawn at random; set
    back into the reference so both sides carry it."""
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in jm.state_dict().items():
        a = np.asarray(v._value, np.float32)
        if k.endswith("_variance"):
            a = rng.uniform(0.5, 1.5, a.shape)
        elif k.endswith(("_mean", "bias")):
            a = 0.1 * rng.standard_normal(a.shape)
        elif a.ndim == 1:  # a BatchNorm weight
            a = 1.0 + 0.1 * rng.standard_normal(a.shape)
        state[k] = a.astype(np.float32)
    jm.set_state_dict(state)
    return state


def _carry(jm, pm, seed=0):
    load_numpy_state(pm, _randomized_state(jm, seed))
    return pm


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- layers --------------------------------------------------------------------

CONV_CASES = {
    "k3s2p1g2": dict(kernel_size=3, stride=2, padding=1, groups=2),
    "same_s2_d2": dict(kernel_size=3, stride=2, padding="SAME", dilation=2),
    "valid": dict(kernel_size=3, padding="VALID"),
    "pad_list": dict(kernel_size=(3, 5), padding=[1, 2]),
    "pad_2n": dict(kernel_size=3, stride=(1, 2), padding=[1, 0, 2, 1]),
    "1x1_bias": dict(kernel_size=1, bias_attr=None),
}


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_matches_the_reference(case, layout):
    kw = dict(CONV_CASES[case])
    kw.setdefault("bias_attr", False)
    paddle.seed(0)
    jm = jax_nn.Conv2D(4, 6, **kw)
    pm = port_nn.Conv2D(4, 6, device="cpu", **kw)
    if layout == "NHWC":
        jm.to_channels_last()
        pm.to_channels_last()
        assert pm.weight.shape == tuple(jm.weight.shape)
        assert pm._data_format == "NHWC" and pm._weight_format == "HWIO"
    _carry(jm, pm)
    x = _x((2, 4, 9, 11))
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    want = jm(paddle.to_tensor(x))
    got = pm(torch.from_numpy(x))
    _close(got, want, what=case)
    if layout == "NHWC":
        assert got.is_contiguous()


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("training", [False, True])
def test_batch_norm_matches_the_reference(layout, training):
    jm = jax_nn.BatchNorm2D(5, momentum=0.8, data_format=layout)
    pm = port_nn.BatchNorm2D(5, momentum=0.8, data_format=layout,
                             device="cpu")
    _carry(jm, pm, seed=2)
    shape = (3, 5, 4, 6) if layout == "NCHW" else (3, 4, 6, 5)
    x = _x(shape) * 2 + 0.3
    if training:
        jm.train()
        pm.train()
    else:
        jm.eval()
        pm.eval()
    _close(pm(torch.from_numpy(x)), jm(paddle.to_tensor(x)), what="y")
    _close(pm._mean, jm._mean, what="running mean")
    _close(pm._variance, jm._variance, what="running variance")
    if training:
        assert not np.allclose(_np(jm._mean), 0.0)


def test_batch_norm_keeps_f32_statistics_under_bf16():
    bn = port_nn.BatchNorm2D(4, device="cpu", dtype=torch.bfloat16)
    assert bn.weight.dtype == torch.bfloat16
    assert bn._mean.dtype == bn._variance.dtype == torch.float32


POOL_CASES = {
    "max_k3s2p1": ("max", dict(kernel_size=3, stride=2, padding=1)),
    "max_k2": ("max", dict(kernel_size=2)),
    "max_ceil": ("max", dict(kernel_size=3, stride=2, ceil_mode=True)),
    "max_same": ("max", dict(kernel_size=3, stride=2, padding="SAME")),
    "avg_1x1": ("adaptive", dict(output_size=(1, 1))),
    "avg_3x4": ("adaptive", dict(output_size=(3, 4))),
}


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pools_match_the_reference(case, layout):
    kind, kw = POOL_CASES[case]
    if kind == "max":
        jm = jax_nn.MaxPool2D(data_format=layout, **kw)
        pm = port_nn.MaxPool2D(data_format=layout, **kw)
    else:
        jm = jax_nn.AdaptiveAvgPool2D(data_format=layout, **kw)
        pm = port_nn.AdaptiveAvgPool2D(data_format=layout, **kw)
    x = _x((2, 3, 7, 9))
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    _close(pm(torch.from_numpy(x)), jm(paddle.to_tensor(x)), what=case)


def test_to_channels_last_converts_a_tree_as_the_reference():
    def tree(nn_mod, **kw):
        return nn_mod.Sequential(
            nn_mod.Conv2D(3, 8, 3, padding=1, bias_attr=False, **kw),
            nn_mod.BatchNorm2D(8, **kw), nn_mod.ReLU(),
            nn_mod.MaxPool2D(2), nn_mod.AdaptiveAvgPool2D(1))
    paddle.seed(0)
    jm = tree(jax_nn)
    pm = tree(port_nn, device="cpu")
    _carry(jm, pm)
    assert jax_channels_last(jm)[1] == port_nn.to_channels_last(pm)[1] == 4
    assert port_nn.to_channels_last(pm)[1] == 2  # only the pools re-count
    x = np.ascontiguousarray(_x((2, 3, 8, 8)).transpose(0, 2, 3, 1))
    _close(pm(torch.from_numpy(x)), jm(paddle.to_tensor(x)))


# -- blocks -------------------------------------------------------------------

def test_basic_block_matches_the_reference():
    paddle.seed(0)
    jm = jax_resnet.BasicBlock(16, 16)
    pm = port_resnet.BasicBlock(16, 16, device="cpu")
    _carry(jm, pm)
    jm.eval()
    pm.eval()
    x = _x((2, 16, 6, 6))
    _close(pm(torch.from_numpy(x)), jm(paddle.to_tensor(x)))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_fused_bottleneck_matches_the_reference(dtype, tol, monkeypatch):
    """512 -> 128 -> 512 at M = 2 x 4 x 4: both 1x1 chains of the
    reference reach the Pallas kernel (interpret mode)."""
    paddle.seed(0)
    jm = jax_resnet.BottleneckBlock(512, 128)
    pm = port_resnet.BottleneckBlock(512, 128, device="cpu")
    jax_channels_last(jm)
    port_nn.to_channels_last(pm)
    jm._fused = pm._fused = True
    _carry(jm, pm, seed=3)
    jm.eval()
    pm.eval()
    if dtype == "bfloat16":
        jm.to(dtype="bfloat16")
        pm.to(torch.bfloat16)
    reached = []
    real = pallas_cba._fwd_call
    monkeypatch.setattr(pallas_cba, "_fwd_call",
                        lambda *a: reached.append(1) or real(*a))
    port_calls = []
    real_port = port_resnet.fused_conv1x1_bn_act
    monkeypatch.setattr(port_resnet, "fused_conv1x1_bn_act",
                        lambda *a: port_calls.append(a) or real_port(*a))
    x = np.ascontiguousarray(_x((2, 512, 4, 4)).transpose(0, 2, 3, 1))
    want = jm(paddle.to_tensor(jnp.asarray(x, dtype)))
    got = pm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert len(reached) == 2 and len(port_calls) == 2
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, tol=tol)


def test_unfusable_chain_runs_the_plain_ops():
    """A bottleneck on OIHW weights never takes the fused route."""
    pm = port_resnet.BottleneckBlock(64, 16, device="cpu").eval()
    pm._fused = True
    assert pm._forward_fused(torch.zeros(1, 64, 4, 4)) is None
    port_nn.to_channels_last(pm)
    conv = pm.conv1
    conv._stride = (2, 2)
    assert port_resnet._fused_conv1x1_bn(
        torch.zeros(1, 4, 4, 64), conv, pm.bn1) is None


# -- the whole ResNet-50 ------------------------------------------------------

@pytest.fixture(scope="module")
def reference_resnet50():
    """The reference resnet50 (seed 0) with random BatchNorm statistics:
    its NCHW state and logits, then, converted in place to NHWC with the
    fused bottleneck, its NHWC state, logits and the number of
    ``_fwd_call`` launches."""
    paddle.seed(0)
    jm = jax_resnet.resnet50(layout="NCHW")
    jm.eval()
    state = _randomized_state(jm, seed=4)
    x = _x((2, 3, 64, 64), seed=5)
    out = dict(x=x, nchw_state=state,
               nchw=_np(jm(paddle.to_tensor(x))))
    jm.convert_to_nhwc()
    jm._arm_fused_bottleneck()
    calls = []
    real = pallas_cba._fwd_call
    pallas_cba._fwd_call = lambda *a: calls.append(1) or real(*a)
    try:
        out["nhwc"] = _np(jm(paddle.to_tensor(x)))
    finally:
        pallas_cba._fwd_call = real
    out["pallas_calls"] = len(calls)
    out["nhwc_state"] = {k: np.asarray(v._value)
                         for k, v in jm.state_dict().items()}
    jm.to(dtype="bfloat16")  # as bench.py's serve path casts the model
    out["bf16_state"] = {k: np.asarray(v._value)
                         for k, v in jm.state_dict().items()}
    return out


def _logits_close(got, want, tol=1e-5):
    got = got.detach().float().numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_resnet50_nchw_matches_the_reference(reference_resnet50):
    ref = reference_resnet50
    assert len(ref["nchw_state"]) == 267
    pm = port_resnet.resnet50(layout="NCHW", device="cpu").eval()
    load_numpy_state(pm, ref["nchw_state"])
    with torch.no_grad():
        _logits_close(pm(torch.from_numpy(ref["x"])), ref["nchw"])


def test_resnet50_fused_nhwc_matches_the_reference(reference_resnet50,
                                                   monkeypatch):
    ref = reference_resnet50
    # the reference's layer1 convs miss its Cin % 128 rule: 26 of 32
    assert ref["pallas_calls"] == 26
    pm = port_resnet.resnet50(layout="NHWC", fused_bottleneck=True,
                              device="cpu").eval()
    assert pm.layer1[0].conv1.weight.shape == (1, 1, 64, 64)
    load_numpy_state(pm, ref["nhwc_state"])
    views = []
    real = port_resnet.fused_conv1x1_bn_act

    def spy(x2, w, scale, shift, r2, relu):
        views.append(x2._base is not None and w._base is not None
                     and (r2 is None or r2._base is not None))
        return real(x2, w, scale, shift, r2, relu)
    monkeypatch.setattr(port_resnet, "fused_conv1x1_bn_act", spy)
    with torch.no_grad():
        _logits_close(pm(torch.from_numpy(ref["x"])), ref["nhwc"])
    assert len(views) == 32 and all(views), views


def test_resnet50_converted_in_place_matches_the_fused_model(
        reference_resnet50):
    """An NCHW port model loaded from the NCHW state, then converted to
    NHWC and armed, gives the fused reference's logits."""
    ref = reference_resnet50
    pm = port_resnet.resnet50(layout="NCHW", device="cpu").eval()
    load_numpy_state(pm, ref["nchw_state"])
    pm.convert_to_nhwc()._arm_fused_bottleneck()
    for k, v in pm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref["nhwc_state"][k],
                                      err_msg=k)
    with torch.no_grad():
        _logits_close(pm(torch.from_numpy(ref["x"])), ref["nhwc"])


def test_resnet50_bf16_state_loads_bit_for_bit(reference_resnet50):
    """A bf16 reference state (conv kernels HWIO, BatchNorm buffers
    included, all ``ml_dtypes.bfloat16``) loads into a bf16 port model
    bit for bit."""
    state = reference_resnet50["bf16_state"]
    assert {a.dtype.name for a in state.values()} == {"bfloat16"}
    pm = port_resnet.resnet50(layout="NHWC", fused_bottleneck=True,
                              device="cpu").to(torch.bfloat16)
    load_numpy_state(pm, state)
    own = pm.state_dict()
    assert len(own) == 267
    for k, v in own.items():
        assert v.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(v.view(torch.int16).numpy(),
                                      state[k].view(np.int16), err_msg=k)


# -- what raises ----------------------------------------------------------------

# -- resnet50 in training -----------------------------------------------------

def test_resnet50_train_forward_matches_the_reference(monkeypatch):
    """Fused NHWC resnet50 (8 classes) at 2 x 3 x 48 x 48, training: 48 px
    keeps layer4 at 2 x 2 so the batch statistics are well conditioned."""
    paddle.seed(0)
    jm = jax_resnet.resnet50(num_classes=8, layout="NHWC",
                             fused_bottleneck=True)
    state = _randomized_state(jm, seed=5)
    pm = port_resnet.resnet50(num_classes=8, layout="NHWC",
                              fused_bottleneck=True, device="cpu")
    load_numpy_state(pm, state)
    jm.train()
    pm.train()
    reached = []
    real = pallas_cba._fwd_call
    monkeypatch.setattr(pallas_cba, "_fwd_call",
                        lambda *a: reached.append(1) or real(*a))
    x = _x((2, 3, 48, 48), seed=6)
    want = jm(paddle.to_tensor(x))
    port_cba.fused_conv1x1_bn_act.launches = 0
    calls = []
    real_port = port_resnet.fused_conv1x1_bn_act
    monkeypatch.setattr(port_resnet, "fused_conv1x1_bn_act",
                        lambda *a: calls.append(1) or real_port(*a))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    # layer1.0's conv1 (64 -> 64) and the sixteen conv3s. The reference
    # sends 10 of them to jnp (its _supported and _pick_block_m): layer1's
    # four (Cin = 64) and layer3's six (M = 2 x 3 x 3 = 18 rows, not a
    # multiple of 8)
    assert len(calls) == 17 and len(reached) == 7
    assert port_cba.fused_conv1x1_bn_act.launches == 0  # the CPU twin
    # BatchNorm over 8 rows at layer4 magnifies f32 reduction order: at
    # this input each package's logits sit 3e-4 to 7e-4 of max(1, |x|) from
    # a float64 run (measured: the reference fused 6.3e-4, the port fused
    # 3.4e-4, both unfused ~1.7e-4), and the reference's own test holds its
    # two layouts to 2e-3 of the max-abs here; the running statistics take
    # the training-step bar of 1e-4 (layer4.2.bn3's variance: 1.3e-5)
    _close(got, want, tol=1e-3, what="logits")
    for k in ("bn1", "layer2.0.bn3", "layer4.2.bn3"):
        for stat in ("_mean", "_variance"):
            mod_p, mod_j = pm, jm
            for part in k.split("."):
                mod_p = getattr(mod_p, part) if not part.isdigit() \
                    else mod_p[int(part)]
                mod_j = getattr(mod_j, part) if not part.isdigit() \
                    else mod_j[int(part)]
            _close(getattr(mod_p, stat), getattr(mod_j, stat), tol=1e-4,
                   what=f"{k}.{stat}")


def test_summary_and_flops_resnet50(capsys):
    paddle.seed(0)
    jnet = jax_resnet.resnet50()
    pnet = port_resnet.resnet50(device="cpu",
                                generator=pt.seed(0, device="cpu"))
    size = (1, 3, 64, 64)
    want = paddle.summary(jnet, size)
    got = pt.summary(pnet, size)
    capsys.readouterr()
    assert got == want
    assert got["total_params"] == 25557032
    assert pt.flops(pnet, list(size)) == paddle.flops(jnet, list(size))


def test_the_parts_not_ported_raise():
    item6 = "queue 1 item 6"
    # pretrained=True needs a download, which the reference refuses too;
    # a checkpoint path loads (tests/test_torch_zoo.py)
    with pytest.raises(NotImplementedError, match="download"):
        port_resnet.resnet50(pretrained=True, device="cpu")
    for name in ("Conv1D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
                 "Conv3DTranspose"):
        cls = getattr(importlib.import_module(
            "paddle_tpu_torch.nn.layers_conv"), name)
        with pytest.raises(NotImplementedError, match=item6):
            cls(4, 4, 3)
    with pytest.raises(NotImplementedError, match=item6):
        port_F.max_pool2d(torch.zeros(1, 1, 4, 4), 2, return_mask=True)


def test_layout_auto_and_the_fused_route_need_nhwc(monkeypatch):
    assert port_resnet._resolve_layout("auto", "cpu") == "NCHW"
    assert port_resnet._resolve_layout("auto", "cuda") == "NHWC"
    m = port_resnet.resnet18(device="cpu")
    assert m._layout == "NCHW" and m.conv1._weight_format == "OIHW"
    with pytest.raises(ValueError, match="NHWC"):
        port_resnet.resnet50(fused_bottleneck=True, device="cpu")
    with pytest.raises(ValueError, match="layout"):
        port_resnet.resnet50(layout="NCWH", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        port_resnet.resnet50()
