"""``incubate.fuse_conv_bn`` of the PyTorch port vs the JAX package's.

The reference's weights cross into the port through numpy
(``nlp.convert.load_numpy_state``), with every BatchNorm's statistics and
affine parameters and every bias drawn at random from a numpy seed (at
mean 0, variance 1, gamma 1, beta 0 a fold is the identity times
rsqrt(1 + eps) and would hide a wrong one). Checked on the CPU:

- the number of folded pairs equals the reference's: 53 on ResNet-50 (the
  stem, 16 bottlenecks x 3, 4 downsample Sequentials), 20 on ResNet-18,
  and the small PP-YOLOE's and a Sequential's; no BatchNorm is left;
- folded outputs, f32: within 1e-5 of max(1, |reference|) of the JAX
  package's folded model on the same input, and within 1e-4 of the port's
  own unfolded model (the fold rounds the weights once more), in NCHW and
  in NHWC with HWIO kernels (``to_channels_last``);
- a folded fused bottleneck (NHWC) never reaches kernel #11's wrapper:
  its convolutions now carry a bias;
- training mode raises.
"""
import copy

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jax_nn
from paddle_tpu.incubate import fuse_conv_bn as jax_fuse
from paddle_tpu.nn.layers_conv import to_channels_last as jax_channels_last
from paddle_tpu.vision.models import detection as jax_det
from paddle_tpu.vision.models import resnet as jax_resnet
from paddle_tpu_torch import nn as port_nn
from paddle_tpu_torch import seed
from paddle_tpu_torch.incubate import fuse_conv_bn
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.ops.kernels import conv_bn_act as kcba
from paddle_tpu_torch.vision.models import detection as port_det
from paddle_tpu_torch.vision.models import resnet as port_resnet
from tests.conftest import jit_forward
from tests.test_torch_resnet import _randomized_state
from torch_threads import one_torch_thread  # noqa: F401


def _np(t):
    return np.asarray(jnp.asarray(t._value if hasattr(t, "_value") else t,
                                  jnp.float32))


def _close(got, want, tol, what=""):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    want = _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scaled = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert scaled.max() <= tol, (what, scaled.max())


def _sequential(nn_mod, **kw):
    return nn_mod.Sequential(
        nn_mod.Conv2D(3, 8, 3, padding=1, bias_attr=False, **kw),
        nn_mod.BatchNorm2D(8, **kw), nn_mod.ReLU(),
        nn_mod.Conv2D(8, 4, 1, **kw), nn_mod.BatchNorm2D(4, **kw))


_PPYOLOE = dict(num_classes=4, channels=(8, 16, 24, 32, 40))


def _build(kind):
    """(reference, port) of ``kind``, the port carrying the reference's
    randomized state, both in eval mode, NCHW."""
    paddle.seed(0)
    cpu = dict(device="cpu")
    if kind == "sequential":
        jm, pm = _sequential(jax_nn), _sequential(port_nn, **cpu)
    elif kind in ("resnet18", "resnet50"):
        jm = getattr(jax_resnet, kind)(num_classes=10, layout="NCHW")
        pm = getattr(port_resnet, kind)(num_classes=10, layout="NCHW",
                                        generator=seed(0, device="cpu"),
                                        **cpu)
    else:
        jm = jax_det.PPYOLOE(**_PPYOLOE)
        pm = port_det.PPYOLOE(**_PPYOLOE, generator=seed(0, device="cpu"),
                              **cpu)
    load_numpy_state(pm, _randomized_state(jm, 0))
    jm.eval()
    pm.eval()
    return jm, pm


@pytest.fixture(scope="module")
def folded_refs():
    """kind -> (the reference folded in NCHW, its count of folded pairs,
    an unfolded port model carrying the same state): each reference is
    built and folded once, for its count and its NCHW outputs."""
    refs = {}

    def get(kind):
        if kind not in refs:
            jm, pm = _build(kind)
            _, n = jax_fuse(jm)
            refs[kind] = jm, n, copy.deepcopy(pm)
        jm, n, pm = refs[kind]
        return jm, n, copy.deepcopy(pm)
    return get


@pytest.mark.parametrize("kind,want", [("sequential", 2), ("resnet18", 20),
                                       ("resnet50", 53), ("ppyoloe", 65)])
def test_fold_counts_match_the_reference(folded_refs, kind, want):
    _, jn, pm = folded_refs(kind)
    _, pn = fuse_conv_bn(pm)
    assert pn == jn == want
    assert not any(isinstance(m, port_nn.BatchNorm2D) for m in pm.modules())


@pytest.mark.parametrize("kind,layout", [
    ("sequential", "NCHW"), ("sequential", "NHWC"), ("resnet18", "NCHW"),
    ("resnet18", "NHWC"), ("ppyoloe", "NCHW")])
def test_folded_outputs_match(folded_refs, kind, layout):
    if layout == "NCHW":
        jm, _, pm = folded_refs(kind)
    else:  # converted to NHWC before the fold: a reference of its own
        jm, pm = _build(kind)
    hw = 32 if kind == "resnet18" else 16 if kind == "sequential" else 64
    x = np.random.default_rng(1).standard_normal((2, 3, hw, hw)).astype(
        np.float32)
    if layout == "NHWC":
        if kind == "sequential":
            jax_channels_last(jm)
            port_nn.to_channels_last(pm)
            x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
        else:  # the ResNet's forward stays NCHW outside
            jm.convert_to_nhwc()
            pm.convert_to_nhwc()
        first = pm.conv1 if kind == "resnet18" else pm[0]
        assert first._weight_format == "HWIO"
    with torch.no_grad():
        unfolded = pm(torch.from_numpy(x))
        fuse_conv_bn(pm)
        folded = pm(torch.from_numpy(x))
    if layout == "NHWC":
        jax_fuse(jm)
    want = jit_forward(jm, jnp.asarray(x))
    outs = [o if isinstance(o, (tuple, list)) else (o,)
            for o in (folded, want, unfolded)]
    for got, ref, unf in zip(*outs):
        _close(got, ref, 1e-5, "folded vs the reference's folded")
        _close(got, unf.numpy(), 1e-4, "folded vs unfolded")


def test_folded_bottleneck_leaves_the_fused_route(monkeypatch):
    """A fused NHWC bottleneck runs #11's route until its pairs fold; the
    folded convolutions carry a bias, so the route declines and the plain
    convolutions run, with the same output."""
    block = port_resnet.BottleneckBlock(64, 16, device="cpu",
                                        generator=seed(0, device="cpu"))
    port_nn.to_channels_last(block)
    block._fused = True
    block.eval()
    calls = []
    real = port_resnet.fused_conv1x1_bn_act

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(port_resnet, "fused_conv1x1_bn_act", spy)
    x = torch.randn(2, 6, 6, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = block(x)
        assert len(calls) == 2
        _, n = fuse_conv_bn(block)
        got = block(x)
    assert n == 3 and len(calls) == 2
    _close(got, want.numpy(), 1e-4)
    assert kcba.fused_conv1x1_bn_act.launches == 0


def test_training_mode_raises():
    m = _sequential(port_nn, device="cpu").train()
    with pytest.raises(ValueError, match="eval"):
        fuse_conv_bn(m)
