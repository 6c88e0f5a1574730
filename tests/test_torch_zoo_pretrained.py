"""``pretrained`` and the reference's other zoo cases on the PyTorch port.

The reference's ``test_vision_models.py`` cases that need no reference
model: the ``state_dict`` round trip, ``pretrained=True`` raising (it
needs a download, which the reference refuses too) and
``SqueezeNet(version="1_0")`` raising. And ``pretrained=<path>`` for every
factory of the zoo, ResNet's included: a file of the model's state that
the JAX package's ``paddle_tpu.save`` wrote loads, every parameter and
buffer bit for bit; a file missing an entry, or a plain pickle, is
refused; ResNet reads the reference's NCHW/OIHW state and converts to
NHWC and the fused route. A file the reference wrote from its own model
is held to the reference's logits in tests/test_torch_zoo.py.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu_torch.vision import models as PM
from torch_threads import one_torch_thread  # noqa: F401


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_state_dict_roundtrip():
    m = PM.shufflenet_v2_x0_25(num_classes=4, device="cpu",
                               generator=pt.seed(0, device="cpu")).eval()
    x = torch.from_numpy(_x((2, 3, 32, 32), seed=6))
    with torch.no_grad():
        want = m(x)
    sd = {k: v.numpy().copy() for k, v in m.state_dict().items()}
    m2 = PM.shufflenet_v2_x0_25(num_classes=4, device="cpu",
                                generator=pt.seed(123, device="cpu")).eval()
    pt.serialization.set_state_dict(m2, sd)
    with torch.no_grad():
        np.testing.assert_allclose(m2(x).numpy(), want.numpy(), atol=1e-6)


@pytest.mark.parametrize("factory", ["vgg16", "mobilenet_v2", "resnet50",
                                     "densenet121"])
def test_pretrained_true_raises(factory):
    with pytest.raises(NotImplementedError, match="download"):
        getattr(PM, factory)(pretrained=True, device="cpu")


def test_squeezenet_bad_version_raises():
    with pytest.raises(ValueError):
        PM.SqueezeNet(version="1_0", device="cpu")


ZOO_FACTORIES = [
    "vgg11", "vgg13", "vgg16", "vgg19", "alexnet", "squeezenet1_0",
    "squeezenet1_1", "mobilenet_v1", "mobilenet_v2", "mobilenet_v3_small",
    "mobilenet_v3_large", "densenet121", "densenet161", "densenet169",
    "densenet201", "densenet264", "shufflenet_v2_x0_25",
    "shufflenet_v2_x0_33", "shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
    "shufflenet_v2_x1_5", "shufflenet_v2_x2_0", "shufflenet_v2_swish",
    "googlenet", "inception_v3", "resnet18", "resnet50",
]


@pytest.mark.parametrize("factory", ZOO_FACTORIES)
def test_every_factory_loads_a_path(factory, tmp_path):
    """Each factory with pretrained=<a file paddle_tpu.save wrote> loads
    every parameter and buffer of it."""
    built = getattr(PM, factory)(num_classes=10, device="cpu",
                                 generator=pt.seed(1, device="cpu"))
    state = {k: v.numpy() for k, v in built.state_dict().items()}
    path = str(tmp_path / f"{factory}.pdparams")
    paddle.save(state, path)
    loaded = getattr(PM, factory)(pretrained=path, num_classes=10,
                                  device="cpu")
    got = loaded.state_dict()
    assert sorted(got) == sorted(state)
    for k, v in state.items():
        assert np.array_equal(got[k].numpy(), v), k


def test_a_partial_file_is_refused(tmp_path):
    """strict: a file missing one entry raises before anything is
    copied."""
    state = {k: v.numpy() for k, v in PM.shufflenet_v2_x0_25(
        num_classes=10, device="cpu").state_dict().items()}
    path = str(tmp_path / "partial.pdparams")
    paddle.save({k: v for k, v in state.items()
                 if k != "conv1.1._mean"}, path)
    with pytest.raises(ValueError, match="missing"):
        PM.shufflenet_v2_x0_25(pretrained=path, num_classes=10,
                               device="cpu")


def test_a_plain_pickle_is_refused(tmp_path):
    """A reference-framework .pdparams (a plain pickle) raises as
    serialization.load does, naming ROADMAP.md queue 1 item 11."""
    import pickle
    path = str(tmp_path / "plain.pdparams")
    with open(path, "wb") as f:
        pickle.dump({"fc.weight": np.zeros((2, 2), np.float32)}, f)
    with pytest.raises(NotImplementedError, match="item 11"):
        PM.mobilenet_v1(pretrained=path, scale=0.25, device="cpu")


def test_resnet_pretrained_path_into_nhwc(tmp_path):
    """resnet50(pretrained=path) reads the reference's NCHW/OIHW state,
    then converts to the layout asked for: NHWC with the fused route
    gives the NCHW model's logits."""
    ref = PM.resnet50(num_classes=10, device="cpu",
                      generator=pt.seed(2, device="cpu")).eval()
    path = str(tmp_path / "resnet50.pdparams")
    paddle.save({k: v.numpy() for k, v in ref.state_dict().items()}, path)
    m = PM.resnet50(pretrained=path, num_classes=10, layout="NHWC",
                    fused_bottleneck=True, device="cpu").eval()
    assert m._layout == "NHWC" and m.conv1._weight_format == "HWIO"
    x = torch.from_numpy(_x((2, 3, 64, 64), seed=8))
    with torch.no_grad():
        got, want = m(x).numpy(), ref(x).numpy()
    assert (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max() \
        <= 1e-5
