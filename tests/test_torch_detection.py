"""The detection models of the PyTorch port vs the JAX package.

The reference's weights cross into the port through numpy
(``nlp.convert.load_numpy_state``, strictly, key for key), with every
BatchNorm's statistics and affine parameters, every bias and every
LayerNorm parameter drawn at random from a numpy seed (at 0/1 a folded or
skipped affine step would not show), and both sides get the same numpy
inputs. Checked on the CPU:

- ``box_utils``, every function, on boxes hypothesis draws: within 1e-6
  of max(1, |reference|);
- ``sine_position_embedding``: exactly the reference's; ``F.sigmoid``,
  ``F.hardsigmoid``, ``F.interpolate`` (nearest, integer factors, NCHW
  and NHWC) and the ``Silu``/``Sigmoid``/``Hardsigmoid`` layers within
  1e-6;
- DETR with the ``tiny`` and ``resnet18`` backbones at d_model 64 over 2
  heads (head_dim 32, DETR's own) in eval and in train mode (dropout 0),
  each backbone's reference built once for both: whole models within 1e-4
  of max(1, |reference|);
- ``multiclass_nms``: the same detections, in the same order, bit for
  bit.

The training losses, the assigner and the matcher are held in
test_torch_detection_train.py; PP-YOLOE's forwards and the training steps
in test_torch_detection_steps.py, beside the other tests of its
reference (whose eager build takes most of a minute).
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jax_nn
from paddle_tpu.vision.models import detection as jax_det
from paddle_tpu_torch import nn as port_nn
from paddle_tpu_torch import seed
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.vision.models import detection as port_det
from tests.conftest import jit_forward
from tests.test_torch_resnet import _randomized_state
from torch_threads import one_torch_thread  # noqa: F401

MODEL_TOL = 1e-4


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


def _images(b=2, hw=64, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, hw, hw)).astype(np.float32)


# -- box utilities ---------------------------------------------------------------

def _boxes(n):
    coord = st.floats(-50.0, 150.0, allow_nan=False, width=32)
    return st.lists(st.tuples(coord, coord, coord, coord), min_size=n,
                    max_size=n).map(lambda r: np.asarray(r, np.float32))


@settings(max_examples=40, deadline=None)
@given(a=_boxes(5), b=_boxes(7))
def test_box_utils_match(a, b):
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for name in ("cxcywh_to_xyxy", "xyxy_to_cxcywh", "box_area"):
        _close(getattr(port_det, name)(ta), getattr(jax_det, name)(ja),
               1e-6, name)
    for name in ("pairwise_iou",):
        for got, want in zip(port_det.pairwise_iou(ta, tb),
                             jax_det.pairwise_iou(ja, jb)):
            _close(got, want, 1e-6, name)
    _close(port_det.pairwise_giou(ta, tb), jax_det.pairwise_giou(ja, jb),
           1e-6, "pairwise_giou")
    _close(port_det.elementwise_giou(ta, tb[:5]),
           jax_det.elementwise_giou(ja, jb[:5]), 1e-6, "elementwise_giou")


@pytest.mark.parametrize("hwd", [(25, 42, 256), (4, 4, 64), (3, 7, 32)])
def test_sine_position_embedding_is_the_reference(hwd):
    got = port_det.sine_position_embedding(*hwd)
    want = np.asarray(jax_det.sine_position_embedding(*hwd))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


FUNCTIONAL = {
    "sigmoid": ("sigmoid", {}),
    "hardsigmoid": ("hardsigmoid", {}),
    "interpolate_x2": ("interpolate", dict(scale_factor=2)),
    "interpolate_x3x2": ("interpolate", dict(scale_factor=[3, 2])),
    "interpolate_x2_nhwc": ("interpolate",
                            dict(scale_factor=2, data_format="NHWC")),
    "Silu": ("Silu", None),
    "Sigmoid": ("Sigmoid", None),
    "Hardsigmoid": ("Hardsigmoid", None),
}


@pytest.mark.parametrize("case", sorted(FUNCTIONAL))
def test_activations_and_interpolate_match(case):
    name, kw = FUNCTIONAL[case]
    x = 4 * np.random.default_rng(2).standard_normal((2, 3, 5, 4)).astype(
        np.float32)
    if kw is None:
        want = getattr(jax_nn, name)()(paddle.to_tensor(x))
        got = getattr(port_nn, name)()(torch.from_numpy(x))
    else:
        want = getattr(jax_nn.functional, name)(paddle.to_tensor(x), **kw)
        got = getattr(port_nn.functional, name)(torch.from_numpy(x), **kw)
    _close(got, want, 1e-6, case)


# -- DETR ----------------------------------------------------------------------

def _detr_cfg(backbone):
    return dict(num_classes=4, num_queries=10, d_model=64, nhead=2,
                num_encoder_layers=2, num_decoder_layers=2,
                dim_feedforward=96, backbone=backbone, dropout=0.0)


@pytest.fixture(scope="module")
def detr_refs():
    """backbone -> (the reference DETR, its randomised state), each built
    once for the eval and the train case."""
    refs = {}

    def get(backbone):
        if backbone not in refs:
            paddle.seed(0)
            jm = jax_det.DETR(**_detr_cfg(backbone))
            refs[backbone] = jm, _randomized_state(jm, 0)
        return refs[backbone]
    return get


def _detr(ref, backbone, train):
    """(the reference DETR, reset to its randomised state; a port DETR
    carrying that state), both in train or eval mode."""
    jm, state = ref
    jm.set_state_dict(state)
    pm = port_det.DETR(**_detr_cfg(backbone), device="cpu",
                       generator=seed(0, device="cpu"))
    load_numpy_state(pm, state)
    for m in (jm, pm):
        m.train() if train else m.eval()
    return jm, pm


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("backbone", ["tiny", "resnet18"])
def test_detr_matches(detr_refs, backbone, train):
    jm, pm = _detr(detr_refs(backbone), backbone, train)
    assert pm.transformer.encoder.layers[0].self_attn.head_dim == 32
    x = _images()
    jout = (jm(paddle.to_tensor(x)) if train
            else jit_forward(jm, jnp.asarray(x)))
    with torch.set_grad_enabled(train):
        pout = pm(torch.from_numpy(x))
    names = ("logits", "boxes") if train else ("boxes", "probs")
    for name, got, want in zip(names, pout, jout):
        _close(got, want, MODEL_TOL, name)
    if not train:
        assert tuple(pout[1].shape) == (2, 10, 5)
        assert float(pout[0].max()) <= 64.0 + 1e-3


# -- multiclass_nms ----------------------------------------------------------------

@pytest.mark.parametrize("thresh", [(0.05, 0.6), (0.3, 0.3)])
def test_multiclass_nms_lists_are_identical(thresh):
    rng = np.random.default_rng(3)
    ctr = rng.uniform(0, 64, (300, 2))
    wh = rng.uniform(2, 20, (300, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(
        np.float32)
    scores = rng.uniform(0, 1, (300, 5)).astype(np.float32)
    want = jax_det.multiclass_nms(boxes, scores, *thresh)
    got = port_det.multiclass_nms(torch.from_numpy(boxes),
                                  torch.from_numpy(scores), *thresh)
    assert len(got) == len(want) == 100
    for (gc, gs, gb), (wc, ws, wb) in zip(got, want):
        assert gc == wc and gs == ws and np.array_equal(gb, wb)
