"""Detection training of the PyTorch port vs the JAX package through the
models, on the CPU: tests/test_detection.py's tiny DETR and PP-YOLOE with
the reference's weights (crossed through ``nlp.convert.load_numpy_state``,
every BatchNorm statistic, bias and LayerNorm parameter drawn at random).

- PP-YOLOE in eval (boxes, scores) and train mode (the raw outputs and
  the BatchNorms' updated running statistics): within 1e-4 of max(1,
  |reference|), as test_torch_detection.py holds DETR;
- ``PPYOLOE.forward`` leaves its anchors in ``_last_anchors``, and
  ``PPYOLOECriterion`` over the model's outputs is the reference's loss
  over the same outputs (1e-5);
- three Engine steps with Adam 1e-3 in each package: per-step losses
  within ``STEP_TOL`` relative, and falling;
- ``Model.fit`` of the tiny DETR over a four-field dataset (one input,
  three labels), its loss falling.

The losses, the assigner and the matcher alone are held in
test_torch_detection_train.py. Every PP-YOLOE test of the port against the
reference model is here, over one reference built once a module. Whole models run with dropout 0: the
reference's attention at head_dim 16 or 32 takes its jnp path, whose
dropout draws with ``jax.random``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.hapi.engine import Engine as JaxEngine
from paddle_tpu.tensor import Tensor
from paddle_tpu.vision.models import detection as jax_det
from paddle_tpu.vision.models.detection import ppyoloe as jax_pp
from paddle_tpu_torch import Model, seed
from paddle_tpu_torch.hapi import Engine
from paddle_tpu_torch.hapi.callbacks import Callback
from paddle_tpu_torch.io import Dataset
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.vision.models import detection as port_det
from tests.conftest import jit_forward
from tests.test_torch_detection import MODEL_TOL, _close, _images
from tests.test_torch_detection_train import LOSS_TOL, PPYOLOE_TINY, _np
from tests.test_torch_resnet import _randomized_state

# three Adam steps: the first loss is one forward apart; Adam's first
# update moves each weight by ~lr whatever the gradient's size, so the
# packages' last-bit differences reach the later losses (measured up to
# 6.3e-6 of them)
STEP_TOL = 2e-5


# -- PP-YOLOE's criterion -----------------------------------------------------

@pytest.fixture(scope="module")
def ppyoloe_ref():
    """tests/test_detection.py's tiny PP-YOLOE in the reference and its
    randomised state, built once (the reference's eager build takes ~30 s
    here)."""
    paddle.seed(0)
    jm = jax_det.PPYOLOE(**PPYOLOE_TINY)
    return jm, _randomized_state(jm, 0)


def _ppyoloe_pair(ref):
    """(the reference model, reset to its randomised state; a port model
    carrying that state)."""
    jm, state = ref
    jm.set_state_dict(state)
    pm = port_det.PPYOLOE(**PPYOLOE_TINY, device="cpu",
                          generator=seed(0, device="cpu"))
    load_numpy_state(pm, state)
    return jm, pm


def _ref_gt(b=1):
    """tests/test_detection.py's padded gts (xyxy pixels, one padded)."""
    gb = np.tile(np.array([[[4, 4, 30, 30], [20, 10, 60, 50],
                            [0, 0, 0, 0]]], np.float32), (b, 1, 1))
    gc = np.tile(np.array([[1, 2, 0]], np.int64), (b, 1))
    gm = np.tile(np.array([[1, 1, 0]], np.float32), (b, 1))
    return gb, gc, gm


def test_ppyoloe_eval_matches(ppyoloe_ref):
    jm, pm = _ppyoloe_pair(ppyoloe_ref)
    jm.eval()
    pm.eval()
    x = _images()
    jb, js = jit_forward(jm, jnp.asarray(x))
    with torch.no_grad():
        pb, ps = pm(torch.from_numpy(x))
    assert tuple(pb.shape) == (2, 8 * 8 + 4 * 4 + 2 * 2, 4)
    _close(pb, jb, MODEL_TOL, "boxes")
    _close(ps, js, MODEL_TOL, "scores")


def test_ppyoloe_train_matches(ppyoloe_ref):
    jm, pm = _ppyoloe_pair(ppyoloe_ref)
    jm.train()
    pm.train()
    x = _images()
    jout = jm(paddle.to_tensor(x))
    pout = pm(torch.from_numpy(x))
    for name, got, want in zip(("cls_logits", "reg_dist", "boxes"), pout,
                               jout):
        _close(got, want, MODEL_TOL, name)
    jstate = jm.state_dict()
    for k, v in pm.state_dict().items():
        if k.endswith(("_mean", "_variance")):
            _close(v, jstate[k], MODEL_TOL, k)


def test_ppyoloe_criterion_reads_the_forwards_anchors(ppyoloe_ref):
    """The forward leaves its anchors in ``_last_anchors``; the criterion
    over the model's outputs is the reference's loss over the same
    outputs with the reference's anchors."""
    _, pm = _ppyoloe_pair(ppyoloe_ref)
    pm.train()
    assert pm._last_anchors is None
    x = np.random.default_rng(1).standard_normal((2, 3, 64, 64)).astype(
        np.float32)
    pout = pm(torch.from_numpy(x))
    anc, strides = pm._last_anchors
    want_a, want_s = jax_pp._anchor_points([(8, 8), (4, 4), (2, 2)],
                                           [8, 16, 32])
    np.testing.assert_array_equal(anc.numpy(), _np(want_a))
    np.testing.assert_array_equal(strides.numpy(), _np(want_s))
    crit = port_det.PPYOLOECriterion(pm)
    assert not list(crit.parameters())   # the model is not a submodule
    labels = _ref_gt(2)
    got = crit(*pout, *(torch.from_numpy(v) for v in labels))
    ref = jax_pp.PPYOLOELoss(4, 16)

    @jax.jit
    def f(cl, rd, bx, *lab):
        return ref(Tensor(cl), Tensor(bx), Tensor(rd), want_a, want_s,
                   *(Tensor(v) for v in lab))._value
    want = f(*(jnp.asarray(t.detach().numpy()) for t in pout),
             *(jnp.asarray(v) for v in labels))
    assert abs(got.item() - float(_np(want))) <= LOSS_TOL * abs(
        float(_np(want)))


# -- training steps -----------------------------------------------------------

def _detr_pair():
    """tests/test_detection.py's tiny DETR in both packages, one state."""
    paddle.seed(0)
    cfg = dict(num_classes=4, num_queries=10, d_model=32, nhead=2,
               num_encoder_layers=1, num_decoder_layers=1,
               dim_feedforward=64, backbone="tiny", dropout=0.0)
    jm = jax_det.DETR(**cfg)
    pm = port_det.DETR(**cfg, device="cpu", generator=seed(0, device="cpu"))
    load_numpy_state(pm, _randomized_state(jm, 0))
    return jm, pm


def _detr_labels():
    gb = np.array([[[.3, .3, .2, .2], [.6, .6, .3, .3], [0, 0, 0, 0]]],
                  np.float32)
    gc = np.array([[1, 2, 0]], np.int64)
    gm = np.array([[1, 1, 0]], np.float32)
    return gb, gc, gm


def _steps(jm, pm, jcrit, pcrit, x, labels, n=3):
    jm.train()
    pm.train()
    jeng = JaxEngine(jm, loss=jcrit, optimizer=paddle.optimizer.Adam(
        learning_rate=1e-3, parameters=jm.parameters()))
    peng = Engine(pm, pcrit, Adam(1e-3, parameters=pm.named_parameters()))
    jx = paddle.to_tensor(x)
    jl = [paddle.to_tensor(v) for v in labels]
    want = [float(jeng.train_batch([jx], jl)[0]) for _ in range(n)]
    got = [peng.train_batch([torch.from_numpy(x)],
                            [torch.from_numpy(v) for v in labels])[0].item()
           for _ in range(n)]
    return got, want


def test_detr_engine_steps_match():
    jm, pm = _detr_pair()
    x = np.random.RandomState(1).randn(1, 3, 64, 64).astype("float32")
    got, want = _steps(jm, pm, jax_det.DETRLoss(num_classes=4),
                       port_det.DETRLoss(num_classes=4), x, _detr_labels())
    np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=0)
    assert np.isfinite(got).all() and got[-1] < got[0]


def test_ppyoloe_engine_steps_match(ppyoloe_ref):
    """At batch 2: at the reference test's batch 1 the last stage's
    train-mode BatchNorm normalises 2 x 2 values a channel, which puts the
    packages' first forwards 1e-4 apart in the scores, and Adam's
    steps (each weight moved by ~lr, the sign of a near-zero gradient
    deciding its direction) take the third losses 14 % apart; at batch 2
    they stay within 4e-6."""
    jm, pm = _ppyoloe_pair(ppyoloe_ref)
    x = np.random.RandomState(1).randn(2, 3, 64, 64).astype("float32")
    got, want = _steps(jm, pm, jax_det.PPYOLOECriterion(jm),
                       port_det.PPYOLOECriterion(pm), x, _ref_gt(2))
    np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=0)
    assert np.isfinite(got).all() and got[-1] < got[0]


class _Boxes(Dataset):
    """Four-field samples: an image, gt boxes (cxcywh normalised, padded
    to 3 slots), classes and the slots' mask, from a numpy seed."""

    def __init__(self, n=8):
        rng = np.random.default_rng(4)
        self.x = rng.standard_normal((n, 3, 64, 64)).astype(np.float32)
        self.gb = np.concatenate([rng.uniform(0.3, 0.7, (n, 3, 2)),
                                  rng.uniform(0.1, 0.4, (n, 3, 2))],
                                 -1).astype(np.float32)
        self.gc = rng.integers(0, 4, (n, 3)).astype(np.int64)
        self.gm = (np.arange(3)[None] < rng.integers(1, 4, (n, 1))).astype(
            np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.gb[i], self.gc[i], self.gm[i]


def test_detr_model_fit_four_fields():
    """Model(net, inputs=[one spec]): one input, three labels."""
    _, pm = _detr_pair()
    losses = []

    class Losses(Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"][0])

    model = Model(pm, inputs=["images"])
    model.prepare(Adam(1e-3, parameters=pm.named_parameters()),
                  port_det.DETRLoss(num_classes=4))
    model.fit(_Boxes(), batch_size=4, epochs=6, shuffle=False, verbose=0,
              callbacks=[Losses()])
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-2:]) < np.mean(losses[:2])
