"""Detection training's losses, assigner and matcher in the PyTorch port
vs the JAX package, on the CPU, on the same numpy inputs:

- ``auction_match``: the matches equal the reference's exactly on the same
  cost matrices (Q 16 and 100, M 5 and 20; every gt valid, some, none;
  normal costs and costs on a coarse grid, which tie), one batched port
  call against per-image reference calls; a small ``max_iter`` that cuts
  the auction ends in the reference's state; the optimum against scipy's
  where scipy is present; the host reads counted;
- ``DETRLoss``: the loss within 1e-5 relative and its gradients with
  respect to the logits and boxes within 1e-5 of ``jax.grad``'s, with a
  padded gt and an image with no valid gt;
- ``task_aligned_assign``: ``assigned`` and ``fg`` equal, the target score
  within 1e-5, on the reference's own case and on random batches;
- ``PPYOLOELoss``: loss and gradients (logits, boxes, distributions)
  within 1e-5;
- the losses, the criterion and the matcher create nothing off their
  inputs' device.

The models' training steps are held in test_torch_detection_steps.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.tensor import Tensor
from paddle_tpu.vision.models import detection as jax_det
from paddle_tpu.vision.models.detection import ppyoloe as jax_pp
from paddle_tpu_torch import seed
from paddle_tpu_torch.vision.models import detection as port_det
from paddle_tpu_torch.vision.models.detection import detr as port_detr
from paddle_tpu_torch.vision.models.detection import ppyoloe as port_pp
from torch_threads import one_torch_thread  # noqa: F401

LOSS_TOL = 1e-5


def _np(x):
    return np.asarray(x._value if hasattr(x, "_value") else x)


# -- auction_match ------------------------------------------------------------

def _costs(rng, b, q, m, kind):
    c = rng.standard_normal((b, q, m))
    if kind == "grid":  # a coarse grid: many exact ties between queries
        c = np.round(c * 2) / 2
    return c.astype(np.float32)


def _valid(rng, b, m, which):
    if which == "all":
        return np.ones((b, m), bool)
    if which == "none":
        return np.zeros((b, m), bool)
    v = rng.uniform(size=(b, m)) < 0.5
    v[:, 0] = True
    v[-1] = False
    return v


def _ref_matches(cost, valid, **kw):
    return np.stack([_np(jax_det.auction_match(jnp.asarray(c),
                                               jnp.asarray(v), **kw))
                     for c, v in zip(cost, valid)])


@pytest.mark.parametrize("kind", ["normal", "grid"])
@pytest.mark.parametrize("which", ["all", "some", "none"])
@pytest.mark.parametrize("q,m", [(16, 5), (16, 20), (100, 5), (100, 20)])
def test_auction_matches_the_reference_exactly(q, m, which, kind):
    rng = np.random.default_rng(q * 1000 + m * 10 + len(which) + len(kind))
    cost = _costs(rng, 4, q, m, kind)
    valid = _valid(rng, 4, m, which)
    # at 16 x 20 with every gt valid there are more gts than queries: the
    # auction runs to its cap on both sides, here 200 iterations (the
    # default 2000 in test_auction_capped_state)
    kw = dict(max_iter=200) if (valid.sum(1) > q).any() else {}
    want = _ref_matches(cost, valid, **kw)
    got = port_det.auction_match(torch.from_numpy(cost),
                                 torch.from_numpy(valid), **kw)
    assert got.dtype == torch.int64 and tuple(got.shape) == (4, m)
    np.testing.assert_array_equal(got.numpy(), want)
    for i in range(4):  # and one image at a time
        one = port_det.auction_match(torch.from_numpy(cost[i]),
                                     torch.from_numpy(valid[i]), **kw)
        np.testing.assert_array_equal(one.numpy(), want[i])
        if valid[i].sum() <= q:  # the valid gts hold distinct queries
            assert len(set(want[i][valid[i]])) == valid[i].sum()


@pytest.mark.parametrize("max_iter", [1, 5, 16, 23, 200, 2000])
def test_auction_capped_state(max_iter):
    """A cap that cuts the auction (and 16 x 20, more valid gts than
    queries, which never ends by itself) ends in the reference's state."""
    rng = np.random.default_rng(max_iter)
    for q, m in ((100, 20), (16, 20)):
        cost = _costs(rng, 3, q, m, "normal")
        valid = np.ones((3, m), bool)
        want = _ref_matches(cost, valid, max_iter=max_iter)
        iters = port_detr.auction_match.iterations
        got = port_det.auction_match(torch.from_numpy(cost),
                                     torch.from_numpy(valid),
                                     max_iter=max_iter)
        np.testing.assert_array_equal(got.numpy(), want)
        if q < m:  # never done: exactly max_iter iterations
            assert port_detr.auction_match.iterations - iters == max_iter


def test_auction_counts_host_reads():
    """One host read a chunk of AUCTION_CHECK_EVERY iterations: the run
    ends on the first chunk whose end finds every valid gt assigned."""
    rng = np.random.default_rng(5)
    cost = _costs(rng, 2, 100, 20, "normal")
    valid = np.ones((2, 20), bool)
    every = port_detr.AUCTION_CHECK_EVERY
    syncs = port_detr.auction_match.host_syncs
    iters = port_detr.auction_match.iterations
    port_det.auction_match(torch.from_numpy(cost), torch.from_numpy(valid))
    n_sync = port_detr.auction_match.host_syncs - syncs
    n_iter = port_detr.auction_match.iterations - iters
    assert n_iter == n_sync * every
    # the chunk before the last did not finish
    short = port_det.auction_match(torch.from_numpy(cost),
                                   torch.from_numpy(valid),
                                   max_iter=n_iter - every)
    assert not np.array_equal(short.numpy(), _ref_matches(cost, valid))


def test_auction_matches_scipy_optimum():
    scipy_opt = pytest.importorskip(
        "scipy.optimize", reason="scipy's linear_sum_assignment is only "
        "the optimum the auction is checked against")
    rng = np.random.default_rng(0)
    cost = _costs(rng, 10, 16, 5, "normal")
    valid = np.ones((10, 5), bool)
    valid[1::2, 3:] = False
    match = port_det.auction_match(torch.from_numpy(cost),
                                   torch.from_numpy(valid)).numpy()
    for c, v, mt in zip(cost, valid, match):
        r, col = scipy_opt.linear_sum_assignment(c[:, v].T)
        best = c[:, v].T[r, col].sum()
        got = c[mt[v], np.arange(5)[v]].sum()
        assert abs(got - best) < 0.05


# -- DETRLoss -----------------------------------------------------------------

def _detr_inputs(seed_=0, b=3, q=10, nc=4, m=4):
    rng = np.random.default_rng(seed_)
    lg = rng.standard_normal((b, q, nc + 1)).astype(np.float32)
    bx = (1 / (1 + np.exp(-rng.standard_normal((b, q, 4))))).astype(
        np.float32)
    gb = np.concatenate([rng.uniform(0.2, 0.8, (b, m, 2)),
                         rng.uniform(0.05, 0.5, (b, m, 2))], -1).astype(
        np.float32)
    gc = rng.integers(0, nc, (b, m)).astype(np.int64)
    # image 0: one padded gt; image 1: one valid gt; image 2: none
    gm = np.zeros((b, m), np.float32)
    gm[0, :m - 1] = 1
    gm[1, 0] = 1
    return lg, bx, gb, gc, gm


@pytest.mark.parametrize("seed_", [0, 1, 2])
def test_detr_loss_and_grads_match(seed_):
    lg, bx, gb, gc, gm = _detr_inputs(seed_)
    ref = jax_det.DETRLoss(num_classes=4)

    def f(a, b):
        return ref(Tensor(a), Tensor(b), Tensor(jnp.asarray(gb)),
                   Tensor(jnp.asarray(gc)), Tensor(jnp.asarray(gm)))._value
    want, (g_lg, g_bx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
        jnp.asarray(lg), jnp.asarray(bx))
    tl, tb = (torch.from_numpy(x).requires_grad_() for x in (lg, bx))
    loss = port_det.DETRLoss(num_classes=4)(
        tl, tb, *(torch.from_numpy(x) for x in (gb, gc, gm)))
    loss.backward()
    assert abs(loss.item() - float(want)) <= LOSS_TOL * abs(float(want))
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(g_lg),
                               atol=LOSS_TOL, rtol=0)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(g_bx),
                               atol=LOSS_TOL, rtol=0)


def test_detr_loss_padding_never_clobbers_a_match():
    """A padded gt's (garbage) class never reaches a query's target: the
    loss with padded slots holding other classes and boxes equals the
    loss with those slots cut off."""
    lg, bx, gb, gc, gm = _detr_inputs(3)
    crit = port_det.DETRLoss(num_classes=4)
    t = [torch.from_numpy(x) for x in (lg, bx)]
    full = crit(*t, *(torch.from_numpy(x) for x in (gb, gc, gm)))
    gc2, gb2 = gc.copy(), gb.copy()
    gc2[gm == 0] = 3
    gb2[gm == 0] = 0.5
    again = crit(*t, *(torch.from_numpy(x) for x in (gb2, gc2, gm)))
    assert torch.equal(full, again)
    cut = crit(t[0][:1], t[1][:1], *(torch.from_numpy(x[:1, :3])
                                     for x in (gb, gc, gm)))
    one = crit(t[0][:1], t[1][:1], *(torch.from_numpy(x[:1])
                                     for x in (gb, gc, gm)))
    assert torch.allclose(cut, one, rtol=1e-6, atol=0)


# -- task_aligned_assign ------------------------------------------------------

def test_tal_reference_case():
    """tests/test_detection.py::test_tal_assigner_prefers_high_iou_anchor,
    on both packages."""
    a = 16
    anchors = np.stack([np.linspace(4, 60, a), np.full((a,), 16.0)],
                       -1).astype(np.float32)
    boxes = np.concatenate([anchors - 8, anchors + 8], -1)
    gt = np.asarray([[0.0, 8.0, 16.0, 24.0]], np.float32)
    scores = np.full((a, 3), 0.5, np.float32)
    want = jax_pp.task_aligned_assign(
        jnp.asarray(scores), jnp.asarray(boxes), jnp.asarray(anchors),
        jnp.asarray(gt), jnp.asarray([1]), jnp.asarray([1.0]), topk=4)
    got = port_det.task_aligned_assign(
        torch.from_numpy(scores), torch.from_numpy(boxes),
        torch.from_numpy(anchors), torch.from_numpy(gt),
        torch.tensor([1]), torch.tensor([1.0]), topk=4)
    np.testing.assert_array_equal(got[0].numpy(), _np(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
    np.testing.assert_allclose(got[2].numpy(), _np(want[2]), atol=1e-5,
                               rtol=0)
    fg = np.where(got[1].numpy())[0]
    assert len(fg) > 0 and got[2].numpy()[fg, 1].min() > 0.0
    assert got[2].numpy()[:, [0, 2]].max() == 0.0


def _pp_inputs(seed_, b=3, nc=4, m=5, reg_max=16):
    """Random head outputs over the 84 anchors of a 64 px image, boxes
    around the anchors, gts in pixels (image 0 with two padded slots,
    image 2 with none valid)."""
    rng = np.random.default_rng(seed_)
    anc, strides = port_pp._anchor_points([(8, 8), (4, 4), (2, 2)],
                                          [8, 16, 32])
    an = anc.numpy()
    a = an.shape[0]
    cl = rng.standard_normal((b, a, nc)).astype(np.float32)
    rd = rng.standard_normal((b, a, 4, reg_max + 1)).astype(np.float32)
    half = rng.uniform(2, 20, (b, a, 2))
    pb = np.concatenate([an[None] - half, an[None] + half], -1).astype(
        np.float32)
    ctr = rng.uniform(5, 59, (b, m, 2))
    wh = rng.uniform(6, 40, (b, m, 2))
    gb = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).clip(0, 64)
    gc = rng.integers(0, nc, (b, m)).astype(np.int64)
    gm = np.ones((b, m), np.float32)
    gm[0, 3:] = 0
    gm[2] = 0
    return (anc, strides), cl, pb, rd, gb.astype(np.float32), gc, gm


@pytest.mark.parametrize("seed_", [0, 1, 2, 3])
def test_tal_random_batches_match(seed_):
    (anc, _), cl, pb, _, gb, gc, gm = _pp_inputs(seed_)
    scores = (1 / (1 + np.exp(-cl))).astype(np.float32)
    got = port_det.task_aligned_assign(
        *(torch.from_numpy(x) for x in (scores, pb)), anc,
        *(torch.from_numpy(x) for x in (gb, gc, gm)))
    for i in range(len(cl)):
        want = jax_pp.task_aligned_assign(
            jnp.asarray(scores[i]), jnp.asarray(pb[i]), jnp.asarray(anc),
            jnp.asarray(gb[i]), jnp.asarray(gc[i]), jnp.asarray(gm[i]))
        np.testing.assert_array_equal(got[0][i].numpy(), _np(want[0]))
        np.testing.assert_array_equal(got[1][i].numpy(), _np(want[1]))
        np.testing.assert_allclose(got[2][i].numpy(), _np(want[2]),
                                   atol=1e-5, rtol=0)
    assert got[1][:2].any() and not got[1][2].any()


# -- PPYOLOELoss / PPYOLOECriterion -------------------------------------------

@pytest.mark.parametrize("seed_", [0, 1])
def test_ppyoloe_loss_and_grads_match(seed_):
    (anc, strides), cl, pb, rd, gb, gc, gm = _pp_inputs(seed_)
    ref = jax_pp.PPYOLOELoss(4, 16)
    ja, js = jnp.asarray(anc.numpy()), jnp.asarray(strides.numpy())

    def f(c, b, r):
        return ref(Tensor(c), Tensor(b), Tensor(r), ja, js,
                   Tensor(jnp.asarray(gb)), Tensor(jnp.asarray(gc)),
                   Tensor(jnp.asarray(gm)))._value
    want, grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2)))(
        jnp.asarray(cl), jnp.asarray(pb), jnp.asarray(rd))
    t = [torch.from_numpy(x).requires_grad_() for x in (cl, pb, rd)]
    loss = port_det.PPYOLOELoss(4, 16)(
        t[0], t[1], t[2], anc, strides,
        *(torch.from_numpy(x) for x in (gb, gc, gm)))
    loss.backward()
    assert abs(loss.item() - float(want)) <= LOSS_TOL * abs(float(want))
    for name, x, g in zip(("cls_logits", "pred_boxes", "reg_dist"), t,
                          grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g),
                                   atol=LOSS_TOL, rtol=0, err_msg=name)


# tests/test_detection.py's tiny PP-YOLOE
PPYOLOE_TINY = dict(num_classes=4, channels=(8, 16, 24, 32, 40))


# -- devices ------------------------------------------------------------------

def test_losses_and_matcher_create_nothing_off_their_inputs_device():
    """With the default device set to meta, CPU inputs still give CPU
    results: every tensor the code makes follows its inputs' device."""
    lg, bx, gb, gc, gm = _detr_inputs(0)
    (anc, strides), cl, pb, rd, pgb, pgc, pgm = _pp_inputs(0)
    pm = port_det.PPYOLOE(**PPYOLOE_TINY, device="cpu",
                          generator=seed(0, device="cpu"))
    pm._last_anchors = (anc, strides)   # as a 64 px forward leaves them
    crit = port_det.PPYOLOECriterion(pm)
    with torch.device("meta"):
        c = crit(*(torch.from_numpy(x) for x in (cl, rd, pb, pgb, pgc,
                                                 pgm)))
        d = port_det.DETRLoss(num_classes=4)(
            *(torch.from_numpy(x) for x in (lg, bx, gb, gc, gm)))
        m = port_det.auction_match(torch.from_numpy(_costs(
            np.random.default_rng(0), 2, 16, 5, "normal")),
            torch.ones(2, 5, dtype=torch.bool, device="cpu"))
        p = port_det.PPYOLOELoss(4, 16)(
            *(torch.from_numpy(x) for x in (cl, pb, rd)), anc, strides,
            *(torch.from_numpy(x) for x in (pgb, pgc, pgm)))
    assert d.device.type == m.device.type == p.device.type == "cpu"
    assert c.device.type == "cpu" and torch.equal(c, p)
    assert torch.isfinite(d) and torch.isfinite(p)
