"""``paddle.vision.ops`` of the PyTorch port vs the JAX package.

Every case of tests/test_vision_ops.py, each run through the port and
through the reference function on the same numpy inputs, with the
reference test's own checks on the port's result; and the same functions
on random inputs that reach their other branches. On the CPU:

- ``nms``: indices equal the reference's exactly (against a naive greedy
  NMS, without scores, with categories, ``top_k``'s fixed shape padded
  with -1, and random boxes with 0-3 categories, thresholds 0.1-0.7 and
  tied scores); ``box_iou`` within 1e-6;
- ``roi_align`` (aligned and not, ``sampling_ratio`` 1-3, boxes past the
  map's edges, RoIs over two images), ``roi_pool``, ``PSRoIPool`` and the
  layers: f32 within 1e-5 of max(1, |reference|);
- ``distribute_fpn_proposals``: levels and masks equal;
- ``deform_conv2d`` v1 and v2 (``mask``) with deformable groups, groups,
  stride, padding, dilation and bias within 1e-5 of max(1, |reference|),
  zero offsets equal to ``conv2d``, and ``DeformConv2D``'s gradients;
- ``box_coder`` both ways (a variance of 4 and one a prior, both axes) and
  ``yolo_box`` (clipped or not, ``scale_x_y``, ``iou_aware``) within 1e-5
  of max(1, |reference|).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import ops as V
from paddle_tpu_torch.nn import functional as port_F
from paddle_tpu_torch.vision import ops as P
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


def _np(t):
    if torch.is_tensor(t):
        return t.detach().numpy()
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _close(got, want, tol=TOL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scaled = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert scaled.max() <= tol, (what, float(scaled.max()))


def _both(fn, *arrays, **kw):
    """fn of the port on torch tensors and of the reference on its
    tensors, over the same numpy arrays -> (port, reference)."""
    got = getattr(P, fn)(*[torch.from_numpy(a) for a in arrays], **kw)
    want = getattr(V, fn)(*[paddle.to_tensor(a) for a in arrays], **kw)
    return got, want


def naive_nms(boxes, scores, thr):
    """The reference test's greedy NMS."""
    order = np.argsort(-scores)
    keep = []
    alive = np.ones(len(boxes), bool)
    for j in order:
        if not alive[j]:
            continue
        keep.append(j)
        for k in order:
            if alive[k] and k != j:
                lt = np.maximum(boxes[j, :2], boxes[k, :2])
                rb = np.minimum(boxes[j, 2:], boxes[k, 2:])
                wh = np.clip(rb - lt, 0, None)
                inter = wh[0] * wh[1]
                a1 = np.prod(np.clip(boxes[j, 2:] - boxes[j, :2], 0, None))
                a2 = np.prod(np.clip(boxes[k, 2:] - boxes[k, :2], 0, None))
                if inter / (a1 + a2 - inter + 1e-9) > thr:
                    alive[k] = False
    return np.array(keep)


def _boxes(rng, n, lo=0, hi=50, wmin=5, wmax=25):
    xy = rng.uniform(lo, hi, (n, 2)).astype(np.float32)
    wh = rng.uniform(wmin, wmax, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], -1)


# -- nms and box_iou -------------------------------------------------------------

@pytest.mark.parametrize("trial", range(5))
def test_nms_vs_naive(trial):
    rng = np.random.default_rng(0)
    for _ in range(trial + 1):
        boxes = _boxes(rng, 40)
        scores = rng.uniform(0, 1, 40).astype(np.float32)
    got, want = _both("nms", boxes, iou_threshold=0.4,
                      scores=scores)
    got = _np(got)
    assert got.dtype == np.int64
    assert np.array_equal(got, _np(want))
    assert np.array_equal(np.sort(got), np.sort(naive_nms(boxes, scores,
                                                          0.4)))
    assert np.all(np.diff(scores[got]) <= 1e-6)


def test_nms_no_scores_uses_input_order():
    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [30, 30, 40, 40]],
                     np.float32)
    got, want = _both("nms", boxes, iou_threshold=0.3)
    assert np.array_equal(_np(got), _np(want))
    assert np.array_equal(np.sort(_np(got)), [0, 2])


def test_nms_categories():
    boxes = np.array([[0, 0, 10, 10], [0, 0, 10, 10]], np.float32)
    scores = np.array([0.9, 0.8], np.float32)
    got, want = _both("nms", boxes, iou_threshold=0.3, scores=scores,
                      category_idxs=np.array([0, 1], np.int64),
                      categories=[0, 1])
    assert np.array_equal(_np(got), _np(want)) and len(_np(got)) == 2


def test_nms_top_k_fixed_shape():
    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [30, 30, 40, 40]],
                     np.float32)
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    got, want = _both("nms", boxes, iou_threshold=0.3, scores=scores,
                      top_k=3)
    assert np.array_equal(_np(got), _np(want))
    assert _np(got).tolist() == [0, 2, -1]


@pytest.mark.parametrize("seed,thr,cats,top_k,ties", [
    (1, 0.1, 0, None, False), (2, 0.3, 3, None, False),
    (3, 0.5, 2, 50, False), (4, 0.7, 0, 200, False),
    (5, 0.4, 3, 20, True), (6, 0.4, 0, None, True)])
def test_nms_random_matches(seed, thr, cats, top_k, ties):
    """Dense boxes (long suppression chains), categories, top_k past and
    short of the kept count, tied scores: the same indices."""
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, 120, hi=80)
    scores = rng.uniform(0, 1, 120).astype(np.float32)
    if ties:
        scores = np.round(scores * 4) / 4
    kw = dict(iou_threshold=thr, scores=scores, top_k=top_k)
    if cats:
        kw.update(category_idxs=rng.integers(0, cats, 120),
                  categories=list(range(cats)))
    got, want = _both("nms", boxes, **kw)
    assert np.array_equal(_np(got), _np(want)), (_np(got), _np(want))


def test_box_iou():
    a = np.array([[0, 0, 10, 10]], np.float32)
    b = np.array([[0, 0, 10, 10], [5, 5, 15, 15], [20, 20, 30, 30]],
                 np.float32)
    got, want = _both("box_iou", a, b)
    _close(got, want, 1e-6)
    assert np.allclose(_np(got), [[1.0, 25 / 175, 0.0]], atol=1e-5)
    rng = np.random.default_rng(7)
    got, want = _both("box_iou", _boxes(rng, 9), _boxes(rng, 13))
    _close(got, want, 1e-6)


# -- RoI ops ---------------------------------------------------------------------

def _roi_inputs(rng, c=5, h=17, w=21):
    x = rng.standard_normal((2, c, h, w)).astype(np.float32)
    boxes = _boxes(rng, 7, lo=-3, hi=18, wmin=0.5, wmax=14)
    return x, boxes, np.array([3, 4], np.int32)


def test_roi_align_constant_feature():
    x = np.full((1, 3, 16, 16), 7.0, np.float32)
    boxes = np.array([[2, 2, 10, 10], [0, 0, 15, 15]], np.float32)
    got, want = _both("roi_align", x, boxes, np.array([2], np.int32),
                      output_size=4)
    _close(got, want)
    assert _np(got).shape == (2, 3, 4, 4)
    assert np.allclose(_np(got), 7.0, atol=1e-5)


def test_roi_align_linear_gradient_field():
    x = np.broadcast_to(np.arange(32, dtype=np.float32)[None, None, None, :],
                        (1, 1, 32, 32)).copy()
    boxes = np.array([[4, 4, 12, 12]], np.float32)
    got, want = _both("roi_align", x, boxes, np.array([1], np.int32),
                      output_size=2, aligned=False)
    _close(got, want)
    out = _np(got)
    assert np.allclose(out[0, 0, 0, 0], 6.0, atol=0.05)
    assert np.allclose(out[0, 0, 0, 1], 10.0, atol=0.05)
    assert np.allclose(out[0, 0, 0], out[0, 0, 1], atol=1e-5)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sr,size,scale", [(-1, 3, 1.0), (1, (2, 4), 0.5),
                                           (3, 2, 0.8)])
def test_roi_align_random_matches(aligned, sr, size, scale):
    x, boxes, bn = _roi_inputs(np.random.default_rng(8))
    got, want = _both("roi_align", x, boxes, bn, output_size=size,
                      spatial_scale=scale, sampling_ratio=sr,
                      aligned=aligned)
    _close(got, want)


def test_roi_pool_max():
    x = np.zeros((1, 1, 8, 8), np.float32)
    x[0, 0, 3, 3] = 5.0
    boxes = np.array([[0, 0, 8, 8]], np.float32)
    got, want = _both("roi_pool", x, boxes, np.array([1], np.int32),
                      output_size=2)
    _close(got, want)
    assert np.allclose(_np(got)[0, 0], [[5.0, 0.0], [0.0, 0.0]])


@pytest.mark.parametrize("size,scale", [(3, 1.0), ((2, 5), 0.6)])
def test_roi_pool_random_matches(size, scale):
    x, boxes, bn = _roi_inputs(np.random.default_rng(9))
    got, want = _both("roi_pool", x, boxes, bn, output_size=size,
                      spatial_scale=scale)
    _close(got, want)


def test_roi_layers_match():
    x, boxes, bn = _roi_inputs(np.random.default_rng(10))
    args = [torch.from_numpy(a) for a in (x, boxes, bn)]
    rargs = [paddle.to_tensor(a) for a in (x, boxes, bn)]
    _close(P.RoIAlign(3, 0.7)(*args), V.RoIAlign(3, 0.7)(*rargs))
    _close(P.RoIPool(2, 0.7)(*args), V.RoIPool(2, 0.7)(*rargs))


def test_psroi_pool():
    oh = ow = 2
    c_out = 3
    x = np.zeros((1, c_out * oh * ow, 8, 8), np.float32)
    for c in range(c_out):
        for i in range(oh):
            for j in range(ow):
                x[0, c * oh * ow + i * ow + j] = c * 100 + i * 10 + j
    boxes = np.array([[0, 0, 8, 8]], np.float32)
    bn = np.array([1], np.int32)
    got = P.PSRoIPool(2)(torch.from_numpy(x), torch.from_numpy(boxes),
                         torch.from_numpy(bn))
    want = V.PSRoIPool(2)(paddle.to_tensor(x), paddle.to_tensor(boxes),
                          paddle.to_tensor(bn))
    _close(got, want)
    out = _np(got)
    assert out.shape == (1, c_out, 2, 2)
    for c in range(c_out):
        for i in range(oh):
            for j in range(ow):
                assert np.allclose(out[0, c, i, j], c * 100 + i * 10 + j)


@pytest.mark.parametrize("size,scale", [(2, 1.0), ((3, 2), 0.6)])
def test_psroi_pool_random_matches(size, scale):
    rng = np.random.default_rng(11)
    oh, ow = (size, size) if isinstance(size, int) else size
    x = rng.standard_normal((2, 4 * oh * ow, 15, 19)).astype(np.float32)
    _, boxes, bn = _roi_inputs(rng)
    got = P.PSRoIPool(size, scale)(*[torch.from_numpy(a)
                                     for a in (x, boxes, bn)])
    want = V.PSRoIPool(size, scale)(*[paddle.to_tensor(a)
                                      for a in (x, boxes, bn)])
    _close(got, want)


def test_distribute_fpn():
    rois = np.array([[0, 0, 10, 10], [0, 0, 500, 500]], np.float32)
    (lvl, masks), (rl, rm) = _both("distribute_fpn_proposals", rois,
                                   min_level=2, max_level=5, refer_level=4,
                                   refer_scale=224)
    assert np.array_equal(_np(lvl), _np(rl))
    assert np.array_equal(_np(masks), _np(rm))
    assert _np(lvl).tolist() == [2, 5] and _np(masks).shape == (4, 2)
    assert _np(masks)[0, 0] == 1 and _np(masks)[3, 1] == 1


@pytest.mark.parametrize("offset", [False, True])
def test_distribute_fpn_random_matches(offset):
    rng = np.random.default_rng(12)
    rois = _boxes(rng, 300, hi=600, wmin=1, wmax=700)
    (lvl, masks), (rl, rm) = _both("distribute_fpn_proposals", rois,
                                   min_level=2, max_level=5, refer_level=4,
                                   refer_scale=224, pixel_offset=offset)
    assert np.array_equal(_np(lvl), _np(rl))
    assert np.array_equal(_np(masks), _np(rm))
    assert _np(lvl).dtype == np.int32 and _np(masks).dtype == np.float32


# -- deformable convolution ------------------------------------------------------

def test_deform_zero_offset_equals_conv():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 9, 9)).astype(np.float32)
    w = rng.standard_normal((6, 4, 3, 3)).astype(np.float32) * 0.2
    off = np.zeros((2, 2 * 9, 7, 7), np.float32)
    got, want = _both("deform_conv2d", x, off, w)
    _close(got, want)
    ref = port_F.conv2d(torch.from_numpy(x), torch.from_numpy(w))
    assert np.allclose(_np(got), ref.numpy(), atol=1e-4)


def test_deform_mask_scales():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 2, 7, 7)).astype(np.float32)
    w = rng.standard_normal((3, 2, 3, 3)).astype(np.float32) * 0.2
    off = np.zeros((1, 18, 5, 5), np.float32)
    mask_half = np.full((1, 9, 5, 5), 0.5, np.float32)
    full, _ = _both("deform_conv2d", x, off, w)
    half = P.deform_conv2d(torch.from_numpy(x), torch.from_numpy(off),
                           torch.from_numpy(w),
                           mask=torch.from_numpy(mask_half))
    want = V.deform_conv2d(paddle.to_tensor(x), paddle.to_tensor(off),
                           paddle.to_tensor(w),
                           mask=paddle.to_tensor(mask_half))
    _close(half, want)
    assert np.allclose(_np(half), _np(full) * 0.5, atol=1e-4)


@pytest.mark.parametrize("dg,groups,stride,padding,dilation,masked,bias", [
    (1, 1, 1, 0, 1, False, False), (2, 1, 1, 1, 1, True, True),
    (2, 2, 2, 1, 1, True, False), (1, 2, 1, 2, 2, False, True),
    (4, 1, (2, 1), (1, 2), 1, True, True)])
def test_deform_random_matches(dg, groups, stride, padding, dilation,
                               masked, bias):
    rng = np.random.default_rng(13)
    b, cin, cout, h, w, k = 2, 8, 6, 11, 10, 3
    x = rng.standard_normal((b, cin, h, w)).astype(np.float32)
    wt = rng.standard_normal((cout, cin // groups, k, k)).astype(np.float32)
    st = (stride, stride) if isinstance(stride, int) else stride
    pd = (padding, padding) if isinstance(padding, int) else padding
    ho = (h + 2 * pd[0] - dilation * (k - 1) - 1) // st[0] + 1
    wo = (w + 2 * pd[1] - dilation * (k - 1) - 1) // st[1] + 1
    off = (rng.standard_normal((b, 2 * dg * k * k, ho, wo)) * 2).astype(
        np.float32)
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              deformable_groups=dg, groups=groups)
    pargs = [torch.from_numpy(a) for a in (x, off, wt)]
    rargs = [paddle.to_tensor(a) for a in (x, off, wt)]
    if bias:
        bv = rng.standard_normal(cout).astype(np.float32)
        pargs.append(torch.from_numpy(bv))
        rargs.append(paddle.to_tensor(bv))
    if masked:
        m = rng.uniform(0, 1, (b, dg * k * k, ho, wo)).astype(np.float32)
        kw_p = dict(kw, mask=torch.from_numpy(m))
        kw_r = dict(kw, mask=paddle.to_tensor(m))
    else:
        kw_p = kw_r = kw
    _close(P.deform_conv2d(*pargs, **kw_p), V.deform_conv2d(*rargs, **kw_r))


def test_deform_layer_trains():
    layer = P.DeformConv2D(2, 3, 3, padding=1, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 2, 6, 6)).astype(np.float32))
    off = torch.zeros((1, 18, 6, 6))
    out = layer(x, off)
    assert tuple(out.shape) == (1, 3, 6, 6)
    (out ** 2).mean().backward()
    assert layer.weight.grad is not None and layer.bias.grad is not None


def test_deform_layer_matches_the_reference():
    """The layer from the reference's weights: forward and the weight's
    gradient."""
    rng = np.random.default_rng(14)
    ref = V.DeformConv2D(4, 3, 3, padding=1, deformable_groups=2)
    layer = P.DeformConv2D(4, 3, 3, padding=1, deformable_groups=2,
                           device="cpu")
    with torch.no_grad():
        layer.weight.copy_(torch.tensor(_np(ref.weight)))
        layer.bias.copy_(torch.tensor(_np(ref.bias)))
    x = rng.standard_normal((2, 4, 7, 8)).astype(np.float32)
    off = rng.standard_normal((2, 36, 7, 8)).astype(np.float32)
    got = layer(torch.from_numpy(x), torch.from_numpy(off))
    want = ref(paddle.to_tensor(x), paddle.to_tensor(off))
    _close(got, want)
    (got ** 2).mean().backward()
    (want ** 2).mean().backward()
    _close(layer.weight.grad, ref.weight.grad, 1e-5)


# -- box_coder and yolo_box ------------------------------------------------------

def test_box_coder_encode_decode_roundtrip():
    priors = np.array([[10, 10, 30, 30], [40, 40, 90, 100]], np.float32)
    var = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
    targets = np.array([[12, 14, 33, 35], [45, 42, 80, 95]], np.float32)
    enc, renc = _both("box_coder", priors, var, targets,
                      code_type="encode_center_size")
    _close(enc, renc)
    diag = np.stack([_np(enc)[i, i] for i in range(2)])[None]
    dec, rdec = _both("box_coder", priors, var,
                      np.ascontiguousarray(diag.transpose(1, 0, 2)),
                      code_type="decode_center_size", axis=1)
    _close(dec, rdec)
    assert np.allclose(_np(dec)[:, 0, :], targets, atol=1e-3)


@pytest.mark.parametrize("per_prior", [False, True])
@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("axis", [0, 1])
def test_box_coder_random_matches(per_prior, normalized, axis):
    rng = np.random.default_rng(15)
    priors = _boxes(rng, 6)
    var = (rng.uniform(0.1, 0.3, (6, 4)) if per_prior
           else rng.uniform(0.1, 0.3, 4)).astype(np.float32)
    targets = _boxes(rng, 5)
    enc, renc = _both("box_coder", priors, var, targets,
                      box_normalized=normalized)
    _close(enc, renc)
    deltas = (rng.standard_normal((6, 6, 4) if axis else (5, 6, 4))
              * 0.3).astype(np.float32)
    dec, rdec = _both("box_coder", priors, var, deltas,
                      code_type="decode_center_size",
                      box_normalized=normalized, axis=axis)
    _close(dec, rdec)


def test_yolo_box_shapes():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3 * 7, 4, 4)).astype(np.float32)
    img = np.array([[64, 64], [64, 64]], np.int32)
    kw = dict(anchors=[10, 13, 16, 30, 33, 23], class_num=2,
              conf_thresh=0.01, downsample_ratio=16)
    (boxes, scores), (rb, rs) = _both("yolo_box", x, img, **kw)
    _close(boxes, rb)
    _close(scores, rs)
    assert tuple(boxes.shape) == (2, 48, 4) and tuple(scores.shape) == \
        (2, 48, 2)
    b = _np(boxes)
    assert b.min() >= 0 and b.max() <= 63.001


def test_yolo_box_iou_aware():
    rng = np.random.default_rng(6)
    na, c = 3, 2
    x = rng.standard_normal((1, na + na * (5 + c), 4, 4)).astype(np.float32)
    img = np.array([[64, 64]], np.int32)
    kw = dict(anchors=[10, 13, 16, 30, 33, 23], class_num=c,
              conf_thresh=-1.0, downsample_ratio=16, iou_aware=True,
              iou_aware_factor=0.5)
    (boxes, s_aware), (rb, rs) = _both("yolo_box", x, img, **kw)
    _close(boxes, rb)
    _close(s_aware, rs)

    def sig(v):
        return 1 / (1 + np.exp(-v))
    v = x[:, na:].reshape(1, na, 5 + c, 4, 4)
    iou = sig(x[:, :na].reshape(1, na, 4, 4))
    obj = sig(v[:, :, 4]) ** 0.5 * iou ** 0.5
    ref = (obj[:, :, None] * sig(v[:, :, 5:])).transpose(0, 1, 3, 4, 2)
    assert np.allclose(_np(s_aware), ref.reshape(1, -1, c), atol=1e-4)


@pytest.mark.parametrize("clip,scale_xy", [(True, 1.0), (False, 1.05),
                                           (True, 1.2)])
def test_yolo_box_random_matches(clip, scale_xy):
    rng = np.random.default_rng(16)
    x = (rng.standard_normal((2, 3 * 85, 5, 6)) * 2).astype(np.float32)
    img = np.array([[160, 192], [150, 200]], np.int32)
    (boxes, scores), (rb, rs) = _both(
        "yolo_box", x, img, anchors=[10, 13, 16, 30, 33, 23], class_num=80,
        conf_thresh=0.3, downsample_ratio=32, clip_bbox=clip,
        scale_x_y=scale_xy)
    _close(boxes, rb)
    _close(scores, rs)
