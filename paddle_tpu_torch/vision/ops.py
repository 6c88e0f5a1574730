"""paddle.vision.ops of the port (counterpart of ``paddle_tpu/vision/ops.py``,
ref: python/paddle/vision/ops.py).

Plain PyTorch, as the reference computes these in jnp: no Pallas kernel
lies behind any of them. Every op runs where its inputs live and moves
nothing to the host, except where a docstring says it waits for the
device:

- ``nms`` resolves greedy suppression over a precomputed [N, N] overlap
  matrix as a fixed point (``_greedy_keep``), reading one flag back every
  few rounds; without ``top_k`` it also reads back which boxes it kept, a
  variable length, and orders them on the host as the reference does.
- ``roi_align``, ``roi_pool`` and ``PSRoIPool`` assign each RoI to its
  image from ``boxes_num`` on the device (``repeat_interleave`` told the
  RoI count), then gather every sample of every RoI at once: one gather
  per bilinear corner over a channels-last view.
- ``deform_conv2d`` gathers the deformed taps the same way, then contracts
  them with the kernel in one ``torch.einsum``, as the reference does.
- ``distribute_fpn_proposals`` returns the reference's static-shape level
  masks instead of ragged per-level lists, and reads nothing back.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..nlp.modeling_utils import model_kw
from ..nn.layers_common import make_param
from .models.detection.box_utils import pairwise_iou

__all__ = [
    "nms", "box_iou", "roi_align", "roi_pool", "box_coder", "yolo_box",
    "distribute_fpn_proposals", "deform_conv2d", "DeformConv2D", "PSRoIPool",
    "RoIAlign", "RoIPool",
]

# fixed-point rounds of ``_greedy_keep`` between two convergence reads
NMS_ROUNDS_PER_READ = 8


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _f32(x, device=None):
    """x as an f32 tensor on ``device`` (x's own by default); a host value
    is copied without a stream sync."""
    t = torch.as_tensor(x, dtype=torch.float32)
    return t if device is None else t.to(device, non_blocking=True)


# -- box ops -------------------------------------------------------------------

def box_iou(boxes1, boxes2, name=None):
    """ref: box_iou — [N, 4] x [M, 4] xyxy -> IoU [N, M]."""
    return pairwise_iou(_f32(boxes1), _f32(boxes2))[0]


def _greedy_keep(tri):
    """Greedy NMS over boxes in score order: ``tri[j, i]`` (i < j) says
    box i suppresses box j if kept. keep[j] = not any(tri[j] & keep), a
    recursion down the order whose solution is the unique fixed point of
    that map; iterating it from all-kept fixes one more box of every
    suppression chain a round. Returns (keep, host reads): a read every
    ``NMS_ROUNDS_PER_READ`` rounds tests whether a round changed
    nothing."""
    keep = torch.ones(tri.shape[0], dtype=torch.bool, device=tri.device)
    reads = 0
    while True:
        for _ in range(NMS_ROUNDS_PER_READ):
            prev, keep = keep, ~(tri & keep[None, :]).any(1)
        reads += 1
        if bool(torch.equal(prev, keep)):
            return keep, reads


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None, name=None):
    """ref: nms — greedy NMS: the highest-scored surviving box is kept and
    every box whose IoU with it passes ``iou_threshold`` is suppressed.
    ``scores`` None ranks the boxes in input order. With
    ``category_idxs``, boxes of different categories never suppress each
    other (each category's boxes shifted apart by the boxes' span, as the
    reference does).

    Returns int64 indices of the kept boxes by descending score.
    ``top_k=k``: a fixed [k] tensor, the first k kept indices padded with
    -1 (ties in input order). Without ``top_k`` the length is the number
    of boxes kept: this call reads the kept flags and the scores back to
    the host and orders the kept indices there with numpy's argsort, as
    the reference does (its order of tied scores included), then returns
    them on the boxes' device. Either way the fixed point of
    ``_greedy_keep`` reads one flag back every ``NMS_ROUNDS_PER_READ``
    rounds (``nms.host_reads`` counts every read)."""
    b = _f32(boxes)
    n = b.shape[0]
    s = (torch.arange(n, 0, -1, dtype=torch.float32, device=b.device)
         if scores is None else _f32(scores, b.device))
    if category_idxs is not None:
        cidx = _f32(category_idxs, b.device)
        span = b.max() - b.min() + 1.0
        b = b + (cidx * span)[:, None]
    iou = pairwise_iou(b, b)[0]
    order = torch.argsort(-s, stable=True)
    iou_sorted = iou[order][:, order]
    tri = torch.tril(iou_sorted > iou_threshold, diagonal=-1)
    keep_sorted, reads = _greedy_keep(tri)
    nms.host_reads += reads
    keep = torch.empty_like(keep_sorted)
    keep[order] = keep_sorted
    if top_k is not None:
        score_keep = torch.where(keep, s, torch.full_like(s, -math.inf))
        idx = torch.argsort(-score_keep, stable=True)[:int(top_k)]
        return torch.where(keep[idx], idx, torch.full_like(idx, -1))
    nms.host_reads += 2
    keep_np, s_np = (t.cpu().numpy() for t in (keep, s))
    kept = np.nonzero(keep_np)[0]
    kept = kept[np.argsort(-s_np[kept])]
    return torch.from_numpy(kept.astype(np.int64)).to(b.device)


nms.host_reads = 0


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              name=None):
    """ref: box_coder — center-size encoding of ``target_box`` [N, 4]
    against every prior [M, 4] (-> [N, M, 4]), or decoding of offsets
    [N, M, 4] (priors along ``axis``). ``prior_box_var`` is one variance
    of 4 or one a prior [M, 4]."""
    pb = _f32(prior_box)
    pbv = _f32(prior_box_var, pb.device)
    tb = _f32(target_box, pb.device)
    norm = 0.0 if box_normalized else 1.0
    pw = pb[:, 2] - pb[:, 0] + norm
    ph = pb[:, 3] - pb[:, 1] + norm
    pcx = pb[:, 0] + pw / 2
    pcy = pb[:, 1] + ph / 2
    if code_type == "encode_center_size":
        tw = tb[:, None, 2] - tb[:, None, 0] + norm
        th = tb[:, None, 3] - tb[:, None, 1] + norm
        tcx = tb[:, None, 0] + tw / 2
        tcy = tb[:, None, 1] + th / 2
        out = torch.stack([(tcx - pcx[None]) / pw[None],
                           (tcy - pcy[None]) / ph[None],
                           torch.log(tw / pw[None]),
                           torch.log(th / ph[None])], -1)
        return out / pbv.reshape((1, -1, 4) if pbv.dim() == 2 else (1, 1, 4))
    if code_type == "decode_center_size":
        v = pbv if pbv.dim() == 2 else pbv.reshape(1, 4).expand(pb.shape)
        if axis == 0:
            prior = (pcx[None, :], pcy[None, :], pw[None, :], ph[None, :])
            var = v[None, :, :]
        else:
            prior = (pcx[:, None], pcy[:, None], pw[:, None], ph[:, None])
            var = v[:, None, :]
        dcx = var[..., 0] * tb[..., 0] * prior[2] + prior[0]
        dcy = var[..., 1] * tb[..., 1] * prior[3] + prior[1]
        dw = torch.exp(var[..., 2] * tb[..., 2]) * prior[2]
        dh = torch.exp(var[..., 3] * tb[..., 3]) * prior[3]
        return torch.stack([dcx - dw / 2, dcy - dh / 2,
                            dcx + dw / 2 - norm, dcy + dh / 2 - norm], -1)
    raise ValueError(f"unknown code_type {code_type!r}")


def yolo_box(x, img_size, anchors, class_num, conf_thresh, downsample_ratio,
             clip_bbox=True, scale_x_y=1.0, iou_aware=False,
             iou_aware_factor=0.5, name=None):
    """ref: yolo_box — decode a YOLO head [B, na * (5 + C), H, W] (with
    ``iou_aware``, na IoU channels first) against ``img_size`` [B, 2]
    (h, w) -> (boxes [B, H * W * na, 4] in pixels, scores [B, H * W * na,
    C]), both zero where the objectness is at most ``conf_thresh``."""
    na = len(anchors) // 2
    anc = _f32(np.asarray(anchors, np.float32).reshape(na, 2), x.device)
    imgs = _f32(img_size, x.device)
    b, _, h, w = x.shape
    if iou_aware:
        iou_p = torch.sigmoid(x[:, :na].reshape(b, na, h, w))
        v = x[:, na:].reshape(b, na, 5 + class_num, h, w)
    else:
        v = x.reshape(b, na, 5 + class_num, h, w)
    gx = torch.arange(w, dtype=torch.float32, device=x.device)[None, None,
                                                                 None, :]
    gy = torch.arange(h, dtype=torch.float32, device=x.device)[None, None,
                                                                 :, None]
    alpha, beta = scale_x_y, -0.5 * (scale_x_y - 1.0)
    cx = (torch.sigmoid(v[:, :, 0]) * alpha + beta + gx) / w
    cy = (torch.sigmoid(v[:, :, 1]) * alpha + beta + gy) / h
    in_w, in_h = w * downsample_ratio, h * downsample_ratio
    bw = torch.exp(v[:, :, 2]) * anc[None, :, 0, None, None] / in_w
    bh = torch.exp(v[:, :, 3]) * anc[None, :, 1, None, None] / in_h
    obj = torch.sigmoid(v[:, :, 4])
    if iou_aware:
        obj = (torch.pow(obj, 1.0 - iou_aware_factor)
               * torch.pow(iou_p, iou_aware_factor))
    conf = obj[:, :, None] * torch.sigmoid(v[:, :, 5:])   # [B, na, C, H, W]
    imw = imgs[:, 1][:, None, None, None]
    imh = imgs[:, 0][:, None, None, None]
    x0 = (cx - bw / 2) * imw
    y0 = (cy - bh / 2) * imh
    x1 = (cx + bw / 2) * imw
    y1 = (cy + bh / 2) * imh
    if clip_bbox:
        zero = torch.zeros_like(imw)
        x0 = torch.clamp(x0, zero, imw - 1)
        y0 = torch.clamp(y0, zero, imh - 1)
        x1 = torch.clamp(x1, zero, imw - 1)
        y1 = torch.clamp(y1, zero, imh - 1)
    boxes = torch.stack([x0, y0, x1, y1], -1)              # [B, na, H, W, 4]
    keep = (obj > conf_thresh)[..., None]
    boxes = torch.where(keep, boxes, torch.zeros_like(boxes))
    conf = conf.movedim(2, -1)                             # [B, na, H, W, C]
    conf = torch.where(keep, conf, torch.zeros_like(conf))
    return boxes.reshape(b, -1, 4), conf.reshape(b, -1, class_num)


# -- RoI ops -------------------------------------------------------------------

def _image_of_roi(boxes_num, n_rois, device):
    """[R] image index of each RoI, from boxes_num (RoIs an image, in
    order) without reading it back."""
    bn = torch.as_tensor(boxes_num).to(device, non_blocking=True)
    bn = bn.long().reshape(-1)
    return torch.repeat_interleave(
        torch.arange(bn.shape[0], device=device), bn, output_size=n_rois)


def _corners(ys, xs, h, w):
    """The reference's bilinear weights at float coordinates ``ys``,
    ``xs`` (broadcast together): four (row, column, weight) corners, the
    rows and columns clipped into the map, the weights zero outside
    [-1, H] x [-1, W]."""
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = ys - y0, xs - x0
    wy0, wx0 = 1 - wy1, 1 - wx1
    valid = ((ys >= -1) & (ys <= h) & (xs >= -1) & (xs <= w)).float()
    out = []
    for yy, xx, wgt in ((y0, x0, wy0 * wx0), (y0, x0 + 1, wy0 * wx1),
                        (y0 + 1, x0, wy1 * wx0), (y0 + 1, x0 + 1, wy1 * wx1)):
        yi = yy.clamp(0, h - 1).long()
        xi = xx.clamp(0, w - 1).long()
        out.append((yi, xi, wgt * valid))
    return out


def _bilinear_rows(rows, base, ys, xs, h, w):
    """Bilinear samples of a channels-last map ``rows`` ([N * H * W, C]):
    ``base`` (broadcast with ys, xs) is each sample's image offset N * H
    * W. -> [..., C], the corners added in the reference's order."""
    out = None
    for yi, xi, wgt in _corners(ys, xs, h, w):
        g = rows[base + yi * w + xi] * wgt[..., None]
        out = g if out is None else out + g
    return out


def _roi_grid(bx, oh, ow, sr, min_size):
    """Sample coordinates of every RoI ([R, 4] xyxy, already scaled and
    shifted): ys [R, oh * sr], xs [R, ow * sr] at the centres of an
    (oh * sr) x (ow * sr) grid over each box."""
    rw = torch.clamp(bx[:, 2] - bx[:, 0], min=min_size)
    rh = torch.clamp(bx[:, 3] - bx[:, 1], min=min_size)
    gy = (torch.arange(oh * sr, dtype=torch.float32, device=bx.device)
          + 0.5) / (oh * sr)
    gx = (torch.arange(ow * sr, dtype=torch.float32, device=bx.device)
          + 0.5) / (ow * sr)
    return (bx[:, 1, None] + gy[None, :] * rh[:, None],
            bx[:, 0, None] + gx[None, :] * rw[:, None])


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """ref: roi_align — x [B, C, H, W]; boxes [R, 4] xyxy over the batch
    (``boxes_num[i]`` RoIs of image i, in order) -> [R, C, oh, ow]: each
    bin the mean of sr x sr bilinear samples at the centres of its
    sub-cells, sr = ``sampling_ratio``, or 2 where it is not positive (the
    reference's static grid). ``aligned`` shifts the boxes by half a
    pixel."""
    oh, ow = _pair(output_size)
    sr = sampling_ratio if sampling_ratio > 0 else 2
    bsz, c, h, w = x.shape
    bx = _f32(boxes, x.device) * spatial_scale - (0.5 if aligned else 0.0)
    img = _image_of_roi(boxes_num, bx.shape[0], x.device)
    ys, xs = _roi_grid(bx, oh, ow, sr, 1e-3 if aligned else 1.0)
    rows = x.permute(0, 2, 3, 1).reshape(-1, c)
    base = (img * (h * w))[:, None, None]
    s = _bilinear_rows(rows, base, ys[:, :, None], xs[:, None, :], h, w)
    s = s.reshape(-1, oh, sr, ow, sr, c).mean((2, 4))     # [R, oh, ow, C]
    return s.permute(0, 3, 1, 2)


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
             name=None):
    """ref: roi_pool — the max of each bin over an 8 x 8 sample grid
    snapped down to pixels (exact where a bin spans at most 8 pixels a
    side, a subsampled max beyond; the reference's static-shape form)."""
    oh, ow = _pair(output_size)
    sr = 8
    bsz, c, h, w = x.shape
    bx = _f32(boxes, x.device) * spatial_scale
    img = _image_of_roi(boxes_num, bx.shape[0], x.device)
    ys, xs = _roi_grid(bx, oh, ow, sr, 1.0)
    yi = torch.floor(ys).clamp(0, h - 1).long()
    xi = torch.floor(xs).clamp(0, w - 1).long()
    rows = x.permute(0, 2, 3, 1).reshape(-1, c)
    idx = (img * (h * w))[:, None, None] + yi[:, :, None] * w \
        + xi[:, None, :]
    s = rows[idx].reshape(-1, oh, sr, ow, sr, c).amax((2, 4))
    return s.permute(0, 3, 1, 2)


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False, rois_num=None,
                             name=None):
    """ref: distribute_fpn_proposals — the FPN level of each RoI, floor(
    log2(sqrt(area) / refer_scale)) + refer_level clipped to [min_level,
    max_level], as (level [R] int32, masks [L, R] f32 one-hot). The
    reference's static-shape form: callers select with the masks instead
    of gathering ragged per-level lists, so nothing is read back."""
    rois = _f32(fpn_rois)
    off = 1.0 if pixel_offset else 0.0
    w = rois[:, 2] - rois[:, 0] + off
    h = rois[:, 3] - rois[:, 1] + off
    scale = torch.sqrt(torch.clamp(w * h, min=1e-9))
    lvl = torch.floor(torch.log2(scale / refer_scale + 1e-9)) + refer_level
    lvl = torch.clamp(lvl, min_level, max_level).to(torch.int32)
    n_levels = max_level - min_level + 1
    masks = torch.nn.functional.one_hot((lvl - min_level).long(),
                                        n_levels).float().T
    return lvl, masks


# -- deformable convolution ------------------------------------------------------

def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """ref: deform_conv2d (v1; v2 with ``mask``): bilinear samples of the
    kh * kw deformed taps at every output position, then one contraction
    with the kernel. x [B, Cin, H, W]; offset [B, 2 * dg * kh * kw, Ho,
    Wo] as (dg, tap, (dy, dx)); weight [Cout, Cin / groups, kh, kw]; mask
    [B, dg * kh * kw, Ho, Wo]."""
    st, pd, dl = _pair(stride), _pair(padding), _pair(dilation)
    cout, cin_g, kh, kw = weight.shape
    b, cin, h, w = x.shape
    k = kh * kw
    ho = (h + 2 * pd[0] - dl[0] * (kh - 1) - 1) // st[0] + 1
    wo = (w + 2 * pd[1] - dl[1] * (kw - 1) - 1) // st[1] + 1
    dg = deformable_groups
    cpg = cin // dg
    off = offset.reshape(b, dg, k, 2, ho, wo)
    dev = x.device
    oy = torch.arange(ho, dtype=torch.float32, device=dev) * st[0] - pd[0]
    ox = torch.arange(wo, dtype=torch.float32, device=dev) * st[1] - pd[1]
    # taps row-major, the offset channels' (tap) order
    ky = (torch.arange(kh, dtype=torch.float32, device=dev)
          * dl[0]).repeat_interleave(kw)
    kx = (torch.arange(kw, dtype=torch.float32, device=dev) * dl[1]).repeat(kh)
    ys = oy[None, :, None] + ky[:, None, None] + off[:, :, :, 0]
    xs = ox[None, None, :] + kx[:, None, None] + off[:, :, :, 1]
    # [B, dg, K, Ho, Wo] coordinates into each (image, group)'s map,
    # gathered from a channels-last view of its cpg channels
    rows = x.reshape(b, dg, cpg, h, w).permute(0, 1, 3, 4, 2).reshape(-1,
                                                                       cpg)
    base = (torch.arange(b * dg, device=dev) * (h * w)).reshape(b, dg, 1, 1,
                                                                1)
    cols = _bilinear_rows(rows, base, ys, xs, h, w)  # [B, dg, K, Ho, Wo, cpg]
    if mask is not None:
        cols = cols * mask.reshape(b, dg, k, ho, wo, 1)
    cols = cols.permute(0, 1, 5, 2, 3, 4).reshape(b, cin, k, ho, wo)
    w2 = weight.reshape(cout, cin_g, k)
    if groups == 1:
        out = torch.einsum("bckhw,ock->bohw", cols, w2)
    else:
        out = torch.einsum(
            "bgckhw,gock->bgohw",
            cols.reshape(b, groups, cin // groups, k, ho, wo),
            w2.reshape(groups, cout // groups, cin_g, k)).reshape(
                b, cout, ho, wo)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


class DeformConv2D(nn.Module):
    """ref: DeformConv2D — weight [out, in / groups, kh, kw] drawn
    Xavier-uniform, bias zeros (``bias_attr=False`` drops it)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        if weight_attr is not None or bias_attr not in (None, False):
            from ..framework import later
            raise NotImplementedError(f"DeformConv2D weight_attr/bias_attr "
                                      f"(nn/initializer.py) {later('1.6')}")
        kw = model_kw(device, dtype, generator)
        ks = _pair(kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._deformable_groups = deformable_groups
        self._groups = groups
        shape = (out_channels, in_channels // groups) + ks
        rf = ks[0] * ks[1]
        self.weight = make_param(shape, device=kw["device"],
                                 dtype=kw["dtype"], init="xavier",
                                 generator=kw["generator"],
                                 fans=(shape[1] * rf, shape[0] * rf))
        self.bias = None if bias_attr is False else make_param(
            (out_channels,), device=kw["device"], dtype=kw["dtype"])

    def forward(self, x, offset, mask=None):
        return deform_conv2d(
            x, offset, self.weight, self.bias, stride=self._stride,
            padding=self._padding, dilation=self._dilation,
            deformable_groups=self._deformable_groups, groups=self._groups,
            mask=mask)


class RoIAlign(nn.Module):
    """ref: RoIAlign."""

    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_align(x, boxes, boxes_num, self._output_size,
                         self._spatial_scale)


class RoIPool(nn.Module):
    """ref: RoIPool."""

    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self._output_size,
                        self._spatial_scale)


class PSRoIPool(nn.Module):
    """ref: PSRoIPool — position-sensitive RoI average pooling: output
    channel c of bin (i, j) averages 2 x 2 bilinear samples of input
    channel c * oh * ow + i * ow + j over that bin only (boxes scaled,
    not shifted; each side at least 0.1)."""

    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = _pair(output_size)
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        oh, ow = self._output_size
        sr = 2
        bsz, c_total, h, w = x.shape
        c_out = c_total // (oh * ow)
        bx = _f32(boxes, x.device) * self._spatial_scale
        img = _image_of_roi(boxes_num, bx.shape[0], x.device)
        ys, xs = _roi_grid(bx, oh, ow, sr, 0.1)
        ys = ys.reshape(-1, 1, oh, 1, sr, 1)     # [R, c, i, j, sy, sx]
        xs = xs.reshape(-1, 1, 1, ow, 1, sr)
        dev = x.device
        ch = (torch.arange(c_out, device=dev)[:, None, None] * (oh * ow)
              + torch.arange(oh, device=dev)[None, :, None] * ow
              + torch.arange(ow, device=dev)[None, None, :])
        # the flat NCHW offset of each (RoI, output channel, bin)'s plane
        plane = ((img[:, None, None, None] * c_total + ch[None]) * (h * w)
                 )[..., None, None]
        flat = x.reshape(-1)
        out = None
        for yi, xi, wgt in _corners(ys, xs, h, w):
            g = flat[plane + yi * w + xi] * wgt
            out = g if out is None else out + g
        return out.mean((4, 5))
