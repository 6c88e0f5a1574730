"""Box utilities of the port (counterpart of
``paddle_tpu/vision/models/detection/box_utils.py``; ref:
ppdet/modeling/bbox_utils.py). Boxes are ``[..., 4]`` tensors, xyxy or
cxcywh as named."""
from __future__ import annotations

import torch

__all__ = ["cxcywh_to_xyxy", "xyxy_to_cxcywh", "box_area", "pairwise_iou",
           "pairwise_giou", "elementwise_giou"]


def cxcywh_to_xyxy(b):
    cx, cy, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def xyxy_to_cxcywh(b):
    x0, y0, x1, y1 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0],
                       dim=-1)


def box_area(b):
    return ((b[..., 2] - b[..., 0]).clamp(min=0)
            * (b[..., 3] - b[..., 1]).clamp(min=0))


def pairwise_iou(a, b):
    """a [N, 4], b [M, 4] xyxy -> (iou [N, M], union [N, M])."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[:, None] + box_area(b)[None, :] - inter
    return inter / (union + 1e-9), union


def pairwise_giou(a, b):
    iou, union = pairwise_iou(a, b)
    lt = torch.minimum(a[:, None, :2], b[None, :, :2])
    rb = torch.maximum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    hull = wh[..., 0] * wh[..., 1]
    return iou - (hull - union) / (hull + 1e-9)


def elementwise_giou(a, b):
    """a, b [..., 4] xyxy, aligned."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a) + box_area(b) - inter
    iou = inter / (union + 1e-9)
    lt_h = torch.minimum(a[..., :2], b[..., :2])
    rb_h = torch.maximum(a[..., 2:], b[..., 2:])
    wh_h = (rb_h - lt_h).clamp(min=0)
    hull = wh_h[..., 0] * wh_h[..., 1]
    return iou - (hull - union) / (hull + 1e-9)
