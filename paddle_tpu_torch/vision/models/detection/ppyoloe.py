"""PP-YOLOE of the port, the inference path (counterpart of
``paddle_tpu/vision/models/detection/ppyoloe.py``; ref: PaddleDetection
ppdet/modeling/architectures/ppyoloe.py, backbones/cspresnet.py,
necks/custom_pan.py, heads/ppyoloe_head.py).

The CSPResNet backbone, the CustomCSPPAN neck and the ET-head with its
DFL box decoding, NCHW, with the reference's layer and parameter names,
so a reference ``state_dict`` loads key for key through
``nlp.convert.load_numpy_state``. ``PPYOLOE.forward`` returns, in eval,
(boxes [B, A, 4] xyxy in pixels, scores [B, A, NC]) and, in training, the
raw (cls_logits, reg_dist, boxes). As in the reference there is no NMS in
the forward: ``multiclass_nms`` finishes on the host, in numpy. Every
convolution runs through PyTorch's (cuDNN on the card); no kernel of the
port is on this path. The anchors are a function of the feature sizes
alone and are kept on the device after the first forward of a size; each
forward leaves them in ``_last_anchors`` for the criterion.

Training: ``PPYOLOECriterion(model)`` drives ``PPYOLOELoss`` (VFL + GIoU
+ DFL) over the task-aligned assignment (``task_aligned_assign``), all on
the device and batched over the images, with no host sync.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ....nlp.modeling_utils import model_kw
from ....nn import functional as F
from ....nn.layers_activation import Silu
from ....nn.layers_common import LayerList, Sequential
from ....nn.layers_conv import Conv2D
from ....nn.layers_norm import BatchNorm2D
from .box_utils import elementwise_giou, pairwise_iou

__all__ = ["ConvBNLayer", "EffectiveSELayer", "RepVggBlock", "CSPResBlock",
           "CSPResStage", "CSPResNet", "CustomCSPPAN", "ESEHead",
           "PPYOLOEHead", "PPYOLOE", "PPYOLOELoss", "PPYOLOECriterion",
           "task_aligned_assign", "multiclass_nms"]


def _dk(kw):
    return dict(device=kw.get("device"), dtype=kw.get("dtype"))


class ConvBNLayer(nn.Module):
    def __init__(self, ch_in, ch_out, k=3, stride=1, groups=1, padding=None,
                 act=True, **kw):
        super().__init__()
        if padding is None:
            padding = (k - 1) // 2
        self.conv = Conv2D(ch_in, ch_out, k, stride=stride, padding=padding,
                           groups=groups, bias_attr=False, **kw)
        self.bn = BatchNorm2D(ch_out, **_dk(kw))
        self.act = Silu() if act else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act is not None else x


class EffectiveSELayer(nn.Module):
    """ESE attention (ref: cspresnet.py EffectiveSELayer): the channel
    means through a 1x1 conv, then x * hard_sigmoid, with the JAX
    package's relu6(w + 3) / 6."""

    def __init__(self, channels, **kw):
        super().__init__()
        self.fc = Conv2D(channels, channels, 1, **kw)

    def forward(self, x):
        w = self.fc(x.mean(dim=(2, 3), keepdim=True))
        return x * (torch.nn.functional.relu6(w + 3.0) / 6.0)


class RepVggBlock(nn.Module):
    """The training form of the RepVGG block: a 3x3 and a 1x1 branch
    summed, as the reference keeps it."""

    def __init__(self, ch_in, ch_out, **kw):
        super().__init__()
        self.conv1 = ConvBNLayer(ch_in, ch_out, 3, act=False, **kw)
        self.conv2 = ConvBNLayer(ch_in, ch_out, 1, act=False, **kw)
        self.act = Silu()

    def forward(self, x):
        return self.act(self.conv1(x) + self.conv2(x))


class CSPResBlock(nn.Module):
    def __init__(self, ch, shortcut=True, **kw):
        super().__init__()
        self.conv1 = ConvBNLayer(ch, ch, 3, **kw)
        self.conv2 = RepVggBlock(ch, ch, **kw)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return x + y if self.shortcut else y


class CSPResStage(nn.Module):
    def __init__(self, ch_in, ch_out, n, stride=2, use_attn=True, **kw):
        super().__init__()
        ch_mid = (ch_in + ch_out) // 2
        self.conv_down = (ConvBNLayer(ch_in, ch_mid, 3, stride=stride, **kw)
                          if stride > 1 else None)
        half = ch_mid // 2
        c1 = ch_mid if stride > 1 else ch_in
        self.conv1 = ConvBNLayer(c1, half, 1, **kw)
        self.conv2 = ConvBNLayer(c1, half, 1, **kw)
        self.blocks = Sequential(*[CSPResBlock(half, **kw)
                                   for _ in range(n)])
        self.attn = EffectiveSELayer(2 * half, **kw) if use_attn else None
        self.conv3 = ConvBNLayer(2 * half, ch_out, 1, **kw)

    def forward(self, x):
        if self.conv_down is not None:
            x = self.conv_down(x)
        y = torch.cat([self.conv1(x), self.blocks(self.conv2(x))], dim=1)
        if self.attn is not None:
            y = self.attn(y)
        return self.conv3(y)


class CSPResNet(nn.Module):
    """ref: ppdet/modeling/backbones/cspresnet.py. The stem is stride 2
    and each stage stride 2, so stage i sits at stride 2^(i + 2):
    ``return_idx`` (1, 2, 3) gives the heads' strides (8, 16, 32)."""

    def __init__(self, layers=(1, 1, 1, 1), channels=(32, 64, 128, 256, 512),
                 return_idx=(1, 2, 3), **kw):
        super().__init__()
        self.return_idx = tuple(return_idx)
        c = list(channels)
        self.stem = Sequential(
            ConvBNLayer(3, c[0] // 2, 3, stride=2, **kw),
            ConvBNLayer(c[0] // 2, c[0], 3, stride=1, **kw),
        )
        self.stages = LayerList([
            CSPResStage(c[i], c[i + 1], layers[i], stride=2, **kw)
            for i in range(len(layers))
        ])
        self.out_channels = [c[i + 1] for i in self.return_idx]
        self.out_strides = [2 ** (i + 2) for i in self.return_idx]

    def forward(self, x):
        x = self.stem(x)
        outs = []
        for i, st in enumerate(self.stages):
            x = st(x)
            if i in self.return_idx:
                outs.append(x)
        return outs


class CustomCSPPAN(nn.Module):
    """PAN neck: a top-down FPN path and a bottom-up path of CSP stages
    (ref: ppdet/modeling/necks/custom_pan.py)."""

    def __init__(self, in_channels, out_channels=None, **kw):
        super().__init__()
        n = len(in_channels)
        out_channels = out_channels or in_channels
        self.lateral = LayerList([
            ConvBNLayer(in_channels[i], out_channels[i], 1, **kw)
            for i in range(n)])
        self.fpn_blocks = LayerList([
            CSPResStage(out_channels[i] + out_channels[i + 1],
                        out_channels[i], 1, stride=1, use_attn=False, **kw)
            for i in range(n - 1)])
        self.down_convs = LayerList([
            ConvBNLayer(out_channels[i], out_channels[i], 3, stride=2, **kw)
            for i in range(n - 1)])
        self.pan_blocks = LayerList([
            CSPResStage(out_channels[i] + out_channels[i + 1],
                        out_channels[i + 1], 1, stride=1, use_attn=False,
                        **kw)
            for i in range(n - 1)])
        self.out_channels = list(out_channels)

    def forward(self, feats):
        lat = [layer(f) for layer, f in zip(self.lateral, feats)]
        for i in range(len(lat) - 2, -1, -1):  # top-down
            up = F.interpolate(lat[i + 1], scale_factor=2, mode="nearest")
            lat[i] = self.fpn_blocks[i](torch.cat([lat[i], up], dim=1))
        for i in range(len(lat) - 1):  # bottom-up
            down = self.down_convs[i](lat[i])
            lat[i + 1] = self.pan_blocks[i](
                torch.cat([down, lat[i + 1]], dim=1))
        return lat


class ESEHead(nn.Module):
    """One ET-head branch: ESE attention, a conv stem, a residual."""

    def __init__(self, ch, **kw):
        super().__init__()
        self.attn = EffectiveSELayer(ch, **kw)
        self.conv = ConvBNLayer(ch, ch, 3, **kw)

    def forward(self, x):
        return self.conv(self.attn(x)) + x


def _anchor_points(sizes, strides, device=None):
    """The anchor centres of every level: ([A, 2] (x, y) in pixels,
    [A] stride), f32 on ``device``."""
    pts, strs = [], []
    for (h, w), s in zip(sizes, strides):
        ys = (np.arange(h) + 0.5) * s
        xs = (np.arange(w) + 0.5) * s
        gx, gy = np.meshgrid(xs, ys)
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        strs.append(np.full((h * w,), s, np.float32))
    return (torch.from_numpy(np.concatenate(pts).astype(np.float32)).to(
                device),
            torch.from_numpy(np.concatenate(strs)).to(device))


def tal_metric(pred_scores, pred_boxes, anchors, gt_boxes, gt_class,
               gt_mask, alpha=1.0, beta=6.0):
    """The task-aligned metric of a batch -> (metric [B, A, M], 0 where the
    anchor's centre lies outside the gt or the gt is padding; iou [B, A,
    M]; that validity [B, A, M]): cls^alpha * iou^beta, with the shapes
    of ``task_aligned_assign``'s batched form."""
    a = pred_scores.shape[1]
    iou = torch.vmap(lambda p, g: pairwise_iou(p, g)[0])(
        pred_boxes, gt_boxes)                                # [B, A, M]
    cls = pred_scores.gather(2, gt_class.long()[:, None, :].expand(-1, a,
                                                                   -1))
    metric = (cls ** alpha) * (iou ** beta)
    # candidates: the anchor's centre inside the gt box
    ax, ay = anchors[None, :, None, 0], anchors[None, :, None, 1]
    gb = gt_boxes[:, None, :, :]
    inside = ((ax >= gb[..., 0]) & (ax <= gb[..., 2])
              & (ay >= gb[..., 1]) & (ay <= gb[..., 3]))
    valid = inside & (gt_mask[:, None, :] > 0)
    metric = torch.where(valid, metric, torch.zeros((), dtype=metric.dtype,
                                                    device=metric.device))
    return metric, iou, valid


def task_aligned_assign(pred_scores, pred_boxes, anchors, gt_boxes,
                        gt_class, gt_mask, alpha=1.0, beta=6.0, topk=13):
    """The task-aligned assigner (TAL; ref: ppdet/modeling/assigners/
    task_aligned_assigner.py) in the JAX package's static form, on the
    inputs' device, for one image or a batch at once.

    pred_scores [(B,) A, NC] (sigmoid), pred_boxes [(B,) A, 4] xyxy,
    anchors [A, 2], gt_boxes [(B,) M, 4], gt_class [(B,) M] int, gt_mask
    [(B,) M] {0, 1}. Returns (assigned_gt [(B,) A] int64, fg_mask [(B,)
    A] bool, target_score [(B,) A, NC]).

    The metric is cls^alpha * iou^beta over the anchors whose centre lies
    inside a valid gt; each gt keeps its top-k anchors (the k-th metric
    from ``topk``'s values alone, so ties there cannot matter); an anchor
    claimed by several gts goes to the one of largest metric (``argmax``:
    the first, as ``jnp.argmax``); the target score is the metric
    normalised by its gt's largest metric times the gt's largest IoU. The
    maxima are ``amax``, which shares a tie's gradient evenly, as JAX's
    max does: gradients flow through the scores into the target score, as
    in the reference."""
    single = pred_scores.dim() == 2
    if single:
        pred_scores, pred_boxes, gt_boxes, gt_class, gt_mask = (
            t[None] for t in (pred_scores, pred_boxes, gt_boxes, gt_class,
                              gt_mask))
    a, nc = pred_scores.shape[1:]
    gt_class = gt_class.long()
    metric, iou, valid = tal_metric(pred_scores, pred_boxes, anchors,
                                    gt_boxes, gt_class, gt_mask, alpha, beta)
    zero = torch.zeros((), dtype=metric.dtype, device=metric.device)

    # each gt's top-k anchors
    k = min(topk, a)
    thresh = metric.transpose(1, 2).topk(k, dim=-1).values[..., -1]
    is_topk = (metric >= thresh.clamp(min=1e-9)[:, None, :]) & valid
    cand = torch.where(is_topk, metric, zero)
    # conflicts: the anchor goes to the gt of largest metric
    assigned = cand.argmax(2)                                # [B, A]
    best = cand.amax(2)
    fg = best > 0.0

    # the normalised target score
    max_metric = cand.amax(1)                                # [B, M]
    max_iou = torch.where(is_topk, iou, zero).amax(1)
    norm = torch.where(max_metric > 0, max_iou / (max_metric + 1e-9), zero)
    t = best * norm.gather(1, assigned)
    onehot = torch.nn.functional.one_hot(gt_class.gather(1, assigned),
                                         nc).to(t.dtype)
    target_score = onehot * t[..., None] * fg[..., None]
    if single:
        return assigned[0], fg[0], target_score[0]
    return assigned, fg, target_score


class PPYOLOEHead(nn.Module):
    """ET-head: decoupled classification and regression, each behind ESE
    attention, with DFL box regression (ref: ppdet/modeling/heads/
    ppyoloe_head.py). ``proj`` (0 .. reg_max) is a buffer kept out of the
    state, as the reference keeps it out of its own."""

    def __init__(self, in_channels, num_classes=80, reg_max=16,
                 strides=(8, 16, 32), **kw):
        super().__init__()
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.strides = list(strides)
        self.stem_cls = LayerList([ESEHead(c, **kw) for c in in_channels])
        self.stem_reg = LayerList([ESEHead(c, **kw) for c in in_channels])
        self.pred_cls = LayerList([
            Conv2D(c, num_classes, 3, padding=1, **kw) for c in in_channels])
        self.pred_reg = LayerList([
            Conv2D(c, 4 * (reg_max + 1), 3, padding=1, **kw)
            for c in in_channels])
        self.register_buffer(
            "proj", torch.arange(reg_max + 1, dtype=torch.float32,
                                 device=kw.get("device")), persistent=False)

    def forward(self, feats):
        """(cls_logits [B, A, NC], reg_dist [B, A, 4, reg_max + 1],
        sizes [(h, w), ...])."""
        cls_out, reg_out, sizes = [], [], []
        for i, f in enumerate(feats):
            c = self.pred_cls[i](self.stem_cls[i](f))
            r = self.pred_reg[i](self.stem_reg[i](f))
            b, _, h, w = c.shape
            sizes.append((h, w))
            cls_out.append(c.reshape(b, self.num_classes, h * w)
                           .transpose(1, 2))
            reg_out.append(r.reshape(b, 4, self.reg_max + 1, h * w)
                           .permute(0, 3, 1, 2))
        return torch.cat(cls_out, dim=1), torch.cat(reg_out, dim=1), sizes

    def decode_boxes(self, reg_dist, anchors, strides):
        """The DFL expectation -> ltrb distances -> xyxy boxes [B, A, 4]."""
        dist = torch.softmax(reg_dist, dim=-1) @ self.proj.to(reg_dist.dtype)
        dist = dist * strides[None, :, None]
        ax, ay = anchors[None, :, 0], anchors[None, :, 1]
        return torch.stack([ax - dist[..., 0], ay - dist[..., 1],
                            ax + dist[..., 2], ay + dist[..., 3]], dim=-1)


class PPYOLOELoss(nn.Module):
    """VFL + GIoU + DFL over the task-aligned assignment (ref:
    ppyoloe_head.py get_loss), on the inputs' device, the batch at once.

    forward(cls_logits [B, A, NC], pred_boxes [B, A, 4] xyxy, reg_dist
    [B, A, 4, reg_max + 1], anchors [A, 2], strides [A], gt_boxes [B, M,
    4] xyxy in pixels, gt_class [B, M], gt_mask [B, M]) -> a scalar. The
    assignment runs on detached boxes (and on the live scores, as the
    reference's does)."""

    def __init__(self, num_classes=80, reg_max=16, w_cls=1.0, w_iou=2.5,
                 w_dfl=0.5):
        super().__init__()
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.w = (w_cls, w_iou, w_dfl)

    def forward(self, cls_logits, pred_boxes, reg_dist, anchors, strides,
                gt_boxes, gt_class, gt_mask):
        cls_logits, pred_boxes = cls_logits.float(), pred_boxes.float()
        reg_dist = reg_dist.float()
        dev = cls_logits.device
        gt_boxes = gt_boxes.to(device=dev, dtype=torch.float32)
        gt_class = gt_class.to(device=dev, dtype=torch.int64)
        gt_mask = gt_mask.to(dev)
        scores = torch.sigmoid(cls_logits)
        assigned, fg, tscore = task_aligned_assign(
            scores, pred_boxes.detach(), anchors, gt_boxes, gt_class,
            gt_mask)

        # varifocal loss (an IoU-aware classification target)
        q, p = tscore, scores
        w_vfl = torch.where(q > 0, q, 0.75 * (p ** 2))
        logsig = torch.nn.functional.logsigmoid
        bce = -(q * logsig(cls_logits) + (1 - q) * logsig(-cls_logits))
        n_pos = tscore.sum().clamp(min=1.0)
        l_cls = (w_vfl * bce).sum() / n_pos

        # the box losses on the foreground anchors
        tgt_box = gt_boxes.gather(1, assigned[..., None].expand(-1, -1, 4))
        giou = elementwise_giou(pred_boxes, tgt_box)
        wt = tscore.sum(-1) * fg
        l_iou = ((1.0 - giou) * wt).sum() / n_pos

        # DFL: the target distances in stride units, the two bins around
        # each, cross-entropy weighted by the distance to each
        ax, ay, st = anchors[None, :, 0], anchors[None, :, 1], strides[None]
        tdist = torch.stack([(ax - tgt_box[..., 0]) / st,
                             (ay - tgt_box[..., 1]) / st,
                             (tgt_box[..., 2] - ax) / st,
                             (tgt_box[..., 3] - ay) / st], -1)
        tdist = tdist.clamp(0, self.reg_max - 0.01)
        tl = torch.floor(tdist)
        wl = tl + 1.0 - tdist
        logp = torch.log_softmax(reg_dist, -1)
        li = tl.long()[..., None]
        ce = -(logp.gather(-1, li)[..., 0] * wl
               + logp.gather(-1, li + 1)[..., 0] * (1.0 - wl))
        l_dfl = (ce.mean(-1) * wt).sum() / n_pos

        wc, wi, wd = self.w
        return wc * l_cls + wi * l_iou + wd * l_dfl


class PPYOLOE(nn.Module):
    """ref: ppdet/modeling/architectures/ppyoloe.py; plus ``device``,
    ``dtype`` and ``generator`` (CUDA unless the caller passes
    ``device="cpu"``).

    Eval: forward(images) -> (boxes [B, A, 4], scores [B, A, NC]); finish
    with ``multiclass_nms`` on the host. Train: forward(images) ->
    (cls_logits, reg_dist, boxes)."""

    def __init__(self, num_classes=80, layers=(1, 1, 1, 1),
                 channels=(32, 64, 128, 256, 512), reg_max=16, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = model_kw(device, dtype, generator)
        self.backbone = CSPResNet(layers, channels, **kw)
        self.neck = CustomCSPPAN(self.backbone.out_channels, **kw)
        self.head = PPYOLOEHead(self.neck.out_channels, num_classes,
                                reg_max, strides=self.backbone.out_strides,
                                **kw)
        self.num_classes = num_classes
        self._anchors = {}
        self._last_anchors = None

    def forward(self, images):
        feats = self.neck(self.backbone(images))
        cls_logits, reg_dist, sizes = self.head(feats)
        key = (tuple(sizes), images.device)
        if key not in self._anchors:
            self._anchors[key] = _anchor_points(sizes, self.head.strides,
                                                images.device)
        # the anchors of this forward, read by PPYOLOECriterion
        self._last_anchors = self._anchors[key]
        boxes = self.head.decode_boxes(reg_dist, *self._last_anchors)
        if self.training:
            return cls_logits, reg_dist, boxes
        return boxes, F.sigmoid(cls_logits)


class PPYOLOECriterion(nn.Module):
    """The adapter that drives PPYOLOE from Engine/Model: loss(cls_logits,
    reg_dist, boxes, gt_boxes, gt_class, gt_mask), with the anchors of the
    model's last forward (``model._last_anchors``). The model is held in a
    one-element list, so the criterion does not register it as a
    submodule."""

    def __init__(self, model):
        super().__init__()
        self.loss = PPYOLOELoss(model.num_classes, model.head.reg_max)
        self._model = [model]

    def forward(self, cls_logits, reg_dist, boxes, gt_boxes, gt_class,
                gt_mask):
        anchors, strides = self._model[0]._last_anchors
        return self.loss(cls_logits, boxes, reg_dist, anchors, strides,
                         gt_boxes, gt_class, gt_mask)


def multiclass_nms(boxes, scores, score_thresh=0.05, iou_thresh=0.6,
                   max_dets=100):
    """Host-side NMS in numpy, the reference's own copy: per class, the
    boxes above ``score_thresh`` in order of score, each dropping the rest
    that overlap it above ``iou_thresh``; the survivors of every class
    sorted by score, at most ``max_dets``: [(class, score, box)]. boxes
    [A, 4], scores [A, NC], numpy arrays or tensors on any device."""
    boxes, scores = (a.detach().cpu().numpy() if torch.is_tensor(a)
                     else np.asarray(a) for a in (boxes, scores))
    out = []
    for c in range(scores.shape[1]):
        s = scores[:, c]
        keep = s > score_thresh
        b, s = boxes[keep], s[keep]
        order = np.argsort(-s)
        b, s = b[order], s[order]
        while len(b):
            out.append((c, float(s[0]), b[0]))
            if len(b) == 1:
                break
            x0 = np.maximum(b[0, 0], b[1:, 0])
            y0 = np.maximum(b[0, 1], b[1:, 1])
            x1 = np.minimum(b[0, 2], b[1:, 2])
            y1 = np.minimum(b[0, 3], b[1:, 3])
            inter = np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)
            area0 = (b[0, 2] - b[0, 0]) * (b[0, 3] - b[0, 1])
            area = (b[1:, 2] - b[1:, 0]) * (b[1:, 3] - b[1:, 1])
            iou = inter / (area0 + area - inter + 1e-9)
            keep_rest = iou <= iou_thresh
            b, s = b[1:][keep_rest], s[1:][keep_rest]
    out.sort(key=lambda r: -r[1])
    return out[:max_dets]
