"""DETR of the port, the inference path (counterpart of
``paddle_tpu/vision/models/detection/detr.py``; ref: PaddleDetection
ppdet/modeling/architectures/detr.py and transformers/
detr_transformer.py).

A ResNet backbone (``resnet50``/``resnet18`` with no classifier and no
pool, or the ``tiny`` 4-conv stack), a 1x1 input projection, the 2D sine
position embedding added once to the encoder input and the learned
queries to the decoder's (as the reference does), ``nn.Transformer``, and
the class and box heads. The reference's layer and parameter names, so a
reference ``state_dict`` loads key for key through
``nlp.convert.load_numpy_state`` (a ResNet backbone built NHWC, the
default on the card, takes the HWIO kernels of a reference converted with
``to_channels_last``).

On the card every attention of the transformer runs kernel #1's f32
forward at DETR's head_dim 32 (d_model 256, 8 heads): per forward, one
launch a layer over the encoder's tokens, two a decoder layer (100
queries against themselves, then against the encoder's tokens); in
training the f32 backward, #3 (dq) and #4 (dk/dv), as many times.

The training loss ``DETRLoss`` (eos-weighted CE + L1 + GIoU on the
matched pairs) and its matcher ``auction_match``, the reference's
in-graph Bertsekas auction, run on the card over the whole batch at once:
one [B, Q, M] auction whose stop condition is read back once every
``AUCTION_CHECK_EVERY`` iterations.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ....framework import bind_generator
from ....nlp.modeling_utils import model_kw
from ....nn import functional as F
from ....nn.layers_activation import ReLU
from ....nn.layers_common import Embedding, LayerList, Linear, Sequential
from ....nn.layers_conv import Conv2D
from ....nn.layers_norm import BatchNorm2D
from ....nn.layers_transformer import Transformer
from ..resnet import resnet18, resnet50
from .box_utils import cxcywh_to_xyxy, elementwise_giou, pairwise_giou

__all__ = ["DETR", "DETRLoss", "MLP", "auction_match",
           "sine_position_embedding"]


def sine_position_embedding(h, w, dim, temperature=10000.0, device=None):
    """2D sine embeddings [h*w, dim] f32 on ``device``: the JAX package's
    frequencies (temperature^(2 i / (dim / 2)) for i < dim / 4) and its
    order, sin then cos over the rows' y, then over the columns' x."""
    half = dim // 2
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    freqs = temperature ** (2 * (np.arange(half // 2) // 1) / half)

    def enc(v):
        v = v.reshape(-1)[:, None] / freqs[None, :]
        return np.concatenate([np.sin(v), np.cos(v)], -1)
    emb = np.concatenate([enc(ys), enc(xs)], -1)
    return torch.from_numpy(emb.astype(np.float32)).to(device)


# iterations run between two host reads of the stop condition: once an
# image has no unassigned valid gt an iteration leaves its state as it is,
# so the batch runs in chunks and reads back one bool a chunk
AUCTION_CHECK_EVERY = 16


@torch.no_grad()
def auction_match(cost, valid, eps=1e-3, max_iter=2000):
    """eps-optimal min-cost bipartite matching on the cost's device, the
    JAX package's Bertsekas auction (Jacobi variant: every unassigned gt
    bids for its best query each round, the highest bid per query wins).

    cost [Q, M] (one image, as the reference takes it) or [B, Q, M] (a
    batch, matched together), valid [M] / [B, M] bool. Returns match
    [M] / [B, M] int64: the query of each gt (0 for invalid gts, and for a
    gt still unassigned when ``max_iter`` cut the auction).

    The reference stops in its graph (``lax.while_loop``); here the stop
    condition is read back on the host once every ``AUCTION_CHECK_EVERY``
    iterations, and the run ends at exactly ``max_iter``, so a capped run
    ends in the reference's state. Ties go to the lower index, as
    ``lax.top_k`` and ``jnp.argmax`` break them: the best query by
    ``argmax``, the second value by ``max`` with the best masked.
    ``auction_match.host_syncs`` and ``auction_match.iterations`` count
    the reads and the iterations run."""
    single = cost.dim() == 2
    if single:
        cost, valid = cost[None], valid[None]
    b, qn, m = cost.shape
    value = -cost
    dev, dt = cost.device, cost.dtype
    big_neg = torch.tensor(-1e9, dtype=dt, device=dev)
    valid = valid.to(device=dev, dtype=torch.bool)
    price = torch.zeros(b, qn, dtype=dt, device=dev)
    owner = torch.full((b, qn), -1, dtype=torch.int64, device=dev)
    match = torch.where(valid, -1, 0).to(torch.int64)
    gts = torch.arange(m, device=dev)
    queries = torch.arange(qn, device=dev)[None, :, None]
    it = 0
    while it < max_iter:
        for _ in range(min(AUCTION_CHECK_EVERY, max_iter - it)):
            unassigned = (match < 0) & valid                   # [B, M]
            net = value - price[:, :, None]                    # [B, Q, M]
            best_q = net.argmax(1)                             # [B, M]
            top = net.gather(1, best_q[:, None])[:, 0]
            second = net.scatter(1, best_q[:, None],
                                 float("-inf")).amax(1)
            bid = price.gather(1, best_q) + (top - second) + eps
            to_q = best_q[:, None, :] == queries               # [B, Q, M]
            bid_mat = torch.where(to_q & unassigned[:, None, :],
                                  bid[:, None, :], big_neg)
            win_bid, win_gt = bid_mat.max(2).values, bid_mat.argmax(2)
            got_bid = win_bid > big_neg / 2
            # evict the previous owners of re-auctioned queries
            evicted = (match >= 0) & got_bid.gather(1, match.clamp(0,
                                                                   qn - 1))
            match = torch.where(evicted, -1, match)
            price = torch.where(got_bid, win_bid, price)
            owner = torch.where(got_bid, win_gt, owner)
            # the winners take their queries
            won = (unassigned & (owner.gather(1, best_q) == gts)
                   & got_bid.gather(1, best_q))
            match = torch.where(won, best_q, match)
            it += 1
        auction_match.host_syncs += 1
        if not bool(((match < 0) & valid).any()):
            break
    auction_match.iterations += it
    match = match.clamp(0, qn - 1)
    return match[0] if single else match


auction_match.host_syncs = 0
auction_match.iterations = 0


class MLP(nn.Module):
    def __init__(self, in_dim, hidden, out_dim, n_layers=3, **kw):
        super().__init__()
        dims = [in_dim] + [hidden] * (n_layers - 1) + [out_dim]
        self.layers = LayerList([Linear(dims[i], dims[i + 1], **kw)
                                 for i in range(n_layers)])
        self.act = ReLU()

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.act(x)
        return x


class DETR(nn.Module):
    """ref: ppdet/modeling/architectures/detr.py; plus ``layout`` (of a
    ResNet backbone: 'auto' is NHWC on the card, NCHW on the CPU),
    ``device``, ``dtype`` and ``generator`` (CUDA unless the caller
    passes ``device="cpu"``).

    forward(images [B, 3, H, W]):
      train: (class_logits [B, Q, NC + 1], pred_boxes [B, Q, 4] cxcywh in
      [0, 1]);
      eval: (boxes [B, Q, 4] xyxy in pixels, class_probs [B, Q, NC + 1]).
    """

    def __init__(self, num_classes=80, num_queries=100, d_model=256,
                 nhead=8, num_encoder_layers=6, num_decoder_layers=6,
                 dim_feedforward=2048, backbone="resnet50", dropout=0.1, *,
                 layout="auto", device=None, dtype=None, generator=None):
        super().__init__()
        kw = model_kw(device, dtype, generator)
        dk = dict(device=kw["device"], dtype=kw["dtype"])
        if backbone in ("resnet50", "resnet18"):
            make = resnet50 if backbone == "resnet50" else resnet18
            self.backbone = make(num_classes=0, with_pool=False,
                                 layout=layout, **kw)
            c_feat = 2048 if backbone == "resnet50" else 512
        elif backbone == "tiny":  # 4-conv stride-16 stack for tests/smoke
            c_feat = 64
            self.backbone = Sequential(
                Conv2D(3, 16, 3, stride=2, padding=1, **kw),
                BatchNorm2D(16, **dk), ReLU(),
                Conv2D(16, 32, 3, stride=2, padding=1, **kw),
                BatchNorm2D(32, **dk), ReLU(),
                Conv2D(32, 64, 3, stride=2, padding=1, **kw),
                BatchNorm2D(64, **dk), ReLU(),
                Conv2D(64, c_feat, 3, stride=2, padding=1, **kw),
                BatchNorm2D(c_feat, **dk), ReLU())
        else:
            raise ValueError(
                f"unknown backbone {backbone!r}; expected 'resnet50', "
                "'resnet18' or 'tiny'")
        self.input_proj = Conv2D(c_feat, d_model, 1, **kw)
        self.transformer = Transformer(
            d_model, nhead, num_encoder_layers, num_decoder_layers,
            dim_feedforward, dropout, **kw)
        self.query_embed = Embedding(num_queries, d_model, **kw)
        self.class_head = Linear(d_model, num_classes + 1, **kw)
        self.bbox_head = MLP(d_model, d_model, 4, **kw)
        self.num_queries = num_queries
        self.num_classes = num_classes
        self.d_model = d_model
        self._consts = {}
        # hidden and attention dropout draw from the model's generator
        bind_generator(self, kw["generator"])

    def _constants(self, h, w, d, ih, iw, device):
        """(the sine embedding of an h x w map, the [iw, ih, iw, ih] pixel
        scale of the boxes), made once per size and device and kept there,
        so a forward copies nothing from the host."""
        key = (h, w, d, ih, iw, device)
        if key not in self._consts:
            self._consts[key] = (
                sine_position_embedding(h, w, d, device=device),
                torch.tensor([iw, ih, iw, ih], dtype=torch.float32).to(
                    device))
        return self._consts[key]

    def forward(self, images):
        feat = self.input_proj(self.backbone(images))      # [B, D, H, W]
        b, d, h, w = feat.shape
        pos, scale = self._constants(h, w, d, images.shape[2],
                                     images.shape[3], feat.device)
        src = feat.reshape(b, d, h * w).transpose(1, 2)
        src = src + pos[None].to(src.dtype)
        tgt = self.query_embed.weight[None].expand(b, -1, -1)
        hs = self.transformer(src, tgt)                    # [B, Q, D]
        logits = self.class_head(hs)
        boxes = F.sigmoid(self.bbox_head(hs))              # cxcywh in [0,1]
        if self.training:
            return logits, boxes
        return cxcywh_to_xyxy(boxes) * scale, F.softmax(logits, axis=-1)


class DETRLoss(nn.Module):
    """The Hungarian set loss (ref: ppdet/modeling/losses/detr_loss.py):
    the eos-weighted CE over every query, and L1 + GIoU on the matched
    pairs, per image, then the mean over images.

    forward(logits [B, Q, NC + 1], boxes [B, Q, 4] cxcywh in [0, 1],
    gt_boxes [B, M, 4] cxcywh normalised, gt_class [B, M], gt_mask [B, M])
    -> a scalar. The cost ``cc * (-prob[:, gc]) + cl * L1 + cg * (-GIoU)``
    is matched by ``auction_match`` on a detached copy (no gradient through
    the matching, as the reference stops it), the batch in one auction on
    the inputs' device. Padded gts never clobber a real match: only valid
    gts write their class into the queries' targets.

    ``host_reads`` declares that the loss reads the device from the host
    (the auction's convergence check): a CUDA graph cannot record it, so
    an ``Engine`` runs this loss's steps eagerly and says why."""

    host_reads = ("DETRLoss: auction_match reads its convergence check back "
                  "to the host every AUCTION_CHECK_EVERY iterations")

    def __init__(self, num_classes, eos_coef=0.1, w_class=1.0, w_l1=5.0,
                 w_giou=2.0, cost_class=1.0, cost_l1=5.0, cost_giou=2.0):
        super().__init__()
        self.num_classes = num_classes
        self.eos_coef = eos_coef
        self.w = (w_class, w_l1, w_giou)
        self.cost_w = (cost_class, cost_l1, cost_giou)

    def cost(self, logits, boxes, gt_boxes, gt_class):
        """The matching cost [B, Q, M] (detached)."""
        cc, cl, cg = self.cost_w
        with torch.no_grad():
            prob = torch.softmax(logits, -1)
            q = prob.shape[1]
            c_cls = -prob.gather(
                2, gt_class[:, None, :].expand(-1, q, -1))
            c_l1 = (boxes[:, :, None] - gt_boxes[:, None]).abs().sum(-1)
            c_giou = -torch.vmap(pairwise_giou)(cxcywh_to_xyxy(boxes),
                                                cxcywh_to_xyxy(gt_boxes))
            return cc * c_cls + cl * c_l1 + cg * c_giou

    def forward(self, logits, boxes, gt_boxes, gt_class, gt_mask):
        nc, eos = self.num_classes, self.eos_coef
        wc, wl, wg = self.w
        logits, boxes = logits.float(), boxes.float()
        gt_boxes = gt_boxes.to(boxes)
        gt_class = gt_class.to(device=logits.device, dtype=torch.int64)
        mvalid = gt_mask.to(logits.device) > 0                     # [B, M]
        b, q, _ = logits.shape
        match = auction_match(self.cost(logits, boxes, gt_boxes, gt_class),
                              mvalid)                              # [B, M]

        # every query's target is no-object unless a valid gt matched it
        # (the padded gts write into a spare column q, dropped)
        tgt_cls = torch.full((b, q + 1), nc, dtype=torch.int64,
                             device=logits.device)
        tgt_cls.scatter_(1, torch.where(mvalid, match, q), gt_class)
        tgt_cls = tgt_cls[:, :q]
        logp = torch.log_softmax(logits, -1)
        ce = -logp.gather(2, tgt_cls[..., None])[..., 0]
        w_ce = torch.where(tgt_cls == nc, eos, 1.0)
        l_cls = (ce * w_ce).sum(1) / w_ce.sum(1)

        # the box losses on the matched pairs
        mf = mvalid.to(boxes.dtype)
        mb = boxes.gather(1, match[..., None].expand(-1, -1, 4))  # [B, M, 4]
        l_l1 = ((mb - gt_boxes).abs().sum(-1) * mf).sum(1)
        gi = elementwise_giou(cxcywh_to_xyxy(mb), cxcywh_to_xyxy(gt_boxes))
        l_giou = ((1.0 - gi) * mf).sum(1)
        n = mf.sum(1).clamp(min=1.0)
        return (wc * l_cls + (wl * l_l1 + wg * l_giou) / n).mean()
