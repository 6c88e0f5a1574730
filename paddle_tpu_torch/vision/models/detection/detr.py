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
queries against themselves, then against the encoder's tokens).

Not ported yet (raises NotImplementedError naming ROADMAP.md queue 1 item
6): the training loss, ``DETRLoss``, and its matcher ``auction_match``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ....framework import bind_generator, later
from ....nlp.modeling_utils import model_kw
from ....nn import functional as F
from ....nn.layers_activation import ReLU
from ....nn.layers_common import Embedding, LayerList, Linear, Sequential
from ....nn.layers_conv import Conv2D
from ....nn.layers_norm import BatchNorm2D
from ....nn.layers_transformer import Transformer
from ..resnet import resnet18, resnet50
from .box_utils import cxcywh_to_xyxy

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


def auction_match(*args, **kwargs):
    """The in-graph bipartite matcher of DETR's training loss."""
    raise NotImplementedError(f"auction_match {later('6')}")


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
    """The Hungarian set loss: CE + L1 + GIoU on matched pairs."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"DETRLoss {later('6')}")
