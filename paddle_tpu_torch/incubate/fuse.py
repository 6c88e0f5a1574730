"""Conv + BatchNorm folding for serving (counterpart of
``paddle_tpu/incubate/fuse.py``; ref: the reference's inference-time
``conv_bn_fuse_pass``). A frozen BatchNorm is an affine map per output
channel, so it folds into the preceding convolution's weight and bias:

    scale_c = gamma_c / sqrt(var_c + eps)
    W'[c]   = W[c] * scale_c
    b'_c    = (b_c - mean_c) * scale_c + beta_c

computed in f32 on the weights' device and stored in the convolution's
dtype. The fold is a module-tree transform applied in place to an
eval-mode model; the BatchNorms become ``Identity``. A folded convolution
carries a bias, so a ResNet bottleneck folded this way leaves the fused
1x1-conv route (kernel #11) for the plain convolutions.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["fuse_conv_bn"]


def _fold_pair(conv, bn):
    """Fold ``bn``'s running statistics and affine parameters into
    ``conv`` in place, per output channel: the first axis of an OIHW
    kernel, the last of an HWIO one (after ``to_channels_last``)."""
    with torch.no_grad():
        n = bn._num_features
        f32 = dict(dtype=torch.float32, device=conv.weight.device)
        gamma = (bn.weight.float() if bn.weight is not None
                 else torch.ones(n, **f32))
        beta = (bn.bias.float() if bn.bias is not None
                else torch.zeros(n, **f32))
        scale = gamma / torch.sqrt(bn._variance.float() + bn._epsilon)
        w = conv.weight.float()
        if conv._weight_format == "HWIO":
            w = w * scale
        else:
            w = w * scale.reshape((-1,) + (1,) * (w.dim() - 1))
        b = (conv.bias.float() if conv.bias is not None
             else torch.zeros(n, **f32))
        b = (b - bn._mean.float()) * scale + beta
        conv.weight.copy_(w)
        if conv.bias is None:
            conv.bias = nn.Parameter(b.to(conv.weight.dtype))
        else:
            conv.bias.copy_(b)


def fuse_conv_bn(model):
    """Fold every (convolution, BatchNorm) pair of ``model`` in place; the
    BatchNorms become ``Identity``. Eval mode only: a BatchNorm in
    training normalises by the batch's statistics, which cannot fold.
    The pairs recognised are the reference's:

    - a BatchNorm directly after a convolution in a ``Sequential``;
    - sibling attributes ``conv<suffix>`` / ``bn<suffix>`` (``conv1`` /
      ``bn1``, ``conv`` / ``bn``): the model zoo's convention.

    Returns (model, number of pairs folded)."""
    from ..nn.layers_common import Identity
    from ..nn.layers_conv import _ConvNd
    from ..nn.layers_norm import _BatchNormBase

    if model.training:
        raise ValueError(
            "fuse_conv_bn folds the running statistics of FROZEN "
            "BatchNorms: call model.eval() first (training-mode BN "
            "normalizes by batch stats, which cannot fold)")
    n = 0

    def walk(layer):
        nonlocal n
        if isinstance(layer, nn.Sequential):
            kids = list(layer._modules.items())
            for (_, a), (k2, b) in zip(kids, kids[1:]):
                if isinstance(a, _ConvNd) and isinstance(b, _BatchNormBase):
                    _fold_pair(a, b)
                    setattr(layer, k2, Identity())
                    n += 1
        for cname in list(layer._modules):
            child = layer._modules[cname]
            if isinstance(child, _ConvNd) and cname.startswith("conv"):
                bname = "bn" + cname[len("conv"):]
                if isinstance(layer._modules.get(bname), _BatchNormBase):
                    _fold_pair(child, layer._modules[bname])
                    setattr(layer, bname, Identity())
                    n += 1
        for child in layer._modules.values():
            walk(child)

    walk(model)
    return model, n
