"""paddle.summary / paddle.flops of the port (counterpart of
``paddle_tpu/hapi/summary.py``, ref: python/paddle/hapi/model_summary.py,
python/paddle/hapi/dynamic_flops.py).

The reference's accounting on torch modules: ``summary`` runs one eval
forward of zeros with a hook on every leaf module (its own parameters and
output shape) and counts the parameters; ``flops`` counts the
multiply-adds of every ``Linear`` (the mpu projections are ``Linear``
here) and convolution that the forward calls, once each. The zeros are
made on the network's device.
"""
from __future__ import annotations

import math

import torch

from ..framework import convert_dtype

__all__ = ["summary", "flops"]


def _device(net):
    p = next(net.parameters(), None)
    return p.device if p is not None else torch.device("cpu")


def _eval_forward(net, xs):
    was_training = net.training
    net.eval()
    with torch.no_grad():
        net(*xs)
    if was_training:
        net.train()


def summary(net, input_size=None, dtypes=None, input=None):
    """Prints the reference-style layer table; returns
    {'total_params': n, 'trainable_params': n}."""
    rows = []
    hooks = []

    def hook(lyr, inputs, output):
        if torch.is_tensor(output):
            out_shape = list(output.shape)
        elif isinstance(output, (list, tuple)):
            out_shape = [list(o.shape) for o in output if torch.is_tensor(o)]
        else:
            out_shape = "?"
        n_params = sum(p.numel() for p in lyr._parameters.values()
                       if p is not None)
        rows.append((f"{type(lyr).__name__}-{len(rows) + 1}",
                     str(out_shape), n_params))

    for _, sub in net.named_modules():
        if sub is not net and not list(sub.children()):  # leaves only
            hooks.append(sub.register_forward_hook(hook))
    try:
        if input is not None:
            _eval_forward(net, input if isinstance(input, (list, tuple))
                          else [input])
        elif input_size is not None:
            sizes = input_size if isinstance(input_size, list) \
                else [input_size]
            if sizes and isinstance(sizes[0], int):
                sizes = [tuple(sizes)]
            dts = dtypes if isinstance(dtypes, (list, tuple)) else \
                [dtypes] * len(sizes)
            dev = _device(net)
            xs = [torch.zeros([1 if (s is None or (isinstance(s, int)
                                                   and s < 0)) else s
                               for s in shape],
                              dtype=convert_dtype(dt or "float32"),
                              device=dev)
                  for shape, dt in zip(sizes, dts)]
            _eval_forward(net, xs)
    finally:
        for h in hooks:
            h.remove()

    total = sum(p.numel() for p in net.parameters())
    trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)
    line = "-" * 64
    print(line)
    print(f"{'Layer (type)':<28}{'Output Shape':<24}{'Param #':>12}")
    print(line)
    for nm, shp, n in rows:
        print(f"{nm:<28}{shp:<24}{n:>12,}")
    print(line)
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    print(line)
    return {"total_params": total, "trainable_params": trainable}


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Analytic FLOPs as the reference counts them: multiply-adds of the
    Linear layers and convolutions the forward calls, counted once."""
    from ..nn.layers_common import Linear
    from ..nn.layers_conv import _ConvNd
    total = [0]
    hooks = []

    def linear_hook(lyr, inputs, output):
        batch = math.prod(inputs[0].shape[:-1])
        total[0] += batch * lyr.in_features * lyr.out_features

    def conv_hook(lyr, inputs, output):
        k = math.prod(lyr._kernel_size) * lyr._in_channels // lyr._groups
        total[0] += output.numel() * k

    for sub in net.modules():
        if isinstance(sub, Linear):
            hooks.append(sub.register_forward_hook(linear_hook))
        elif isinstance(sub, _ConvNd):
            hooks.append(sub.register_forward_hook(conv_hook))
    try:
        _eval_forward(net, [torch.zeros(list(input_size),
                                        device=_device(net))])
    finally:
        for h in hooks:
            h.remove()
    if print_detail:
        print(f"Total FLOPs (MAC): {total[0]:,}")
    return total[0]
