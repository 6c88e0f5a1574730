"""Engine of the port: one training step of (model, loss, optimizer)
(counterpart of ``paddle_tpu/hapi/engine.py``).

The reference compiles forward, loss, backward, clip and the optimizer
update into one jitted step; the port runs the same sequence eagerly on
the model's device: the forward through ``torch.func.functional_call``
(with every floating parameter and input cast to ``amp_dtype`` inside the
loss function, as the reference casts its pytree), ``torch.autograd.grad``
onto the f32 parameters, then the optimizer's update core with the
Engine's own update counter. The loss comes back as a device tensor:
``train_batch`` never waits for the device (no host sync), so the caller
synchronises when it reads the loss.

``step`` counts calls and ``opt_step`` counts optimizer updates (Adam's
bias correction reads ``opt_step``), as in the reference.

Not ported (each raises NotImplementedError, see ROADMAP.md): ``guard``
(TrainGuard), ``mesh``, gradient accumulation (``train_batch_accum``),
``train_batch_multi`` and grad-norm telemetry (``collect_grad_norm``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from ..framework import bind_generator, convert_dtype, later

__all__ = ["Engine"]


def _detach(x):
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, (list, tuple)):
        return type(x)(_detach(t) for t in x)
    if isinstance(x, dict):
        return {k: _detach(v) for k, v in x.items()}
    return x


class Engine:
    """``Engine(network, loss, optimizer, amp_dtype)``. Runs where the
    network's parameters live and creates nothing elsewhere; inputs that
    are numpy arrays or tensors on another device are moved there.
    ``generator`` (a torch.Generator on that device), when given, becomes
    the one every dropout of the network draws from
    (``framework.bind_generator``)."""

    def __init__(self, network, loss=None, optimizer=None, amp_dtype=None,
                 mesh=None, guard=None, generator=None):
        if mesh is not None:
            raise NotImplementedError(f"Engine(mesh=...) {later('1.3')}")
        if guard is not None:
            raise NotImplementedError(f"Engine(guard=...) (TrainGuard) "
                                      f"{later('1.3')}")
        self.network = network
        self.loss = loss
        self.optimizer = optimizer
        self.amp_dtype = convert_dtype(amp_dtype)
        self.device = next(network.parameters()).device
        if generator is not None:
            bind_generator(network, generator)
        self._step = 0
        self._opt_step = 0
        self.collect_grad_norm = False

    def _to_device(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if isinstance(x, torch.Tensor) and x.device != self.device:
            x = x.to(self.device)
        return x

    def _cast(self, x):
        amp = self.amp_dtype
        if amp is not None and torch.is_tensor(x) and x.is_floating_point():
            return x.to(amp)
        return x

    def train_batch(self, inputs, labels):
        """One optimizer step -> (loss, outs): loss an f32 scalar tensor on
        the device, outs the network's outputs (detached)."""
        if self.collect_grad_norm:
            raise NotImplementedError(f"grad-norm telemetry {later('1.3')}")
        net = self.network
        if not net.training:
            net.train()
        live = [(n, p) for n, p in net.named_parameters() if p.requires_grad]
        names = [n for n, _ in live]
        params = [p for _, p in live]
        ins = [self._cast(self._to_device(x)) for x in inputs]
        labs = [self._to_device(x) for x in labels]
        # the cast happens inside the differentiated function: grads land
        # on the f32 parameters, and a tied weight is cast once, so its
        # grad sums every use of the one low-precision copy
        outs = functional_call(net, {n: self._cast(p) for n, p in live},
                               tuple(ins))
        outs_t = outs if isinstance(outs, (list, tuple)) else [outs]
        loss = (self.loss(*outs_t, *labs) if self.loss is not None
                else outs_t[0]).float()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        self._step += 1
        self._opt_step += 1
        self.optimizer._apply(names, params, grads, self.optimizer.get_lr(),
                              self._opt_step)
        return loss.detach(), _detach(outs)

    @torch.no_grad()
    def eval_batch(self, inputs, labels=()):
        """-> (loss or None, outs), in eval mode and without AMP, as the
        reference's eval step."""
        net = self.network
        if net.training:
            net.eval()
        outs = net(*[self._to_device(x) for x in inputs])
        loss = None
        if self.loss is not None and labels:
            outs_t = outs if isinstance(outs, (list, tuple)) else [outs]
            loss = self.loss(*outs_t, *[self._to_device(x)
                                        for x in labels]).float()
        return loss, outs

    def predict_batch(self, inputs):
        return self.eval_batch(inputs, ())[1]

    def train_batch_accum(self, inputs, labels, apply_update):
        raise NotImplementedError(f"gradient accumulation {later('1.3')}")

    def train_batch_multi(self, inputs, labels):
        raise NotImplementedError(f"Engine.train_batch_multi {later('1.3')}")
