"""A stack of L identical blocks stored as stacked ``[L, ...]`` parameters
(counterpart of ``paddle_tpu/nn/scan_stack.py``).

The reference keeps the blocks of a ``scan_layers=True`` model as one
parameter a leaf, ``[L, ...]``, under the block's dotted name with dots
made ``__`` (``attn__q_proj__weight``), and runs them with one
``lax.scan``. The port keeps the same parameters under the same names, so
a state dict crosses key for key, and runs the L slices in order through
``torch.func.functional_call`` on a template block that is not a
registered submodule. ``unbind`` splits each stacked leaf once a forward,
so autograd stacks the L slices' gradients back in one op.

The reference refuses eager training of a scanned stack: its tape cannot
see through ``lax.scan``. The port's autograd sees through the loop, so
``loss.backward()`` trains it as it trains the unrolled blocks.

``recompute`` checkpoints each layer's call (``checkpoint_block``): only
the layer's input is kept, and the backward runs the layer again. A
random draw inside the layer (dropout masks, the attention-dropout seed)
is kept from the forward and handed to the rerun instead of drawn again,
so the rerun sees the forward's masks and the generator moves as far as
without recompute; no generator state is read or set, which keeps the
step recordable as a CUDA graph.

``stack_layer_state`` / ``unstack_layer_state`` convert a state dict of
numpy arrays between the per-layer and the stacked layout.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.utils import checkpoint as _cp

from ..framework import bind_generator, generators

__all__ = ["ScannedLayerStack", "flat_name", "stack_layer_state",
           "unstack_layer_state", "checkpoint_block"]


def flat_name(dotted):
    """'attn.q_proj.weight' -> 'attn__q_proj__weight' (the reference's
    parameter-store keys, which may not hold dots)."""
    return dotted.replace(".", "__")


def _keep_draws(ctx, func, *args, **kwargs):
    """Selective checkpoint policy: keep every op that draws random
    numbers, rerun the rest."""
    if torch.Tag.nondeterministic_seeded in func.tags:
        return _cp.CheckpointPolicy.MUST_SAVE
    return _cp.CheckpointPolicy.PREFER_RECOMPUTE


_KEEP_DRAWS = functools.partial(_cp.create_selective_checkpoint_contexts,
                                _keep_draws)


def checkpoint_block(fn, *args, draws=False, **kwargs):
    """``fn(*args, **kwargs)`` under ``torch.utils.checkpoint`` (the
    non-reentrant form, which ``torch.autograd.grad`` and CUDA-graph
    capture take): the backward reruns ``fn``. A module ``fn`` reruns
    with the parameters it holds now, handed to the checkpoint as inputs:
    inside ``torch.func.functional_call`` (the Engine's forward, its
    parameters cast to the AMP dtype) those are the swapped-in tensors,
    which the module no longer holds when the backward runs. ``draws``:
    ``fn`` draws random numbers, which are kept from the forward and given
    to the rerun (a selective checkpoint that saves exactly the random
    ops' outputs) rather than drawn again."""
    if isinstance(fn, nn.Module):
        module, (names, tensors) = fn, _named(fn)
        n = len(names)

        def fn(*flat, **kw):
            return functional_call(module, dict(zip(names, flat[:n])),
                                   flat[n:], kw)
        args = tuple(tensors) + args
    return _cp.checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=(_KEEP_DRAWS if draws
                                      else _cp.noop_context_fn), **kwargs)


def _named(module):
    named = list(module.named_parameters())
    return [n for n, _ in named], [t for _, t in named]


class ScannedLayerStack(nn.Module):
    """L structurally identical blocks as stacked ``[L, ...]`` parameters,
    applied in order: ``forward(x, *invariants, **kw)`` returns
    ``block_{L-1}(...block_0(x, *invariants, **kw)...)``.

    ``blocks``: freshly built blocks; their values are stacked and the
    first becomes the template, which is not registered (its own
    parameters are dropped). ``has_dropout``: the blocks draw random
    numbers in training (what recompute must keep). ``recompute``:
    checkpoint each block's call in training."""

    def __init__(self, blocks, has_dropout=False, recompute=False):
        super().__init__()
        self.num_layers = len(blocks)
        self.has_dropout = has_dropout
        self.recompute = recompute
        template = blocks[0]
        buf_names = [n for n, _ in template.named_buffers()]
        if buf_names:
            # functional_call below swaps in parameters only: a block with
            # buffers (BatchNorm-style running statistics) would run with
            # the template's own
            raise ValueError(
                "ScannedLayerStack blocks may not register buffers "
                f"(found {buf_names}); stack such state as a parameter "
                "with requires_grad=False, or keep the model unrolled "
                "(scan_layers=False)")
        self._pnames = [n for n, _ in template.named_parameters()]
        for n in self._pnames:
            refs = [b.get_parameter(n) for b in blocks]
            self.register_parameter(flat_name(n), nn.Parameter(
                torch.stack([r.detach() for r in refs]),
                requires_grad=refs[0].requires_grad))
        # the template is not a submodule: its parameters must not appear
        # in state_dict() / parameters(); each call swaps the slices in
        for mod in template.modules():
            for name, p in list(mod.named_parameters(recurse=False)):
                setattr(mod, name, nn.Parameter(p.new_empty(0),
                                                requires_grad=False))
        object.__setattr__(self, "_template", template)

    @property
    def generator(self):
        """The generator the blocks draw from (``framework.generators``
        and ``bind_generator`` see the template through this)."""
        gens = generators(self._template)
        return gens[0] if gens else None

    @generator.setter
    def generator(self, g):
        bind_generator(self._template, g)

    def forward(self, x, *invariants, **kw):
        template = self._template
        if template.training != self.training:
            template.train(self.training)
        slices = [getattr(self, flat_name(n)).unbind(0)
                  for n in self._pnames]
        recompute = (self.recompute and self.training
                     and torch.is_grad_enabled())

        def layer(i, h):
            params = {n: s[i] for n, s in zip(self._pnames, slices)}
            return functional_call(template, params, (h,) + invariants, kw)

        for i in range(self.num_layers):
            if recompute:
                x = checkpoint_block(functools.partial(layer, i), x,
                                     draws=self.has_dropout)
            else:
                x = layer(i, x)
        return x


def as_numpy(v):
    """A state-dict value (tensor or array-like) as a numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def stack_layer_state(state_dict, num_layers, prefix="h."):
    """Per-layer keys ('h.3.attn.q_proj.weight') -> the stacked layout
    ('h.attn__q_proj__weight', a [L, ...] array). Keys outside the layers
    (or already stacked) pass through. Inverse: ``unstack_layer_state``."""
    per_layer, rest = {}, {}
    for k, v in state_dict.items():
        if k.startswith(prefix) and "." in k[len(prefix):]:
            idx, dotted = k[len(prefix):].split(".", 1)
            if idx.isdigit():
                per_layer.setdefault(dotted, {})[int(idx)] = v
                continue
        rest[k] = v
    for dotted, by_idx in per_layer.items():
        missing = set(range(num_layers)) - set(by_idx)
        if missing:
            raise ValueError(f"layer state for '{dotted}' missing "
                             f"indices {sorted(missing)}")
        rest[prefix + flat_name(dotted)] = np.stack(
            [as_numpy(by_idx[i]) for i in range(num_layers)])
    return rest


def unstack_layer_state(state_dict, num_layers, prefix="h."):
    """Inverse of ``stack_layer_state``: stacked keys back to per-layer."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith(prefix) and "__" in k[len(prefix):]:
            dotted = k[len(prefix):].replace("__", ".")
            arr = as_numpy(v)
            if arr.shape[0] != num_layers:
                raise ValueError(
                    f"stacked leaf '{k}' has leading dim {arr.shape[0]}"
                    f" != num_layers {num_layers}")
            for i in range(num_layers):
                out[f"{prefix}{i}.{dotted}"] = arr[i]
        else:
            out[k] = v
    return out
