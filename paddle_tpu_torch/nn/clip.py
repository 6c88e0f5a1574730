"""Gradient clipping of the port (counterpart of ``paddle_tpu/nn/clip.py``,
ref: python/paddle/nn/clip.py): the global-norm clip LM training uses;
the per-tensor and by-value clips are not ported yet.

``apply(grads)`` takes a list of gradient tensors and returns the clipped
list; the optimizer calls it over the grads of one step, eager and in the
Engine alike. All arithmetic stays on the device: no host sync.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm"]


class ClipGradBase:
    def __call__(self, params_grads):
        """Eager form: list[(param, grad)] -> the same with clipped grads."""
        idx = [i for i, (_, g) in enumerate(params_grads) if g is not None]
        clipped = self.apply([params_grads[i][1] for i in idx])
        out = list(params_grads)
        for i, g in zip(idx, clipped):
            out[i] = (params_grads[i][0], g)
        return out

    def apply(self, grads):
        raise NotImplementedError


class ClipGradByGlobalNorm(ClipGradBase):
    """Global L2 norm clip (the Fleet default for LM training): the norm
    over every gradient in f32, each gradient scaled by
    min(clip_norm / norm, 1) and kept in its dtype."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def apply(self, grads):
        if not grads:
            return grads
        total = torch.sqrt(sum(torch.sum(g.float() * g.float())
                               for g in grads))
        coef = torch.clamp(self.clip_norm / total.clamp_min(1e-6), max=1.0)
        return [(g * coef).to(g.dtype) for g in grads]
