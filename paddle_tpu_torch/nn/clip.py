"""Gradient clipping of the port (counterpart of ``paddle_tpu/nn/clip.py``,
ref: python/paddle/nn/clip.py): the global-norm clip LM training uses;
the per-tensor and by-value clips are not ported yet.

``coefficient(grads)`` takes a list of gradient tensors and returns the
factor every gradient is multiplied by; the optimizer asks for it over the
grads of one step, eager and in the Engine alike, and its update
multiplies each gradient by it (the AdamW kernel inside its one pass), so
no scaled copy of a gradient is written. ``apply(grads)`` returns the
clipped list. All arithmetic stays on the device: no host sync, so a
CUDA graph can record it. ``global_norm`` is the one reduction, which the
Engine's grad-norm telemetry shares.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm", "global_norm"]


def global_norm(grads):
    """The L2 norm over every gradient of a list, f32, as a device scalar:
    each gradient's norm in f32 by one ``torch._foreach_norm``, then the
    norm of those."""
    norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


class ClipGradBase:
    def __call__(self, params_grads):
        """Eager form: list[(param, grad)] -> the same with clipped grads."""
        idx = [i for i, (_, g) in enumerate(params_grads) if g is not None]
        clipped = self.apply([params_grads[i][1] for i in idx])
        out = list(params_grads)
        for i, g in zip(idx, clipped):
            out[i] = (params_grads[i][0], g)
        return out

    def coefficient(self, grads, norm=None):
        raise NotImplementedError

    def apply(self, grads):
        """The grads each multiplied by ``coefficient(grads)``, each kept in
        its dtype."""
        coef = self.coefficient(grads)
        return [(g * coef).to(g.dtype) for g in grads]


class ClipGradByGlobalNorm(ClipGradBase):
    """Global L2 norm clip (the Fleet default for LM training): the norm
    over every gradient in f32, each gradient scaled by
    min(clip_norm / norm, 1) and kept in its dtype."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def coefficient(self, grads, norm=None):
        """min(clip_norm / norm, 1) as an f32 scalar tensor on the grads'
        device (None for no grads): ``norm`` the grads' global norm when
        the caller has it, else ``global_norm(grads)``, one multi-tensor
        reduction, a few launches for the whole list. Reads nothing back."""
        if not grads:
            return None
        total = global_norm(grads) if norm is None else norm
        return torch.clamp(self.clip_norm / total.clamp_min(1e-6), max=1.0)
