"""Device selection for the PyTorch port (counterpart of
``paddle_tpu/device.py``).

The port runs on CUDA. Every entry point resolves its ``device`` argument
through ``resolve_device``: no argument means the first GPU, and a box
without one raises instead of quietly running on the CPU. The CPU is
used only when a caller asks for it by name (the tests do).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """``None`` -> ``cuda``; a string or ``torch.device`` is taken as
    given. Raises RuntimeError when a CUDA device is wanted and none is
    present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on CUDA by default and found no GPU; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev
