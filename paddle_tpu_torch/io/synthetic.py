"""Synthetic decode/augment-heavy dataset for input-pipeline load tests.

Counterpart of ``paddle_tpu/io/synthetic.py`` (a copy). The reference
benchmarks its DataLoader worker processes against JPEG decode + augment
(ref: paddle/fluid/dataloader benchmarks; DALI-class pipelines). With no
real JPEGs at hand this emulates the same CPU profile in pure numpy: PRNG
pixel synthesis (stands in for Huffman decode), bilinear resize, random
crop, flip, fp32 normalize — a few ms of GIL-holding work per image,
which is what makes thread workers starve a fast consumer and process
workers (io/process_worker.py) the fix. Picklable by construction so
spawn workers can import it.
"""
from __future__ import annotations

import numpy as np

from .dataset import Dataset

__all__ = ["SyntheticImageDataset"]


class SyntheticImageDataset(Dataset):
    """item i -> augmented [3, out] float32 image, deterministic in i."""

    def __init__(self, n=2048, src=320, out=224):
        self.n = int(n)
        self.src = int(src)
        self.out = int(out)

    def __len__(self):
        return self.n

    def _bilinear_resize(self, img, size):
        h, w, _ = img.shape
        ys = np.linspace(0, h - 1, size)
        xs = np.linspace(0, w - 1, size)
        y0 = np.floor(ys).astype(np.int64)
        x0 = np.floor(xs).astype(np.int64)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        wy = (ys - y0)[:, None, None]
        wx = (xs - x0)[None, :, None]
        f = img.astype(np.float32)
        top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
        bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
        return top * (1 - wy) + bot * wy

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        # "decode": synthesize the source image (CPU-bound PRNG fill)
        img = rng.integers(0, 256, (self.src, self.src, 3),
                           dtype=np.uint8)
        # augment: resize -> random crop -> flip -> normalize
        scale = self._bilinear_resize(img, self.out + 32)
        oy, ox = rng.integers(0, 33, 2)
        crop = scale[oy:oy + self.out, ox:ox + self.out]
        if rng.random() < 0.5:
            crop = crop[:, ::-1]
        x = crop.astype(np.float32) / 255.0
        x = (x - np.float32(0.45)) / np.float32(0.225)
        return np.ascontiguousarray(x.transpose(2, 0, 1))
