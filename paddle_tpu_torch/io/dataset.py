"""Datasets of the port (counterpart of ``paddle_tpu/io/dataset.py``, ref:
python/paddle/io/dataloader/dataset.py).

A copy of the reference with its imports retargeted: ``TensorDataset``
takes numpy arrays or torch tensors and keeps numpy views on the host, and
``random_split`` draws its permutation from ``np.random``, as the
reference does, so a test that seeds numpy gets the same split from both
packages."""
from __future__ import annotations

import bisect

import numpy as np

import torch


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        lens = {len(t) for t in tensors}
        assert len(lens) == 1, "tensors must share dim0"
        # Datasets are the host-side stage of the pipeline: keep numpy views
        # so per-sample indexing never touches the device (the reference's
        # Tensors are host-memory here too).
        self._arrays = [t.detach().cpu().numpy() if torch.is_tensor(t)
                        else np.asarray(t) for t in tensors]

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self._arrays)

    def __len__(self):
        return len(self._arrays[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        off = idx - (self.cumulative_sizes[ds_idx - 1] if ds_idx else 0)
        return self.datasets[ds_idx][off]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    lengths = list(lengths)
    if all(isinstance(l, float) for l in lengths):
        n = len(dataset)
        counts = [int(np.floor(n * f)) for f in lengths]
        rem = n - sum(counts)
        for i in range(rem):
            counts[i % len(counts)] += 1
        lengths = counts
    assert sum(lengths) == len(dataset)
    perm = np.random.permutation(len(dataset))
    out, off = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[off:off + l].tolist()))
        off += l
    return out
