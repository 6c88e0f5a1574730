"""Samplers of the port (counterpart of ``paddle_tpu/io/sampler.py``, ref:
python/paddle/io/dataloader/sampler.py, batch_sampler.py).

A copy of the reference: index streams are plain Python ints drawn on the
host. ``RandomSampler`` and ``SubsetRandomSampler`` with no ``generator``
draw from ``np.random``, exactly as the reference does, so a test that
seeds numpy gets the same order from both packages; given an
``np.random.Generator`` they draw from it instead. Not ported:
``DistributedBatchSampler`` (raises naming ROADMAP.md queue 1 item 10).
"""
from __future__ import annotations

import numpy as np

from ..framework import later

__all__ = ["Sampler", "SequenceSampler", "RandomSampler",
           "SubsetRandomSampler", "WeightedRandomSampler", "BatchSampler",
           "DistributedBatchSampler"]


def _rng(generator):
    """The numpy source of a sampler: the given ``np.random.Generator``, or
    numpy's global state (the reference's) when None."""
    if generator is None:
        return np.random
    if not isinstance(generator, np.random.Generator):
        raise TypeError("a sampler's generator must be an "
                        f"np.random.Generator, got {type(generator)}")
    return generator


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = _rng(self.generator)
        if self.replacement:
            draw = (rng.randint if rng is np.random else rng.integers)
            return iter(draw(0, n, self.num_samples).tolist())
        return iter(rng.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices, generator=None):
        super().__init__()
        self.indices = list(indices)
        self.generator = generator

    def __iter__(self):
        perm = _rng(self.generator).permutation(len(self.indices))
        return iter(np.array(self.indices)[perm].tolist())

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__()
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        super().__init__()
        assert dataset is not None or sampler is not None
        if sampler is None:
            sampler = RandomSampler(dataset) if shuffle \
                else SequenceSampler(dataset)
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """ref: paddle.io.DistributedBatchSampler — shards the index stream by
    rank, which needs the port's distributed slice."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        raise NotImplementedError(f"DistributedBatchSampler {later('10')}")
