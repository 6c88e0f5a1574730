"""DataLoader of the port (counterpart of ``paddle_tpu/io/dataloader.py``,
ref: python/paddle/io/dataloader/dataloader_iter.py and the C++ reader ops
of paddle/fluid/operators/reader/).

The single-process path collates numpy batches in the consuming thread.
``num_workers > 0`` runs the reference's thread prefetcher over a Python
queue (its pure-Python path; the C++ ring of ``io/native.py`` is not
ported, see ROADMAP.md), and ``use_process_workers=True`` the spawn-worker
pool of ``io/process_worker.py``. Batches come out as CPU torch tensors
(``torch.from_numpy``, no copy), where the reference gives its Tensors.

``pin_memory=True`` (a PyTorch keyword the reference lacks) makes the
default collate write each stacked array straight into page-locked host
memory, so a batch reaches the card with one host copy (the stack) and an
asynchronous DMA, not a stack and then a second copy into pinned memory.
``device_prefetch`` is the reference's double-buffered device feed: batch
N+1's copy to the card is issued on a side stream while step N runs.

The reference's batch-wait histogram and batch counter live in its
metrics registry (``observability``, ROADMAP.md queue 1 item 8); the port
keeps the same two readings as attributes of the loader: ``batch_wait_s``,
the seconds the consuming loop spent blocked in ``next()``, and
``batches``, the batches it produced (both summed over the loader's life).
"""
from __future__ import annotations

import collections
import itertools
import queue as _queue
import threading
import time

import numpy as np
import torch

from ..device import resolve_device
from .dataset import IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn", "default_convert_fn",
           "device_prefetch", "get_worker_info", "WorkerInfo"]


def _collate(batch, pin):
    """The reference's default collate; with ``pin`` each stack of numpy
    arrays is written straight into a page-locked tensor (one host
    copy)."""
    sample = batch[0]
    if isinstance(sample, (np.ndarray, np.generic)):
        arrs = [np.asarray(b) for b in batch]
        if not pin:
            return np.stack(arrs)
        dt = np.result_type(*arrs)
        out = torch.empty((len(arrs),) + arrs[0].shape, pin_memory=True,
                          dtype=torch.from_numpy(np.empty(0, dt)).dtype)
        np.stack(arrs, out=out.numpy())
        return out
    if torch.is_tensor(sample):
        return torch.stack([b.detach().cpu() for b in batch])
    if isinstance(sample, (int, float)):
        return np.asarray(batch)
    if isinstance(sample, (list, tuple)):
        transposed = list(zip(*batch))
        return type(sample)(_collate(list(s), pin) for s in transposed)
    if isinstance(sample, dict):
        return {k: _collate([b[k] for b in batch], pin) for k in sample}
    return np.asarray(batch)


def default_collate_fn(batch):
    return _collate(batch, False)


def _pinned_collate_fn(batch):
    return _collate(batch, True)


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, use_process_workers=None,
                 pin_memory=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or (
            _pinned_collate_fn if pin_memory else default_collate_fn)
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.use_process_workers = use_process_workers
        if use_process_workers and num_workers == 0:
            raise ValueError(
                "use_process_workers=True requires num_workers >= 1 "
                "(num_workers=0 is the inline single-process path; the "
                "spawn-worker opt-in would be silently ignored)")
        self.use_shared_memory = use_shared_memory
        self.persistent_workers = persistent_workers
        self.batch_wait_s = 0.0
        self.batches = 0
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset=dataset, shuffle=shuffle,
                batch_size=batch_size, drop_last=drop_last)

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def _gen_batches(self):
        if self._iterable:
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                yield self.collate_fn(batch)
        else:
            for indices in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self):
        it = self._iter_batches()
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.batch_wait_s += time.perf_counter() - t0
            self.batches += 1
            yield batch

    def _iter_batches(self):
        if self.num_workers == 0:
            for b in self._gen_batches():
                yield _to_tensors(b)
            return
        if self._use_processes():
            pool = self._process_pool()
            try:
                for b in pool.run_epoch(iter(self.batch_sampler)):
                    yield _to_tensors(b)
            finally:
                if not self.persistent_workers:
                    pool.shutdown()
                    self._pool = None
            return
        yield from self._prefetch_iter(self._gen_batches())

    def _process_pool(self):
        from .process_worker import ProcessPrefetcher
        pool = getattr(self, "_pool", None)
        if pool is not None and not pool._closed:
            return pool  # persistent_workers: reuse across epochs
        # the base seed draws from torch's default CPU generator
        # (torch.manual_seed makes runs reproducible) and varies across
        # pools, so a fresh non-persistent pool does not replay epoch 1's
        # augmentations
        seed = int(torch.randint(0, 2 ** 31 - 1, ()).item())
        # a worker process hands numpy arrays over shared memory; pinning
        # happens in the consumer (device_prefetch)
        collate = default_collate_fn if self.collate_fn is \
            _pinned_collate_fn else self.collate_fn
        pool = self._pool = ProcessPrefetcher(
            self.dataset, collate, self.num_workers,
            prefetch_factor=self.prefetch_factor,
            worker_init_fn=self.worker_init_fn, seed=seed,
            timeout=self.timeout)
        return pool

    def _use_processes(self):
        """Process workers: opted in, map-style dataset, shared memory
        wanted, and everything the spawn must carry pickles."""
        if not self.use_process_workers:
            return False
        if self._iterable or not self.use_shared_memory:
            raise ValueError(
                "use_process_workers=True needs a map-style dataset and "
                "use_shared_memory=True (IterableDataset streams through "
                "the thread prefetcher)")
        from .process_worker import can_use_process_workers
        ok = can_use_process_workers(self.dataset, self.collate_fn) and \
            (self.worker_init_fn is None or
             can_use_process_workers(self.worker_init_fn, None))
        if not ok:
            raise ValueError(
                "use_process_workers=True but the dataset / collate_fn / "
                "worker_init_fn does not pickle (spawn workers require "
                "it); use module-level functions instead of lambdas or "
                "pass use_process_workers=False")
        return True

    def _prefetch_iter(self, gen):
        """One producer thread collates ahead into a bounded queue. An
        early exit of the consumer stops the producer at its next put."""
        depth = max(2, self.num_workers * self.prefetch_factor)
        q = _queue.Queue(maxsize=depth)
        done = object()
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    pass
            return False

        def producer():
            try:
                for item in gen:
                    if not put(item):
                        return
                put(done)
            except BaseException as e:  # propagate worker errors to consumer
                put(_WorkerError(e))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, _WorkerError):
                    raise item.exc
                yield _to_tensors(item)
        finally:
            stop.set()
            t.join(timeout=10)


class _WorkerError:
    """Carries a worker exception across the prefetch queue."""

    def __init__(self, exc):
        self.exc = exc


def _to_tensors(batch):
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(batch)
    if isinstance(batch, (list, tuple)):
        return type(batch)(_to_tensors(b) for b in batch)
    if isinstance(batch, dict):
        return {k: _to_tensors(v) for k, v in batch.items()}
    return batch


def _map_tensors(batch, fn):
    if torch.is_tensor(batch):
        return fn(batch)
    if isinstance(batch, np.ndarray):
        return fn(torch.from_numpy(batch))
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map_tensors(b, fn) for b in batch)
    if isinstance(batch, dict):
        return {k: _map_tensors(v, fn) for k, v in batch.items()}
    return batch


def device_prefetch(iterable, device="cuda", size=2):
    """Double-buffered host -> device feed (ref: buffered_reader.cc's pinned
    staging + async H2D pair). Yields each batch of ``iterable`` (tensors
    or numpy arrays, nested in lists, tuples and dicts) with its tensors on
    ``device``; ``size`` batches are in flight (2 = double buffering).

    On CUDA every host tensor is staged in page-locked memory (a pinned
    one, such as ``DataLoader(pin_memory=True)`` gives, is used as it is)
    and copied with ``non_blocking=True`` on a side stream, issued before
    the previous batch is handed over, so the copy runs under the step
    that consumes it. The consumer's stream waits on the copy's event
    before it touches the batch, and each device tensor is recorded on
    that stream (``record_stream``), so the allocator never hands its
    memory to the side stream while the step still reads it. PyTorch's
    pinned-memory allocator records the copy on its source block and
    reuses a staging buffer only after the copy that reads it is done.
    ``device`` None or "cuda" raises with no GPU; "cpu" moves nothing."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        for batch in iterable:
            yield _map_tensors(batch, lambda t: t.to(dev))
        return
    stream = torch.cuda.Stream(dev)

    def put(batch):
        with torch.cuda.stream(stream):
            out = _map_tensors(batch, lambda t: (
                t if t.is_cuda else
                (t if t.is_pinned() else t.pin_memory()).to(
                    dev, non_blocking=True)))
            ev = torch.cuda.Event()
            ev.record(stream)
        return out, ev

    def take(item):
        out, ev = item
        cur = torch.cuda.current_stream(dev)
        cur.wait_event(ev)
        _map_tensors(out, lambda t: t.record_stream(cur))
        return out

    buf = collections.deque()
    try:
        for batch in iterable:
            buf.append(put(batch))
            if len(buf) >= size:
                yield take(buf.popleft())
        while buf:
            yield take(buf.popleft())
    finally:
        buf.clear()


class WorkerInfo:
    """ref: paddle.io.dataloader.worker.WorkerInfo."""

    def __init__(self, id, num_workers, seed, dataset):
        self.id = id
        self.num_workers = num_workers
        self.seed = seed
        self.dataset = dataset

    def __repr__(self):
        return (f"WorkerInfo(id={self.id}, "
                f"num_workers={self.num_workers}, seed={self.seed})")


_worker_info = None  # set inside process workers (io/process_worker.py)


def get_worker_info():
    """ref: paddle.io.get_worker_info — WorkerInfo inside a DataLoader
    worker process, None in the main process and the thread prefetcher."""
    return _worker_info


def default_convert_fn(batch):
    """ref: paddle.io.dataloader.collate.default_convert_fn — convert
    without batching. namedtuples rebuild field-wise like the
    reference."""
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(default_convert_fn(b) for b in batch))
    if isinstance(batch, (list, tuple)):
        return type(batch)(default_convert_fn(b) for b in batch)
    if isinstance(batch, dict):
        return {k: default_convert_fn(v) for k, v in batch.items()}
    if isinstance(batch, (int, float)):
        return np.asarray(batch)
    return batch
