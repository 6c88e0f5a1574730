"""Process-based DataLoader workers over POSIX shared memory (counterpart
of ``paddle_tpu/io/process_worker.py``; a copy of it, which never imported
jax).

ref parity: python/paddle/io/dataloader/worker.py (_worker_loop: worker
PROCESSES pull index batches from an index queue, write sample tensors
into shared memory, and push descriptors back). Thread workers cannot
feed the card through GIL-heavy decode/augment Python; processes sidestep
the GIL entirely.

- workers are `spawn` processes running only numpy/dataset code;
- each result batch's arrays are written into one
  multiprocessing.shared_memory segment; only (name, shapes, dtypes)
  descriptors ride the control queue, so the parent never unpickles
  payload bytes — it maps the segment, copies out with one GIL-free
  memcpy, and unlinks immediately (no lifetime coupling to user code);
- an index queue bounds work-in-flight (prefetch backpressure), a
  reorder buffer restores determinism (ref: _task_info reordering in
  dataloader_iter.py), and dead workers are detected instead of
  hanging the consumer;
- the pool outlives an epoch when persistent_workers=True (tasks and
  results carry an epoch id; stale results are dropped and their
  segments freed);
- worker_init_fn / get_worker_info() match the reference contract.
"""
from __future__ import annotations

import multiprocessing as mp
import pickle
import queue as _queue
from multiprocessing import shared_memory

import numpy as np

__all__ = ["ProcessPrefetcher", "can_use_process_workers"]

_SENTINEL = None
_LIVENESS_POLL_S = 5.0


def _flatten_arrays(obj, out):
    """Split a collated batch into (template, [arrays]): arrays are
    replaced by positional placeholders so only metadata pickles."""
    if isinstance(obj, np.ndarray):
        out.append(obj)
        return _ArrRef(len(out) - 1)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_flatten_arrays(x, out) for x in obj)
    if isinstance(obj, dict):
        return {k: _flatten_arrays(v, out) for k, v in obj.items()}
    return obj


class _ArrRef:
    __slots__ = ("i",)

    def __init__(self, i):
        self.i = i


def _unflatten(obj, arrays):
    if isinstance(obj, _ArrRef):
        return arrays[obj.i]
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unflatten(x, arrays) for x in obj)
    if isinstance(obj, dict):
        return {k: _unflatten(v, arrays) for k, v in obj.items()}
    return obj


def _worker_loop(dataset, collate_fn, index_q, result_q, worker_id,
                 num_workers, worker_init_fn, seed):
    from . import dataloader as _dl
    _dl._worker_info = _dl.WorkerInfo(
        id=worker_id, num_workers=num_workers, seed=seed + worker_id,
        dataset=dataset)
    # persistent workers keep this RNG state across epochs, so epoch
    # N+1's augmentations differ from epoch N's (same contract as the
    # reference's persistent pool)
    np.random.seed((seed + worker_id) % (2 ** 31))
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    while True:
        task = index_q.get()
        if task is _SENTINEL:
            return
        epoch, seq, indices = task
        try:
            batch = collate_fn([dataset[i] for i in indices])
            arrays = []
            template = _flatten_arrays(batch, arrays)
            total = sum(int(a.nbytes) for a in arrays)
            if total:
                shm = shared_memory.SharedMemory(create=True,
                                                 size=max(total, 1))
                off = 0
                descs = []
                for a in arrays:
                    a = np.ascontiguousarray(a)
                    shm.buf[off:off + a.nbytes] = \
                        a.view(np.uint8).reshape(-1).data
                    descs.append((off, a.shape, a.dtype.str))
                    off += a.nbytes
                name = shm.name
                shm.close()  # parent owns the segment lifetime now
            else:
                name, descs = None, []
            result_q.put((epoch, seq, None, (template, name, descs)))
        except BaseException as e:  # propagate to the parent loudly
            try:
                result_q.put((epoch, seq, pickle.dumps(e), None))
            except Exception:
                result_q.put((epoch, seq, pickle.dumps(
                    RuntimeError(f"worker {worker_id}: {e!r}")), None))


def _free_segment(name):
    if not name:
        return
    try:
        s = shared_memory.SharedMemory(name=name)
        s.close()
        s.unlink()
    except (FileNotFoundError, OSError):
        pass


def _map_result(template, name, descs):
    if name is None:
        return _unflatten(template, [])
    shm = shared_memory.SharedMemory(name=name)
    try:
        arrays = []
        for off, shape, dtype in descs:
            n = int(np.prod(shape)) * np.dtype(dtype).itemsize
            # one memcpy out of the segment (np.array releases the GIL
            # for the copy): the segment is then freed immediately,
            # with no lifetime coupling to escaping user arrays
            arrays.append(np.array(np.ndarray(
                shape, dtype, buffer=shm.buf[off:off + n])))
        return _unflatten(template, arrays)
    finally:
        shm.close()
        try:
            shm.unlink()
        except (FileNotFoundError, OSError):
            pass


def can_use_process_workers(dataset, collate_fn):
    """Process workers need a picklable dataset + collate (spawn)."""
    try:
        pickle.dumps(dataset)
        pickle.dumps(collate_fn)
        return True
    except Exception:
        return False


class ProcessPrefetcher:
    """A spawn-worker pool. `run_epoch(batches)` pulls index batches
    from `batches`, fans them out, and yields collated numpy batches
    IN ORDER. The pool survives across epochs (persistent_workers);
    call shutdown() when done."""

    def __init__(self, dataset, collate_fn, num_workers,
                 prefetch_factor=2, worker_init_fn=None, seed=0,
                 timeout=0):
        ctx = mp.get_context("spawn")
        self._index_q = ctx.Queue()
        self._result_q = ctx.Queue()
        self._timeout = float(timeout) or None
        self._procs = [
            ctx.Process(
                target=_worker_loop,
                args=(dataset, collate_fn, self._index_q, self._result_q,
                      w, num_workers, worker_init_fn, seed),
                daemon=True)
            for w in range(num_workers)]
        for p in self._procs:
            p.start()
        self._inflight_cap = max(2, num_workers * prefetch_factor)
        self._epoch = 0
        self._closed = False

    def _check_alive(self):
        dead = [p for p in self._procs if not p.is_alive()]
        if dead:
            codes = [p.exitcode for p in dead]
            self.shutdown()
            raise RuntimeError(
                f"{len(dead)} DataLoader worker process(es) died "
                f"unexpectedly (exit codes {codes}) — commonly the OOM "
                "killer on oversized batches; reduce batch_size or "
                "num_workers")

    def _get_result(self):
        """result_q.get with liveness polling: a dead worker raises
        instead of hanging the consumer forever."""
        import time
        deadline = (time.monotonic() + self._timeout
                    if self._timeout else None)
        while True:
            poll = _LIVENESS_POLL_S
            if deadline is not None:
                poll = min(poll, max(0.1, deadline - time.monotonic()))
            try:
                return self._result_q.get(timeout=poll)
            except _queue.Empty:
                self._check_alive()
                if deadline is not None and time.monotonic() >= deadline:
                    self.shutdown()
                    raise TimeoutError(
                        f"DataLoader worker result not ready within "
                        f"timeout={self._timeout}s")

    def run_epoch(self, batches):
        if self._closed:
            raise RuntimeError("ProcessPrefetcher already shut down")
        epoch = self._epoch = self._epoch + 1
        batches = enumerate(batches)
        # out-of-order results land here; payloads are freed on ANY
        # exit path (early break / worker error) via the finally
        pending = self._pending = {}
        inflight = 0
        next_seq = 0
        exhausted = False
        try:
            while True:
                while inflight < self._inflight_cap and not exhausted:
                    try:
                        seq, idxs = next(batches)
                    except StopIteration:
                        exhausted = True
                        break
                    self._index_q.put((epoch, seq, list(idxs)))
                    inflight += 1
                if inflight == 0:
                    return
                while next_seq not in pending:
                    r_epoch, seq, err, payload = self._get_result()
                    if r_epoch != epoch:  # abandoned earlier epoch
                        if err is None and payload:
                            _free_segment(payload[1])
                        continue
                    pending[seq] = (err, payload)
                err, payload = pending.pop(next_seq)
                next_seq += 1
                inflight -= 1
                if err is not None:
                    raise pickle.loads(err)
                batch = _map_result(*payload)
                payload = None
                yield batch
        finally:
            for err, payload in pending.values():
                if err is None and payload:
                    _free_segment(payload[1])
            pending.clear()

    def shutdown(self):
        if self._closed:
            return
        self._closed = True
        for _ in self._procs:
            try:
                self._index_q.put(_SENTINEL)
            except Exception:
                pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        # drain any landed-but-unconsumed segments so they don't leak
        try:
            while True:
                _, _, err, payload = self._result_q.get_nowait()
                if err is None and payload:
                    _free_segment(payload[1])
        except (_queue.Empty, OSError, ValueError):
            pass
