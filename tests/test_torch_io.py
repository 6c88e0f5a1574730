"""The port's data IO (``paddle_tpu_torch.io``) vs the JAX package's.

The same numpy datasets go through both packages' DataLoaders, and the
batches must be equal element for element (the port's come out as CPU
torch tensors, the reference's as its Tensors):

- plain batching with and without ``drop_last``, an uneven tail, nested
  dict/tuple samples and an ``IterableDataset``;
- ``shuffle=True`` under one ``np.random.seed`` (both samplers draw their
  permutation from numpy's global state);
- 2 thread workers, in order; process workers (spawn, shared memory), in
  order, against the reference's inline batches;
- every sampler under one numpy seed, and the port's samplers given an
  ``np.random.Generator``; ``DistributedBatchSampler`` raises naming
  ROADMAP.md queue 1 item 10;
- ``random_split``, ``ConcatDataset``, ``Subset``, ``ComposeDataset`` and
  ``ChainDataset``;
- a worker's error reaches the caller (inline, threads, processes);
- the loader's ``batch_wait_s``/``batches`` readings, and
  ``device_prefetch`` on the CPU (nothing copied) and with no GPU (raises).
"""
import numpy as np
import pytest
import torch

import paddle_tpu.io as rio
import paddle_tpu_torch.io as pio
from paddle_tpu_torch.io import dataloader as pdl
from torch_threads import one_torch_thread  # noqa: F401


def _np(x):
    if torch.is_tensor(x):
        return x.numpy()
    if hasattr(x, "_value"):
        return np.asarray(x._value)
    return np.asarray(x)


def _flat(batch):
    """A batch as a flat list of numpy arrays, dict keys in order."""
    if isinstance(batch, dict):
        return [a for k in batch for a in _flat(batch[k])]
    if isinstance(batch, (list, tuple)):
        return [a for b in batch for a in _flat(b)]
    return [_np(batch)]


def _assert_same(port_batches, ref_batches):
    assert len(port_batches) == len(ref_batches)
    for pb, rb in zip(port_batches, ref_batches):
        pf, rf = _flat(pb), _flat(rb)
        assert len(pf) == len(rf)
        for a, b in zip(pf, rf):
            assert a.shape == b.shape and a.dtype == b.dtype, (a.shape,
                                                               b.shape)
            np.testing.assert_array_equal(a, b)


def _arrays(n=37, din=5, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, din)).astype(np.float32),
            rng.integers(0, 4, n).astype(np.int64))


def _pair(xs, ys):
    return (pio.TensorDataset([xs, ys]),
            rio.TensorDataset([xs, ys]))


class _Items(rio.Dataset):
    """Nested samples: a dict of an image, a tuple and a Python scalar."""

    def __init__(self, n=11):
        rng = np.random.default_rng(3)
        self.img = rng.standard_normal((n, 2, 3)).astype(np.float32)
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"img": self.img[i],
                "pair": (np.int64(i), float(i) / 2)}


class _PortItems(pio.Dataset):
    def __init__(self, n=11):
        self._ref = _Items(n)

    def __len__(self):
        return len(self._ref)

    def __getitem__(self, i):
        return self._ref[i]


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("batch_size", [1, 8, 37, 64])
def test_batches_equal(batch_size, drop_last):
    pds, rds = _pair(*_arrays())
    kw = dict(batch_size=batch_size, drop_last=drop_last)
    port = list(pio.DataLoader(pds, **kw))
    _assert_same(port, list(rio.DataLoader(rds, **kw)))
    assert len(port) == len(pio.DataLoader(pds, **kw))
    assert all(torch.is_tensor(t) for b in port for t in b)


def test_nested_samples_equal():
    port = list(pio.DataLoader(_PortItems(), batch_size=4))
    _assert_same(port, list(rio.DataLoader(_Items(), batch_size=4)))
    assert set(port[0]) == {"img", "pair"}
    assert port[-1]["img"].shape == (3, 2, 3)


def test_torch_tensor_dataset():
    xs, ys = _arrays()
    pds = pio.TensorDataset([torch.from_numpy(xs), torch.from_numpy(ys)])
    _assert_same(list(pio.DataLoader(pds, batch_size=10)),
                 list(rio.DataLoader(rio.TensorDataset([xs, ys]),
                                     batch_size=10)))


def test_shuffle_under_one_numpy_seed():
    pds, rds = _pair(*_arrays(53))
    np.random.seed(7)
    port = [list(pio.DataLoader(pds, batch_size=8, shuffle=True))
            for _ in range(2)]
    np.random.seed(7)
    ref = [list(rio.DataLoader(rds, batch_size=8, shuffle=True))
           for _ in range(2)]
    for p, r in zip(port, ref):
        _assert_same(p, r)
    # the second epoch draws a new order
    assert not np.array_equal(_np(port[0][0][0]), _np(port[1][0][0]))


def test_two_thread_workers_in_order():
    pds, rds = _pair(*_arrays(101))
    port = list(pio.DataLoader(pds, batch_size=7, num_workers=2))
    _assert_same(port, list(rio.DataLoader(rds, batch_size=7)))
    _assert_same(port, list(rio.DataLoader(rds, batch_size=7,
                                           num_workers=2)))


def test_process_workers_in_order():
    xs, ys = _arrays(45)
    pds = pio.TensorDataset([xs, ys])
    loader = pio.DataLoader(pds, batch_size=6, num_workers=2,
                            use_process_workers=True)
    port = list(loader)
    _assert_same(port, list(rio.DataLoader(rio.TensorDataset([xs, ys]),
                                           batch_size=6)))
    assert loader._pool is None  # not persistent: shut down after the epoch


def test_process_workers_need_a_worker():
    pds, _ = _pair(*_arrays())
    with pytest.raises(ValueError, match="num_workers >= 1"):
        pio.DataLoader(pds, num_workers=0, use_process_workers=True)


class _Bad(pio.Dataset):
    def __len__(self):
        return 10

    def __getitem__(self, i):
        if i == 3:
            raise RuntimeError("boom")
        return np.zeros(2, dtype="float32")


def _bad_index():
    """A picklable dataset whose fourth item raises in the worker (a spawn
    worker imports it without this test module)."""
    pds, _ = _pair(*_arrays(10))
    return pio.Subset(pds, [0, 1, 2, 999, 4])


@pytest.mark.parametrize("workers,make,exc,match", [
    (dict(num_workers=0), _Bad, RuntimeError, "boom"),
    (dict(num_workers=2), _Bad, RuntimeError, "boom"),
    (dict(num_workers=2, use_process_workers=True), _bad_index, IndexError,
     "out of bounds")], ids=["inline", "threads", "processes"])
def test_worker_error_reaches_the_caller(workers, make, exc, match):
    with pytest.raises(exc, match=match):
        for _ in pio.DataLoader(make(), batch_size=2, **workers):
            pass


def test_early_exit_stops_the_producer():
    import threading
    pds, _ = _pair(*_arrays(200))
    before = set(threading.enumerate())
    it = iter(pio.DataLoader(pds, batch_size=2, num_workers=1))
    next(it)
    started = [t for t in set(threading.enumerate()) - before
               if getattr(getattr(t, "_target", None), "__name__", "")
               == "producer"]
    assert len(started) == 1 and started[0].is_alive()
    it.close()  # the producer must not stay blocked on the full queue
    assert not started[0].is_alive()


class _Stream(rio.IterableDataset):
    def __iter__(self):
        for i in range(10):
            yield np.full(3, i, np.float32)


class _PortStream(pio.IterableDataset):
    def __iter__(self):
        return iter(_Stream())


@pytest.mark.parametrize("drop_last", [False, True])
def test_iterable_dataset(drop_last):
    port = list(pio.DataLoader(_PortStream(), batch_size=4,
                               drop_last=drop_last))
    _assert_same(port, list(rio.DataLoader(_Stream(), batch_size=4,
                                           drop_last=drop_last)))
    with pytest.raises(TypeError):
        len(pio.DataLoader(_PortStream(), batch_size=4))


def _sampler_cases(n=23):
    data = list(range(n))
    return {
        "sequence": (lambda m: m.SequenceSampler(data)),
        "random": (lambda m: m.RandomSampler(data)),
        "random_num_samples": (lambda m: m.RandomSampler(
            data, num_samples=9)),
        "random_replacement": (lambda m: m.RandomSampler(
            data, replacement=True, num_samples=40)),
        "subset_random": (lambda m: m.SubsetRandomSampler(
            [3, 5, 8, 13, 21])),
        "weighted": (lambda m: m.WeightedRandomSampler(
            np.linspace(0.1, 2.0, n), 30)),
        "weighted_no_replacement": (lambda m: m.WeightedRandomSampler(
            np.linspace(0.1, 2.0, n), 10, replacement=False)),
        "batch_sequence": (lambda m: m.BatchSampler(
            dataset=data, batch_size=5)),
        "batch_shuffle_drop_last": (lambda m: m.BatchSampler(
            dataset=data, shuffle=True, batch_size=5, drop_last=True)),
        "batch_over_sampler": (lambda m: m.BatchSampler(
            sampler=m.RandomSampler(data), batch_size=4)),
    }


@pytest.mark.parametrize("case", sorted(_sampler_cases()))
def test_samplers_equal(case):
    make = _sampler_cases()[case]
    np.random.seed(11)
    port = [list(make(pio)) for _ in range(2)]
    np.random.seed(11)
    ref = [list(make(rio)) for _ in range(2)]
    assert port == ref
    assert len(make(pio)) == len(make(rio))


def test_samplers_take_a_numpy_generator():
    data = list(range(31))
    a = list(pio.RandomSampler(data, generator=np.random.default_rng(5)))
    b = list(pio.RandomSampler(data, generator=np.random.default_rng(5)))
    assert a == b and sorted(a) == data
    np.testing.assert_array_equal(a, np.random.default_rng(5).permutation(31))
    r = list(pio.RandomSampler(data, replacement=True, num_samples=50,
                               generator=np.random.default_rng(6)))
    assert len(r) == 50 and all(0 <= i < 31 for i in r)
    s = list(pio.SubsetRandomSampler([2, 4, 6, 8],
                                     generator=np.random.default_rng(1)))
    assert sorted(s) == [2, 4, 6, 8]
    with pytest.raises(TypeError, match="np.random.Generator"):
        list(pio.RandomSampler(data, generator=torch.Generator()))
    # a generator leaves numpy's global state alone
    np.random.seed(3)
    want = np.random.rand()
    np.random.seed(3)
    list(pio.RandomSampler(data, generator=np.random.default_rng(0)))
    assert np.random.rand() == want


def test_distributed_batch_sampler_names_its_item():
    with pytest.raises(NotImplementedError, match="item 10"):
        pio.DistributedBatchSampler(list(range(10)), batch_size=2,
                                    num_replicas=2, rank=0)


def test_random_split_concat_subset_compose_chain():
    xs, ys = _arrays(20)
    pds, rds = _pair(xs, ys)
    np.random.seed(4)
    pa, pb = pio.random_split(pds, [13, 7])
    np.random.seed(4)
    ra, rb = rio.random_split(rds, [13, 7])
    assert pa.indices == ra.indices and pb.indices == rb.indices
    np.random.seed(5)
    pf = pio.random_split(pds, [0.5, 0.3, 0.2])
    np.random.seed(5)
    rf = rio.random_split(rds, [0.5, 0.3, 0.2])
    assert [s.indices for s in pf] == [s.indices for s in rf]
    pc, rc = pio.ConcatDataset([pa, pb]), rio.ConcatDataset([ra, rb])
    assert len(pc) == len(rc) == 20
    for i in (0, 12, 13, 19, -1, -20):
        _assert_same([pc[i]], [rc[i]])
    ps, rs = pio.Subset(pc, [19, 0, 7]), rio.Subset(rc, [19, 0, 7])
    _assert_same(list(pio.DataLoader(ps, batch_size=2)),
                 list(rio.DataLoader(rs, batch_size=2)))
    pco = pio.ComposeDataset([pds, pio.TensorDataset([ys])])
    rco = rio.ComposeDataset([rds, rio.TensorDataset([ys])])
    assert len(pco) == len(rco)
    _assert_same(list(pio.DataLoader(pco, batch_size=6)),
                 list(rio.DataLoader(rco, batch_size=6)))
    pch = pio.ChainDataset([_PortStream(), _PortStream()])
    rch = rio.ChainDataset([_Stream(), _Stream()])
    _assert_same(list(pio.DataLoader(pch, batch_size=7)),
                 list(rio.DataLoader(rch, batch_size=7)))


def test_collate_and_convert_functions():
    batch = [{"a": np.ones(2, np.float32) * i, "b": (i, float(i))}
             for i in range(3)]
    p = pio.default_collate_fn(batch)
    r = rio.default_collate_fn(batch)
    _assert_same([p], [r])
    t = pio.default_collate_fn([torch.ones(2) * i for i in range(3)])
    assert torch.is_tensor(t) and t.shape == (3, 2)
    from collections import namedtuple
    Pt = namedtuple("Pt", "x y")
    c = pio.default_convert_fn([Pt(1, 2.0), {"k": 3}])
    assert isinstance(c[0], Pt) and c[0].x.shape == () and c[1]["k"] == 3
    assert pio.get_worker_info() is None
    assert "id=1" in repr(pio.WorkerInfo(1, 2, 3, None))


def test_pinned_collate_stacks_as_the_default(monkeypatch):
    """pin_memory=True stacks into the tensor torch.empty hands out (page-
    locked on a CUDA box; recorded here, where there is none)."""
    pinned = []
    empty = torch.empty

    def fake_empty(*shape, pin_memory=False, **kw):
        pinned.append(pin_memory)
        return empty(*shape, **kw)

    monkeypatch.setattr(torch, "empty", fake_empty)
    pds, rds = _pair(*_arrays(21))
    port = list(pio.DataLoader(pds, batch_size=8, pin_memory=True,
                               num_workers=1))
    _assert_same(port, list(rio.DataLoader(rds, batch_size=8)))
    assert pinned == [True] * 6  # features and labels of 3 batches
    items = list(pio.DataLoader(_PortItems(), batch_size=4,
                                pin_memory=True))
    _assert_same(items, list(rio.DataLoader(_Items(), batch_size=4)))


def test_loader_wait_readings():
    pds, _ = _pair(*_arrays(30))
    loader = pio.DataLoader(pds, batch_size=8, num_workers=2)
    list(loader)
    list(loader)
    assert loader.batches == 8
    assert loader.batch_wait_s > 0.0


def test_device_prefetch_on_the_cpu():
    pds, rds = _pair(*_arrays(30))
    loader = pio.DataLoader(pds, batch_size=8)
    got = list(pio.device_prefetch(loader, device="cpu", size=3))
    _assert_same(got, list(rio.DataLoader(rds, batch_size=8)))
    assert all(t.device.type == "cpu" for b in got for t in b)
    # numpy leaves become tensors; other leaves pass through
    out = list(pio.device_prefetch([(np.zeros(2), "tag")], device="cpu"))
    assert torch.is_tensor(out[0][0]) and out[0][1] == "tag"


def test_device_prefetch_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        next(pio.device_prefetch([np.zeros(2)]))
    with pytest.raises(RuntimeError, match="no GPU"):
        next(pdl.device_prefetch([np.zeros(2)], device="cuda"))
