"""The port's ``paddle_tpu_torch.io`` against the JAX package's
``paddle_tpu.io``.

Every sampler and ``DataLoader`` mode draws from numpy's global RNG as
the JAX package's does, so under the same ``np.random.seed`` both yield
the same batches in the same order, with values (and types) exact:
``shuffle``, ``drop_last``, an explicit ``BatchSampler``, the
``DistributedBatchSampler`` for each rank of a world (with and without
shuffle, across epochs), the thread prefetch, the shared-memory worker
processes, dict and tuple samples through ``default_collate_fn``, the
datasets (``ComposeDataset``, ``ConcatDataset``, ``ChainDataset``,
``Subset``, ``random_split``), ``RandomSampler`` with replacement,
``WeightedRandomSampler``. Also: the prefetch wait reaches an active
``perf.StepTimer`` as ``data_wait``; batches are torch tensors on the
loader's device (the card unless ``device="cpu"``: without one the
loader refuses); ``SubsetRandomSampler`` (seeded from the port's own
generator) permutes its subset reproducibly.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio

import paddle_tpu_torch.io as tio
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.observability import perf as tperf

X = np.arange(45 * 3, dtype=np.float32).reshape(45, 3) / 7.0
Y = np.arange(45, dtype=np.int64) * 3


def _np(b):
    return b.numpy() if hasattr(b, "numpy") else np.asarray(b)


def _flat(batch):
    """The arrays of a batch (nests of lists, tuples and dicts), in order
    (dicts by key)."""
    if isinstance(batch, dict):
        return [a for k in sorted(batch) for a in _flat(batch[k])]
    if isinstance(batch, (list, tuple)):
        return [a for b in batch for a in _flat(b)]
    return [_np(batch)]


def _batches(loader):
    return [_flat(batch) for batch in loader]


def _same(a, b):
    assert len(a) == len(b)
    for p, q in zip(a, b):
        assert len(p) == len(q)
        for u, v in zip(p, q):
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)


def _run(io, seed, make_loader):
    np.random.seed(seed)
    kw = {"device": "cpu"} if io is tio else {}
    return _batches(make_loader(io, kw))


MODES = {
    "sequential": lambda io, kw: io.DataLoader(
        io.TensorDataset([X, Y]), batch_size=8, **kw),
    "shuffle": lambda io, kw: io.DataLoader(
        io.TensorDataset([X, Y]), batch_size=8, shuffle=True, **kw),
    "shuffle_drop_last": lambda io, kw: io.DataLoader(
        io.TensorDataset([X, Y]), batch_size=8, shuffle=True,
        drop_last=True, **kw),
    "batch_sampler": lambda io, kw: io.DataLoader(
        io.TensorDataset([X, Y]), batch_sampler=io.BatchSampler(
            io.TensorDataset([X, Y]), shuffle=True, batch_size=6), **kw),
    "random_replacement": lambda io, kw: io.DataLoader(
        io.TensorDataset([X, Y]), batch_sampler=io.BatchSampler(
            sampler=io.RandomSampler(io.TensorDataset([X, Y]),
                                     replacement=True, num_samples=30),
            batch_size=7), **kw),
    "weighted": lambda io, kw: io.DataLoader(
        io.TensorDataset([X, Y]), batch_sampler=io.BatchSampler(
            sampler=io.WeightedRandomSampler(np.linspace(0.1, 2.0, 45), 20),
            batch_size=5), **kw),
    "prefetch_threads": lambda io, kw: io.DataLoader(
        io.TensorDataset([X, Y]), batch_size=4, shuffle=True,
        num_workers=3, use_shared_memory=False, **kw),
    "prefetch_threads_drop_last": lambda io, kw: io.DataLoader(
        io.TensorDataset([X, Y]), batch_size=4, shuffle=True,
        drop_last=True, num_workers=2, use_shared_memory=False, **kw),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_loader_modes_equal_jax(mode):
    want = _run(jio, 11, MODES[mode])
    got = _run(tio, 11, MODES[mode])
    _same(got, want)
    assert len(got) > 1


def test_shared_memory_workers_equal_jax():
    """Spawned worker processes (both packages), shuffled, odd tail."""
    make = lambda io, kw: io.DataLoader(  # noqa: E731
        io.TensorDataset([X, Y]), batch_size=4, shuffle=True,
        num_workers=2, use_shared_memory=True, **kw)
    want = _run(jio, 5, make)
    got = _run(tio, 5, make)
    _same(got, want)
    assert len(got) == 12


@pytest.mark.parametrize("shuffle", [False, True])
def test_distributed_batch_sampler_equal_jax(shuffle):
    for world in (2, 3):
        for rank in range(world):
            for epoch in (0, 1):
                samplers = []
                for io in (jio, tio):
                    s = io.DistributedBatchSampler(
                        io.TensorDataset([X, Y]), batch_size=4,
                        num_replicas=world, rank=rank, shuffle=shuffle,
                        drop_last=rank == 1)
                    s.set_epoch(epoch)
                    samplers.append(s)
                j, t = (list(s) for s in samplers)
                assert t == j and len(t) == len(samplers[1])
                want = _batches(jio.DataLoader(jio.TensorDataset([X, Y]),
                                               batch_sampler=samplers[0]))
                got = _batches(tio.DataLoader(tio.TensorDataset([X, Y]),
                                              batch_sampler=samplers[1],
                                              device="cpu"))
                _same(got, want)


class _DictDS:
    def __init__(self, io):
        self.io = io

    def __len__(self):
        return 20

    def __getitem__(self, i):
        return {"x": X[i], "n": int(Y[i]), "pair": (X[i, :2], float(i))}


@pytest.mark.parametrize("io_mode", ["dict", "tuple"])
def test_collate_nested_samples_equal_jax(io_mode):
    def make(io, kw):
        if io_mode == "dict":
            ds = _DictDS(io)

            class _D(io.Dataset):
                def __len__(self):
                    return len(ds)

                def __getitem__(self, i):
                    return ds[i]
            return io.DataLoader(_D(), batch_size=6, shuffle=True, **kw)
        return io.DataLoader(io.ComposeDataset(
            [io.TensorDataset([X]), io.TensorDataset([Y])]),
            batch_size=6, shuffle=True, **kw)
    want = _run(jio, 2, make)
    got = _run(tio, 2, make)
    _same(got, want)
    assert len(got[0]) == (4 if io_mode == "dict" else 2)


def test_datasets_and_random_split_equal_jax():
    for io in (jio, tio):
        a = io.TensorDataset([X[:10]])
        b = io.TensorDataset([X[10:25]])
        cat = io.ConcatDataset([a, b])
        assert len(cat) == 25
        np.testing.assert_array_equal(cat[12][0], X[12])
        np.testing.assert_array_equal(cat[-1][0], X[24])
        sub = io.Subset(cat, [3, 20, 7])
        np.testing.assert_array_equal(sub[1][0], X[20])
    splits = []
    for io in (jio, tio):
        np.random.seed(4)
        parts = io.random_split(io.TensorDataset([X, Y]), [0.5, 0.3, 0.2])
        splits.append([p.indices for p in parts])
    assert splits[1] == splits[0]
    assert sum(len(p) for p in splits[1]) == len(X)


def test_iterable_and_chain_datasets_equal_jax():
    def make(io, kw):
        class _It(io.IterableDataset):
            def __init__(self, lo, hi):
                self.lo, self.hi = lo, hi

            def __iter__(self):
                return iter(X[self.lo:self.hi])
        return io.DataLoader(io.ChainDataset([_It(0, 7), _It(20, 31)]),
                             batch_size=4, **kw)
    _same(_run(tio, 0, make), _run(jio, 0, make))
    with pytest.raises(TypeError):
        len(make(tio, {"device": "cpu"}))


def test_prefetch_wait_reaches_the_step_timer_as_data_wait():
    class _Slow(tio.Dataset):
        def __len__(self):
            return 6

        def __getitem__(self, i):
            import time
            time.sleep(0.02)
            return np.full(2, i, np.float32)

    timer = tperf.StepTimer(peak=1e12)
    with timer.step():
        pass                                 # attach the timer
    before = timer.totals()["phases"].get("data_wait", 0.0)
    loader = tio.DataLoader(_Slow(), batch_size=2, num_workers=1,
                            use_shared_memory=False, device="cpu")
    got = [b.numpy() for b in loader]
    timer.detach()
    assert [list(b[:, 0]) for b in got] == [[0, 1], [2, 3], [4, 5]]
    assert timer.totals()["phases"]["data_wait"] > before


def test_batches_are_torch_tensors_on_the_loader_device():
    loader = tio.DataLoader(tio.TensorDataset([X, Y]), batch_size=5,
                            device="cpu", pin_memory=True)
    x, y = next(iter(loader))
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    assert x.dtype == torch.float32 and y.dtype == torch.int64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tio.DataLoader(tio.TensorDataset([X, Y]), batch_size=5)


def test_subset_random_sampler_reproducible_permutation():
    orders = []
    for _ in range(2):
        trandom.seed(3)
        orders.append(list(tio.SubsetRandomSampler([4, 9, 2, 30, 11])))
    assert orders[0] == orders[1]
    assert sorted(orders[0]) == [2, 4, 9, 11, 30]
