"""paddle.io: the counterpart of ``paddle_tpu/io/__init__.py``:
Dataset / DataLoader / samplers.

ref: python/paddle/io/reader.py:262 (DataLoader), dataloader/ (workers,
samplers, collate). The samplers draw from numpy's global RNG exactly as
the JAX package's do, so under the same ``np.random.seed`` both packages
yield the same batches in the same order (``SubsetRandomSampler`` is the
exception: JAX draws its seed from ``jax.random``, the port from its own
default generator, ``framework.random``).

With ``num_workers`` > 0 the batches come from a thread-pool prefetch
feeding a bounded queue (numpy collate releases the GIL for the heavy
copies), or, with ``use_shared_memory`` (the default), from spawned
worker processes that hand each collated batch over in a
``multiprocessing.shared_memory`` block (``io/_shm_worker.py``; the JAX
package uses its native shared-memory ring there). Either way the
consumer's wait for the next batch goes to ``perf.note("data_wait")``.
Batches come out as torch tensors on the loader's device: the card unless
``device="cpu"``; ``pin_memory=True`` stages each batch in pinned host
memory and copies it to the card with ``non_blocking=True``.
"""

from __future__ import annotations

import itertools
import math
import queue as _queue

import numpy as np

import torch

from ..device import resolve_device
from ..observability.metrics import REGISTRY as _REG
from ..observability.events import EVENTS as _EVENTS
from ..observability.perf import note as _perf_note

# loader telemetry: an input pipeline that can't keep the
# accelerator fed shows up here first — queue depth trending to zero and
# the stall counter climbing mean the workers, not the model, gate step
# time.
_C_BATCHES = _REG.counter("dataloader_batches_total", "batches yielded")
_C_STALLS = _REG.counter(
    "dataloader_worker_stalls_total",
    "times the consumer waited >1s (threaded) / a 2s shm pop timed out")
_G_DEPTH = _REG.gauge("dataloader_queue_depth",
                      "prefetched batches waiting to be consumed")
_H_WAIT = _REG.histogram("dataloader_next_wait_seconds",
                         "consumer-side wait for the next batch")
_STALL_WAIT_S = 1.0


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset is not indexable")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            out.extend(sample if isinstance(sample, (list, tuple)) else [sample])
        return tuple(out)


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        di = next(i for i, c in enumerate(self.cum) if idx < c)
        prev = self.cum[di - 1] if di > 0 else 0
        return self.datasets[di][idx - prev]


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        return itertools.chain(*self.datasets)


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    total = len(dataset)
    if all(isinstance(l, float) for l in lengths):
        lengths = [int(math.floor(total * l)) for l in lengths]
        lengths[-1] = total - sum(lengths[:-1])
    if sum(lengths) != total:
        raise ValueError("lengths sum mismatch")
    perm = np.random.permutation(total).tolist()
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n]))
        offset += n
    return out


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

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
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
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

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
    """ref: python/paddle/io/dataloader/batch_sampler.py:
    DistributedBatchSampler — shards indices across data-parallel ranks."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            import torch.distributed as dist
            up = dist.is_available() and dist.is_initialized()
            num_replicas = num_replicas or (dist.get_world_size() if up
                                            else 1)
            rank = rank if rank is not None else (dist.get_rank() if up
                                                  else 0)
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n).tolist()
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
        indices += indices[: (self.total_size - len(indices))]
        local = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in local:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def default_collate_fn(batch):
    sample = batch[0]
    if isinstance(sample, (np.ndarray, np.generic)):
        return np.stack(batch)
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, (int, float)):
        return np.asarray(batch)
    if isinstance(sample, (list, tuple)):
        transposed = list(zip(*batch))
        return [default_collate_fn(list(items)) for items in transposed]
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    return batch


class DataLoader:
    """ref: python/paddle/io/reader.py:262."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, device=None, pin_memory=False):
        self.dataset = dataset
        self.device = resolve_device(device)
        self.pin_memory = bool(pin_memory) and self.device.type == "cuda"
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self._use_shared_memory = use_shared_memory
        self.prefetch_factor = max(prefetch_factor, 2)
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", batch_size)
        elif self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)
            self.batch_size = batch_size

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def _fetch(self, indices):
        samples = [self.dataset[i] for i in indices]
        return self.collate_fn(samples)

    def _to_tensors(self, batch):
        if isinstance(batch, (np.ndarray, np.generic)):
            batch = torch.from_numpy(np.asarray(batch, order="C"))
        if isinstance(batch, torch.Tensor):
            if batch.device == self.device:
                return batch
            if self.pin_memory and batch.device.type == "cpu":
                return batch.pin_memory().to(self.device, non_blocking=True)
            return batch.to(self.device)
        if isinstance(batch, (list, tuple)):
            return [self._to_tensors(b) for b in batch]
        if isinstance(batch, dict):
            return {k: self._to_tensors(v) for k, v in batch.items()}
        return batch

    def __iter__(self):
        if self._iterable_mode:
            yield from self._iter_iterable()
            return
        if self.num_workers <= 0:
            for indices in self.batch_sampler:
                _C_BATCHES.inc()
                yield self._to_tensors(self._fetch(indices))
            return
        if getattr(self, "_use_shared_memory", False):
            yield from self._iter_shm_workers()
            return
        yield from self._iter_prefetch()

    def _iter_iterable(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self._to_tensors(self.collate_fn(batch))
                batch = []
        if batch and not getattr(self, "drop_last", False):
            yield self._to_tensors(self.collate_fn(batch))

    def _iter_prefetch(self):
        """Thread-pool prefetch keeping `num_workers*prefetch_factor` batches
        in flight, preserving batch order."""
        from concurrent.futures import ThreadPoolExecutor
        depth = self.num_workers * self.prefetch_factor
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = _queue.Queue()
            it = iter(self.batch_sampler)

            def submit_next():
                try:
                    indices = next(it)
                except StopIteration:
                    return False
                pending.put(pool.submit(self._fetch, indices))
                return True

            import time as _time
            alive = True
            for _ in range(depth):
                alive = submit_next()
                if not alive:
                    break
            while not pending.empty():
                fut = pending.get()
                t0 = _time.perf_counter()
                batch = fut.result()
                waited = _time.perf_counter() - t0
                _H_WAIT.observe(waited)
                _perf_note("data_wait", waited)   # goodput attribution
                if waited > _STALL_WAIT_S:
                    _C_STALLS.inc()
                    _EVENTS.record("dataloader_stall", waited=waited,
                                   mode="prefetch")
                _G_DEPTH.set(pending.qsize())
                _C_BATCHES.inc()
                submit_next()
                yield self._to_tensors(batch)


    def _iter_shm_workers(self):
        """Spawned worker processes handing collated batches over in
        shared-memory blocks (io/_shm_worker.py), in order. Workers are
        SPAWNED — never forked: the parent's CUDA context and threads
        would be inherited half-initialised by a forked child (ref
        python/paddle/io/dataloader/worker.py). The dataset + collate_fn
        therefore must pickle — when they don't, fall back to the
        in-process prefetch path."""
        import os
        import pickle
        import multiprocessing as mp
        import queue as _q
        from ._shm_worker import run_worker, unpack

        try:
            # probe picklability WITHOUT materializing the bytes (a large
            # in-memory dataset would otherwise be copied just for the
            # check; spawn serializes it again per worker regardless)
            with open(os.devnull, "wb") as _sink:
                pickle.Pickler(_sink,
                               pickle.HIGHEST_PROTOCOL).dump(
                    (self.dataset, self.collate_fn))
        except Exception:
            import warnings
            warnings.warn(
                "DataLoader(use_shared_memory=True) needs a picklable "
                "dataset/collate_fn for spawned workers; falling back to "
                "in-process prefetch", UserWarning)
            yield from self._iter_prefetch()
            return
        batches = list(self.batch_sampler)
        nw = min(self.num_workers, max(len(batches), 1))
        ctx = mp.get_context("spawn")
        # bounded: a worker blocks on put once 2 batches a worker wait
        out_q = ctx.Queue(maxsize=max(2 * nw, 4))
        procs = [ctx.Process(
            target=run_worker,
            args=(out_q, self.dataset, self.collate_fn, batches, w, nw),
            daemon=True)
            for w in range(nw)]
        pending = {}
        try:
            for p_ in procs:
                p_.start()
            import time as _time
            expect = 0
            finished = 0
            last_progress = _time.monotonic()
            while expect < len(batches):
                if expect in pending:
                    batch = pending.pop(expect)
                else:
                    # short-poll get + liveness check: a worker killed
                    # (SIGKILL/OOM) without reporting must not stall this
                    # loop for one huge blocking get
                    t0 = _time.perf_counter()
                    try:
                        seq, payload = out_q.get(timeout=2.0)
                    except _q.Empty:
                        # the consumer's wait IS data starvation, as on
                        # the threaded path
                        _perf_note("data_wait",
                                   _time.perf_counter() - t0)
                        _C_STALLS.inc()
                        _EVENTS.record("dataloader_stall", mode="shm",
                                       produced=expect,
                                       total=len(batches))
                        if finished >= nw or not any(p_.is_alive()
                                                     for p_ in procs):
                            raise RuntimeError(
                                f"DataLoader workers exited after "
                                f"producing {expect}/{len(batches)} "
                                "batches (a worker crashed without "
                                "reporting an error)")
                        if _time.monotonic() - last_progress > 120.0:
                            raise TimeoutError(
                                f"DataLoader workers alive but produced "
                                f"nothing for 120s "
                                f"({expect}/{len(batches)} batches)")
                        continue
                    _perf_note("data_wait", _time.perf_counter() - t0)
                    if seq == "__error__":
                        raise RuntimeError(
                            f"DataLoader worker failed:\n{payload}")
                    if seq == "__done__":
                        finished += 1
                        continue
                    batch = unpack(payload)
                    last_progress = _time.monotonic()
                    if seq != expect:
                        pending[seq] = batch
                        continue
                _G_DEPTH.set(len(pending))
                _C_BATCHES.inc()
                yield self._to_tensors(batch)
                expect += 1
        finally:
            for p_ in procs:
                if p_.is_alive():
                    p_.terminate()
            for p_ in procs:
                p_.join(5)
            # blocks still queued (an early exit) are freed here
            while True:
                try:
                    seq, payload = out_q.get_nowait()
                except (_q.Empty, OSError, ValueError):
                    break
                if seq not in ("__error__", "__done__"):
                    unpack(payload)
            out_q.close()


def get_worker_info():
    return None


class SubsetRandomSampler:
    """ref: python/paddle/io/sampler.py SubsetRandomSampler."""

    def __init__(self, indices):
        self.indices = list(indices)

    def __iter__(self):
        from ..framework.random import next_seed
        order = np.random.default_rng(next_seed()).permutation(
            len(self.indices))
        return iter([self.indices[i] for i in order])

    def __len__(self):
        return len(self.indices)


__all__ = ["BatchSampler", "ChainDataset", "ComposeDataset", "ConcatDataset",
           "DataLoader", "Dataset", "DistributedBatchSampler",
           "IterableDataset", "RandomSampler", "Sampler", "SequenceSampler",
           "Subset", "SubsetRandomSampler", "TensorDataset",
           "WeightedRandomSampler", "default_collate_fn", "get_worker_info",
           "random_split"]
