"""Datasets, samplers and ``DataLoader`` (counterpart of
paddle_tpu/io/__init__.py).

The datasets and samplers are the reference's. The samplers draw from
numpy's global random state, as there (``RandomSampler``,
``WeightedRandomSampler``, ``random_split``; ``DistributedBatchSampler``
shuffles from ``RandomState(epoch)``), so ``np.random.seed`` fixes an
epoch's order in both packages. ``DistributedBatchSampler`` takes its
world size and rank from ``torch.distributed`` when a process group is
up, else 1 and 0.

``default_collate_fn`` stacks samples into CPU tensors (numpy float64
becomes float32, as in the reference; integers stay int64, torch's index
type, where the reference's JAX arrays narrow them to int32). The loader
then moves each batch to its ``device``: the card unless the caller
passes ``device="cpu"``. With ``pin_memory`` and a card, each array is
collated straight into a page-locked buffer from PyTorch's caching host
allocator, which recycles the buffers as the reference's
``HostBufferPool`` does (a worker's batch, and a custom collate's
tensors, are copied into one), and copied to the card without
blocking.

Workers. ``num_workers > 0`` forks worker processes, as the reference
does (``_MPIterator``): index batches fan out round-robin, at most
``num_workers * prefetch_factor`` in flight, results come back through
shared memory and are yielded in order; ``worker_init_fn(id)`` runs first
in each worker, ``get_worker_info()`` answers inside one, an exception in
a worker raises in the parent, a worker that dies raises, and ``timeout``
seconds without a batch raise. A forked worker must not touch torch: the
parent may have initialised CUDA and torch's thread pool before the fork,
and a child that uses either can hang. So the default collate stages
numpy arrays in the worker and the parent makes the tensors; a dataset
for workers returns numpy arrays or numbers (a custom ``collate_fn`` runs
in the worker, as in the reference, under the same rule). An
``IterableDataset``, or ``use_shared_memory=False``, takes a thread
instead (the reference's threaded prefetch).

Arguments the reference accepts and never applies raise
``NotImplementedError`` for any value but the default ("Faults of the
reference" 18 in ROADMAP.md): the loader's ``feed_list``, ``places``,
``return_list``, ``use_buffer_reader`` and ``persistent_workers``, and
``RandomSampler``'s ``generator``.
"""
from __future__ import annotations

import itertools
import math
import os
import queue
import threading
import time

import numpy as np
import torch

from ..device import resolve_device


def _refuse(what, name, value):
    raise NotImplementedError(
        "%s(%s=%r): the reference accepts it and never applies it "
        "(\"Faults of the reference\" 18 in ROADMAP.md)" % (what, name, value))


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
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


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


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths):
    total = len(dataset)
    if sum(lengths) != total:
        raise ValueError("sum of lengths != dataset size")
    perm = np.random.permutation(total).tolist()
    out = []
    off = 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n]))
        off += n
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
        if generator is not None:
            _refuse("RandomSampler", "generator", generator)
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
    """Each rank's share of the indices, in batches (the reference's
    ``DistributedBatchSampler``)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        dist = torch.distributed
        up = dist.is_available() and dist.is_initialized()
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None else (
            dist.get_world_size() if up else 1)
        self.local_rank = rank if rank is not None else (
            dist.get_rank() if up else 0)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[: (self.total_size - len(indices))]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
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


def _np_batch(arr):
    return arr.astype(np.float32) if arr.dtype == np.float64 else arr




def _default_collate_numpy(batch):
    """The default collate staged as numpy arrays: what a worker builds
    (it must not touch torch); the parent makes the tensors."""
    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return [_default_collate_numpy([b[i] for b in batch])
                for i in range(len(sample))]
    if isinstance(sample, dict):
        return {k: _default_collate_numpy([b[k] for b in batch])
                for k in sample}
    if isinstance(sample, torch.Tensor):
        return np.stack([b.numpy() for b in batch])
    if isinstance(sample, np.ndarray):
        return _np_batch(np.stack(batch))
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return _np_batch(np.asarray(batch))
    return batch


def _tree_to_tensor(obj):
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(_np_batch(obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_to_tensor(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _tree_to_tensor(v) for k, v in obj.items()}
    return obj


def default_collate_fn(batch):
    """Samples stacked along a new first axis into CPU tensors, through
    tuples, lists and dicts; float64 becomes float32."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, (tuple, list)):
        return [default_collate_fn([b[i] for b in batch])
                for i in range(len(sample))]
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch])
                for k in sample}
    return _tree_to_tensor(_default_collate_numpy(batch))


def _pinned_collate(batch):
    """``default_collate_fn`` with each numpy batch assembled in a
    page-locked buffer."""
    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return [_pinned_collate([b[i] for b in batch])
                for i in range(len(sample))]
    if isinstance(sample, dict):
        return {k: _pinned_collate([b[k] for b in batch]) for k in sample}
    if isinstance(sample, np.ndarray):
        dtype = np.float32 if sample.dtype == np.float64 else sample.dtype
        buf = torch.empty((len(batch),) + sample.shape, pin_memory=True,
                          dtype=torch.from_numpy(np.empty(0, dtype)).dtype)
        view = buf.numpy()
        for i, b in enumerate(batch):
            view[i] = b
        return buf
    return default_collate_fn(batch)


def _pin(obj):
    """CPU tensors of a batch copied into page-locked buffers."""
    if isinstance(obj, torch.Tensor):
        return obj if obj.is_pinned() else obj.pin_memory()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pin(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _pin(v) for k, v in obj.items()}
    return obj


def _to_device(obj, device, non_blocking):
    if isinstance(obj, torch.Tensor):
        return obj.to(device, non_blocking=non_blocking)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(o, device, non_blocking) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_device(v, device, non_blocking)
                for k, v in obj.items()}
    return obj


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, pin_memory=False, device=None):
        for name, value, default in (
                ("feed_list", feed_list, None), ("places", places, None),
                ("return_list", return_list, True),
                ("use_buffer_reader", use_buffer_reader, True),
                ("persistent_workers", persistent_workers, False)):
            if value != default:
                _refuse("DataLoader", name, value)
        self.dataset = dataset
        self.device = resolve_device(device)
        # pinning serves host -> card copies only
        self.pin_memory = bool(pin_memory) and self.device.type == "cuda"
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def _collate(self, batch):
        if self.pin_memory and self.collate_fn is default_collate_fn:
            return _pinned_collate(batch)
        return self.collate_fn(batch)

    def _place(self, batch):
        if self.pin_memory:
            batch = _pin(batch)
        return _to_device(batch, self.device, self.pin_memory)

    def _batches(self):
        if self._iterable_mode:
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                yield self._collate(batch)
        else:
            for idx_batch in self.batch_sampler:
                yield self._collate([self.dataset[i] for i in idx_batch])

    def __iter__(self):
        if self.num_workers <= 0:
            for batch in self._batches():
                yield self._place(batch)
            return
        mp_iter = None
        if self.use_shared_memory is not False and not self._iterable_mode:
            try:
                # only a failure to start the workers (no processes or
                # shared memory here) takes the thread; an error
                # mid-epoch propagates
                mp_iter = _MPIterator(self)
            except (ImportError, OSError):
                mp_iter = None
        if mp_iter is not None:
            for batch in mp_iter:
                yield self._place(batch)
            return
        q = queue.Queue(maxsize=self.num_workers * self.prefetch_factor)
        stop = object()
        failure = []

        def producer():
            try:
                for b in self._batches():
                    q.put(b)
            except Exception as e:   # raised again in the consumer
                failure.append(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield self._place(item)
        t.join()
        if failure:
            raise failure[0]


# -- worker processes -------------------------------------------------------
#
# The reference's _MPIterator: index batches to each worker's queue,
# results through one queue, array payloads through shared memory (only
# (name, dtype, shape) is pickled).

class WorkerInfo:
    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = None


def get_worker_info():
    """Inside a worker process its ``WorkerInfo`` (id, num_workers,
    dataset); None in the main process."""
    return _worker_info


def _shm_pack(batch):
    from multiprocessing import resource_tracker, shared_memory

    blocks = []

    def pack(x):
        if isinstance(x, np.ndarray) and x.nbytes > 0:
            shm = shared_memory.SharedMemory(create=True, size=x.nbytes)
            np.ndarray(x.shape, x.dtype, buffer=shm.buf)[...] = x
            blocks.append(shm)
            # the parent owns the segment and unlinks it; untracked here,
            # or this worker's resource tracker would unlink it at exit
            resource_tracker.unregister(shm._name, "shared_memory")
            return ("__shm__", shm.name, x.dtype.str, x.shape)
        return x

    def walk(obj):
        if isinstance(obj, (list, tuple)):
            return type(obj)(walk(o) for o in obj)
        if isinstance(obj, dict):
            return {k: walk(v) for k, v in obj.items()}
        return pack(obj)

    out = walk(batch)
    for shm in blocks:
        shm.close()
    return out


def _shm_unpack(obj):
    from multiprocessing import shared_memory

    if isinstance(obj, tuple) and len(obj) == 4 and obj[0] == "__shm__":
        _, name, dtype, shape = obj
        shm = shared_memory.SharedMemory(name=name)
        try:
            return np.ndarray(shape, np.dtype(dtype), buffer=shm.buf).copy()
        finally:
            shm.close()
            shm.unlink()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_shm_unpack(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _shm_unpack(v) for k, v in obj.items()}
    return obj


def _worker_loop(dataset, collate_fn, index_q, result_q, wid, nworkers,
                 use_shm, init_fn):
    global _worker_info
    _worker_info = WorkerInfo(wid, nworkers, dataset)
    if init_fn is not None:
        init_fn(wid)
    while True:
        item = index_q.get()
        if item is None:
            break
        bidx, indices = item
        try:
            batch = collate_fn([dataset[i] for i in indices])
            payload = _shm_pack(batch) if use_shm else batch
            result_q.put((bidx, payload, None))
        except Exception as e:   # raised again in the parent
            result_q.put((bidx, None, "%s: %s" % (type(e).__name__, e)))


class _MPIterator:
    """Ordered iteration over forked workers (the reference's
    ``_MPIterator``)."""

    def __init__(self, loader):
        import multiprocessing as mp

        self.loader = loader
        ctx = mp.get_context("fork" if hasattr(os, "fork") else "spawn")
        n = loader.num_workers
        self._index_qs = [ctx.Queue() for _ in range(n)]
        self._result_q = ctx.Queue()
        # workers stage numpy; the parent makes the tensors
        self._numpy_mode = loader.collate_fn is default_collate_fn
        worker_collate = (_default_collate_numpy if self._numpy_mode
                          else loader.collate_fn)
        self._procs = [
            ctx.Process(
                target=_worker_loop,
                args=(loader.dataset, worker_collate, self._index_qs[w],
                      self._result_q, w, n, loader.use_shared_memory,
                      loader.worker_init_fn),
                daemon=True)
            for w in range(n)]
        for p in self._procs:
            p.start()

    def _recv(self, user_timeout):
        """One result; a dead worker or ``timeout`` without a batch
        raises instead of waiting forever."""
        deadline = (time.monotonic() + user_timeout) if user_timeout \
            else None
        while True:
            try:
                return self._result_q.get(timeout=1.0)
            except queue.Empty:
                dead = [p for p in self._procs
                        if not p.is_alive() and p.exitcode not in (0, None)]
                if dead:
                    raise RuntimeError(
                        "DataLoader worker(s) died unexpectedly "
                        "(exitcodes %s)" % [p.exitcode for p in dead])
                if deadline is not None and time.monotonic() > deadline:
                    raise RuntimeError(
                        "DataLoader timed out after %.1fs waiting for a "
                        "batch (timeout=%s)" % (user_timeout, user_timeout))

    def __iter__(self):
        loader = self.loader
        n = loader.num_workers
        user_timeout = loader.timeout or None
        # at most num_workers * prefetch_factor index batches in flight
        limit = max(n * loader.prefetch_factor, n)
        try:
            batches = list(enumerate(loader.batch_sampler))
            sent = 0
            received = 0
            done_sent = False

            def dispatch():
                nonlocal sent, done_sent
                while sent < len(batches) and sent - received < limit:
                    bidx, idx_batch = batches[sent]
                    self._index_qs[bidx % n].put((bidx, list(idx_batch)))
                    sent += 1
                if sent == len(batches) and not done_sent:
                    for q in self._index_qs:
                        q.put(None)
                    done_sent = True

            pending = {}
            want = 0
            dispatch()
            while want < len(batches):
                if want in pending:
                    payload = pending.pop(want)
                else:
                    bidx, payload, err = self._recv(user_timeout)
                    received += 1
                    dispatch()
                    if err is not None:
                        raise RuntimeError(
                            "DataLoader worker failed: %s" % err)
                    payload = _shm_unpack(payload)
                    if self._numpy_mode:
                        payload = _tree_to_tensor(payload)
                    if bidx != want:
                        pending[bidx] = payload
                        continue
                yield payload
                want += 1
        finally:
            self._shutdown()

    def _shutdown(self):
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=5)
        # unlink the shared memory of results never delivered
        while True:
            try:
                _, payload, _ = self._result_q.get_nowait()
            except (queue.Empty, OSError, ValueError):
                break
            if payload is not None:
                _shm_unpack(payload)


__all__ = ["BatchSampler", "ChainDataset", "ComposeDataset", "DataLoader",
           "Dataset", "DistributedBatchSampler", "IterableDataset",
           "RandomSampler", "Sampler", "SequenceSampler", "Subset",
           "TensorDataset", "WeightedRandomSampler", "WorkerInfo",
           "default_collate_fn", "get_worker_info", "random_split"]
