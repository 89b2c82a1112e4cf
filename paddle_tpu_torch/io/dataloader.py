"""Data loading (counterpart of ``paddle_tpu/io/dataloader.py``).

Datasets, samplers, ``random_split``, ``default_collate_fn``,
``WorkerInfo`` / ``get_worker_info`` and ``DataLoader`` with the JAX
package's semantics:

- the samplers draw from numpy's global generator exactly as the JAX
  package's do, so one ``np.random.seed`` gives both packages the same
  index orders;
- ``num_workers=0`` runs the dataset and the collate on a prefetch
  thread (``use_buffer_reader``, two batches ahead) or inline;
- ``num_workers > 0`` starts worker processes that collate numpy
  batches and push them, pickled, through the native shared-memory
  ring (``core/native``, 64 MiB: a larger batch raises ``ValueError``
  in the worker, reported by the parent as that worker's error); the
  parent reorders them by sequence number. Workers start with ``fork``
  unless CUDA is initialized in the parent, then with ``spawn``
  (``PADDLE_TPU_WORKER_START`` overrides), and never touch the card.
  Without the native tier the loader falls back to the thread prefetch,
  as the JAX package does;
- batches become port ``Tensor``s in the parent, on the current device
  (bfloat16 samples, ``core.dtypes.BFLOAT16_NP``, become bfloat16
  tensors bit for bit).
"""
from __future__ import annotations

import itertools
import os
import queue
import threading

import numpy as np
import torch

from ..core import dtypes as _dt
from ..core.tensor import to_numpy, to_tensor

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "Subset", "random_split", "Sampler",
           "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
           "BatchSampler", "DistributedBatchSampler", "default_collate_fn",
           "WorkerInfo", "get_worker_info", "DataLoader"]


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
            out.extend(item if isinstance(item, (list, tuple)) else [item])
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


def random_split(dataset, lengths, generator=None):
    total = len(dataset)
    if sum(lengths) != total:
        raise ValueError("sum of lengths != dataset size")
    perm = np.random.permutation(total)
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n].tolist()))
        off += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None, generator=None):
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
        return iter(np.random.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(
            len(self.weights), self.num_samples, replace=self.replacement, p=p
        )
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
    """Rank-sharded sampler (reference:
    ``python/paddle/io/dataloader/batch_sampler.py DistributedBatchSampler``);
    the rank and world size default to ``torch.distributed``'s (0 and 1
    outside a process group)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        dist = torch.distributed
        live = dist.is_available() and dist.is_initialized()
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = (num_replicas if num_replicas is not None
                       else dist.get_world_size() if live else 1)
        self.local_rank = (rank if rank is not None
                           else dist.get_rank() if live else 0)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
            self.epoch += 1
        indices = np.concatenate([indices, indices[: self.total_size - n]])
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices.tolist():
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


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as numpy, bfloat16 as ``BFLOAT16_NP`` bits."""
    if t.dtype == torch.bfloat16:
        return to_numpy(t.view(torch.int16)).view(_dt.BFLOAT16_NP)
    return to_numpy(t)


def default_collate_fn(batch):
    """Stack a list of samples into a batch of ``Tensor``s on the current
    device: tensors, arrays and numbers stacked on a new leading axis;
    tuples, lists and dicts collated field by field."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return to_tensor(torch.stack([s.detach() for s in batch]))
    if isinstance(sample, np.ndarray):
        return to_tensor(np.stack(batch))
    if isinstance(sample, (int, float, np.generic)):  # incl. numpy scalars
        return to_tensor(np.asarray(batch))
    if isinstance(sample, (list, tuple)):
        transposed = list(zip(*batch))
        return [default_collate_fn(list(group)) for group in transposed]
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    return batch


def _np_collate(batch):
    """The default collate into numpy: what worker processes run, so
    they touch no device."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return np.stack([_host(s) for s in batch])
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, float, np.generic)):  # incl. numpy scalars
        return np.asarray(batch)
    if isinstance(sample, (list, tuple)):
        return [_np_collate(list(g)) for g in zip(*batch)]
    if isinstance(sample, dict):
        return {k: _np_collate([d[k] for d in batch]) for k in sample}
    return batch


def _tensor_tree(obj):
    if isinstance(obj, np.ndarray):
        return to_tensor(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tensor_tree(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _tensor_tree(v) for k, v in obj.items()}
    return obj


class WorkerInfo:
    """Reference ``dataloader/worker.py WorkerInfo`` — id/num_workers/
    dataset of the calling worker process, or None in the main process."""

    def __init__(self, id, num_workers, dataset):  # noqa: A002
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = None


def get_worker_info():
    return _worker_info


def _mp_worker_loop(ring_name, dataset, collate_fn, assignments,
                    worker_init_fn, wid, num_workers=0):
    """Worker-process body (module-level, so ``spawn`` can pickle it).

    Reference: ``python/paddle/fluid/dataloader/worker.py _worker_loop`` —
    collate each assigned index batch and push it to the shared-memory
    ring. The worker hides the card from itself: with the default
    collate it runs numpy only.
    """
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    from ..core import native

    q = native.ShmRingQueue.open_(ring_name)
    global _worker_info
    _worker_info = WorkerInfo(wid, num_workers, dataset)
    try:
        if worker_init_fn is not None:
            worker_init_fn(wid)
        for seq, idxs in assignments:
            batch = collate_fn([dataset[i] for i in idxs])
            q.push_obj((seq, batch))
        q.push_obj(("__done__", wid))
    except Exception as e:  # noqa: BLE001 — reported to the parent
        q.push_obj(("__error__", f"worker {wid}: {type(e).__name__}: {e}"),
                   timeout=5.0)


def _default_start_method() -> str:
    """``fork`` is cheap and keeps closures working, but a forked child
    cannot use a CUDA context its parent initialized: ``spawn`` once
    CUDA is initialized. ``PADDLE_TPU_WORKER_START`` overrides."""
    env = os.environ.get("PADDLE_TPU_WORKER_START")
    if env:
        return env
    return "spawn" if torch.cuda.is_initialized() else "fork"


class _MultiprocessIterator:
    """Worker processes feeding the native shared-memory ring
    (reference ``dataloader_iter.py _DataLoaderIterMultiProcess`` over
    ``memory_map`` queues); batches are reordered by sequence number, so
    they come in the sampler's order."""

    def __init__(self, dataset, collate_fn, idx_batches, num_workers,
                 ring_bytes=64 << 20, timeout=0.0, worker_init_fn=None,
                 start_method=None, convert_output=True):
        import multiprocessing as mp

        from ..core import native

        self._ring = native.ShmRingQueue.create(ring_bytes=ring_bytes)
        self._total = len(idx_batches)
        self._timeout = timeout  # 0 = block forever (paddle semantics)
        self._convert = convert_output
        self._next = 0
        self._buf = {}
        self._yielded = 0
        self._done_workers = 0
        self._num_workers = num_workers
        ctx = mp.get_context(start_method or _default_start_method())
        seq_batches = list(enumerate(idx_batches))
        self._procs = []
        for w in range(num_workers):
            p = ctx.Process(
                target=_mp_worker_loop,
                args=(self._ring.name, dataset, collate_fn,
                      seq_batches[w::num_workers], worker_init_fn, w,
                      num_workers),
                daemon=True,
            )
            p.start()
            self._procs.append(p)

    def __iter__(self):
        return self

    def _pop(self):
        """Pop with liveness checks: timeout=0 blocks forever but still
        detects a worker that died without reporting (kill -9)."""
        import time

        from ..core.native.queues import Closed, Timeout

        deadline = (time.time() + self._timeout) if self._timeout > 0 else None
        while True:
            try:
                return self._ring.pop_obj(timeout=1.0)
            except Closed as e:
                self.close()
                raise RuntimeError(
                    f"dataloader queue closed unexpectedly: {e!r}"
                ) from e
            except Timeout:
                for p in self._procs:
                    if p.exitcode not in (None, 0):
                        self.close()
                        raise RuntimeError(
                            f"dataloader worker died with exit code "
                            f"{p.exitcode}"
                        ) from None
                if deadline is not None and time.time() > deadline:
                    self.close()
                    raise RuntimeError(
                        f"dataloader timed out after {self._timeout}s "
                        f"waiting for batch {self._next}"
                    ) from None

    def __next__(self):
        while True:
            if self._next in self._buf:
                out = self._buf.pop(self._next)
                self._next += 1
                self._yielded += 1
                return _tensor_tree(out) if self._convert else out
            if self._yielded >= self._total:
                self.close()
                raise StopIteration
            if (self._done_workers >= self._num_workers
                    and self._next not in self._buf):
                # workers finished but a batch never arrived
                self.close()
                raise RuntimeError(
                    f"dataloader workers exited with batch {self._next} "
                    f"missing ({self._yielded}/{self._total} delivered)"
                )
            msg = self._pop()
            tag = msg[0]
            if tag == "__done__":
                self._done_workers += 1
            elif tag == "__error__":
                self.close()
                raise RuntimeError(msg[1])
            else:
                self._buf[msg[0]] = msg[1]

    def close(self):
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=5)
        self._procs = []
        self._ring.destroy()

    def __del__(self):
        try:
            self.close()
        except (AttributeError, TypeError):  # half-built, or at teardown
            pass


class _PrefetchIterator:
    """Background-thread pipeline with a bounded queue (double buffering).

    Abandoning iteration (``break`` mid-epoch, GC of the iterator) must not
    leak the worker: the worker's puts poll a stop flag so ``close`` always
    unblocks it.
    """

    _SENTINEL = object()

    def __init__(self, gen_fn, depth=2):
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._gen_fn = gen_fn
        self._err = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for item in self._gen_fn():
                if not self._put(item):
                    return
        except BaseException as e:  # propagate to consumer
            self._err = e
        finally:
            self._put(self._SENTINEL)

    def close(self):
        self._stop.set()
        # drain so a blocked put exits promptly
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass

    def __del__(self):
        try:
            self.close()
        except (AttributeError, TypeError):  # half-built, or at teardown
            pass

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False,
                 drop_last=False, collate_fn=None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self._user_collate = collate_fn
        self.num_workers = num_workers
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.prefetch = use_buffer_reader
        self.prefetch_factor = max(prefetch_factor, 2)
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size, drop_last=drop_last
            )

    def _gen(self):
        if self._iterable_mode:
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                yield self.collate_fn(batch)
        else:
            for idx_batch in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in idx_batch])

    def __iter__(self):
        if self.num_workers > 0 and not self._iterable_mode:
            from ..core import native

            if native.available():
                # default path: numpy-only collate in workers, parent
                # converts to Tensors (matches default_collate_fn types).
                # User collate: run it in the worker and yield its output
                # untouched so types match the num_workers=0 path.
                collate = self._user_collate or _np_collate
                return _MultiprocessIterator(
                    self.dataset, collate, list(self.batch_sampler),
                    self.num_workers,
                    timeout=self.timeout or 0.0,
                    worker_init_fn=self.worker_init_fn,
                    convert_output=self._user_collate is None,
                )
            # native tier unavailable: thread prefetch still overlaps IO
        if self.prefetch:
            return _PrefetchIterator(self._gen, depth=self.prefetch_factor)
        return self._gen()

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)
