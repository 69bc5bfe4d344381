"""The data loader: a ``torch.utils.data.DataLoader`` in the JAX package's
order (``imgadapointr_tpu/datasets/loader.py:62-150``).

- An epoch visits ``np.random.default_rng(seed + epoch).permutation(n)``
  when shuffled, ``0 .. n-1`` otherwise, in contiguous batches (the last
  one dropped when short, with ``drop_last``). Over ``num_hosts`` data
  ranks the order is padded with its own first entries to a multiple of
  ``num_hosts`` and rank ``host_id`` visits ``order[host_id::num_hosts]``
  (JAX ``loader.py:120-125``), so every rank has the same number of batches.
- Sample ``i`` draws its randomness from
  ``np.random.default_rng((base_seed, i))``, ``base_seed = (seed * 7919 +
  epoch) & 0x7FFFFFFF``.

The sampler yields ``(index, base_seed)`` pairs, so a worker needs no
epoch of its own: a sample is the same with 0 workers or 8, threads or
processes. Two worker modes, as in the JAX loader
(``imgadapointr_tpu/datasets/loader.py:9-24``):

- ``thread``: a ``ThreadPoolExecutor`` of ``num_workers`` threads in this
  process decodes the samples of the next ``PREFETCH`` batches while the
  current one is used (JAX ``datasets/loader.py:148-156``);
- ``process``: ``num_workers`` persistent ``DataLoader`` worker processes,
  which read with the reader (``IO.use_native``) set when the loader was made.

With 0 workers both read in this process. Worker processes
start from a ``forkserver``, as the JAX loader's process pool does:
``fork`` is unsafe in a process that runs threads, and a ``spawn`` worker
ends through the interpreter's whole shutdown, where a worker stopped with
batches still in flight was seen to abort (``terminate called without an
active exception``); a forkserver child leaves by ``os._exit``.
A batch is ``(taxonomy_ids, model_ids, {key: stacked tensor})``.
"""

from __future__ import annotations

import collections
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset, Sampler

from ..utils.io_module import IO

WORKER_MODES = ("thread", "process")
PREFETCH = 2  # batches the thread pool decodes ahead of the one in use


def base_seed(seed: int, epoch: int) -> int:
    """The seed every sample of ``epoch`` combines with its index."""
    return (seed * 7919 + epoch) & 0x7FFFFFFF


class EpochOrderSampler(Sampler):
    """``(index, base_seed)`` pairs of one epoch in the JAX loader's order."""

    def __init__(self, n: int, shuffle: bool, seed: int = 0, num_hosts: int = 1, host_id: int = 0):
        if not 0 <= host_id < num_hosts:
            raise ValueError(f"host_id {host_id} outside [0, {num_hosts})")
        self.n, self.shuffle, self.seed = n, shuffle, seed
        self.num_hosts, self.host_id = num_hosts, host_id
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def order(self) -> np.ndarray:
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(self.n)
        else:
            order = np.arange(self.n)
        if self.num_hosts > 1:
            pad = -(-self.n // self.num_hosts) * self.num_hosts - self.n
            order = np.concatenate([order, order[:pad]])[self.host_id::self.num_hosts]
        return order

    def __iter__(self):
        base = base_seed(self.seed, self.epoch)
        return iter([(int(i), base) for i in self.order()])

    def __len__(self) -> int:
        return -(-self.n // self.num_hosts)


class SeededSamples(Dataset):
    """Map-style view of a reader (``get(idx, rng)``): item ``(i, base)``
    is ``get(i, np.random.default_rng((base, i)))``."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, key):
        i, base = key
        return self.dataset.get(i, np.random.default_rng((base, i)))


def _set_reader(use_native: bool, _worker_id: int) -> None:
    """A worker process reads with the reader its loader was made under
    (``IO.use_native`` is a class attribute, which a new process does not
    inherit)."""
    IO.use_native = use_native


def collate(samples) -> tuple:
    """``(taxonomy_ids, model_ids, {key: stacked tensor})`` of a batch."""
    keys = samples[0][2].keys()
    return ([s[0] for s in samples], [s[1] for s in samples],
            {k: torch.from_numpy(np.stack([s[2][k] for s in samples])) for k in keys})


class Loader(DataLoader):
    """The batches of a reader in the JAX loader's order; ``set_epoch``
    picks the epoch's order and seeds. ``worker_mode`` is ``thread`` or
    ``process`` (see the module docstring); ``num_hosts`` and ``host_id``
    shard the epoch over data ranks."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, drop_last: bool, seed: int = 0,
                 num_workers: int = 0, worker_mode: str = "thread", num_hosts: int = 1, host_id: int = 0):
        if worker_mode not in WORKER_MODES:
            raise ValueError(f"worker_mode must be thread|process, got {worker_mode!r}")
        processes = num_workers if worker_mode == "process" else 0
        super().__init__(SeededSamples(dataset), batch_size=batch_size,
                         sampler=EpochOrderSampler(len(dataset), shuffle, seed, num_hosts, host_id),
                         drop_last=drop_last, collate_fn=collate, num_workers=processes,
                         persistent_workers=processes > 0,
                         multiprocessing_context="forkserver" if processes > 0 else None,
                         worker_init_fn=functools.partial(_set_reader, IO.use_native) if processes > 0 else None)
        self.worker_mode = worker_mode
        self.threads = num_workers if worker_mode == "thread" else 0
        self._pool = None  # the threads, made at the first epoch

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def __iter__(self):
        if self.threads:
            return self._thread_batches()
        return super().__iter__()

    def _thread_batches(self):
        """The epoch's batches, decoded by the thread pool ``PREFETCH``
        batches ahead; a sample's exception is raised here, as the worker
        processes' are."""
        keys = list(self.sampler)
        bs = self.batch_size
        n = len(keys) // bs if self.drop_last else -(-len(keys) // bs)
        batches = iter([keys[i * bs:(i + 1) * bs] for i in range(n)])
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.threads, thread_name_prefix="loader")
        pending = collections.deque()

        def submit() -> None:
            batch = next(batches, None)
            if batch is not None:
                pending.append([self._pool.submit(self.dataset.__getitem__, k) for k in batch])

        for _ in range(PREFETCH + 1):
            submit()
        try:
            while pending:
                futures = pending.popleft()
                submit()
                yield self.collate_fn([f.result() for f in futures])
        finally:  # an epoch left early: drop what was queued for it
            for futures in pending:
                for f in futures:
                    f.cancel()

    def close(self) -> None:
        """Stop the workers: the thread pool, or the persistent worker
        processes (none with 0 workers). ``DataLoader`` offers no public
        call for the processes, so this uses its iterator's
        ``_shutdown_workers`` and raises if a torch release has renamed
        either, rather than leave the workers running."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
        if not hasattr(self, "_iterator"):
            raise RuntimeError("DataLoader has no _iterator: cannot stop its workers")
        it, self._iterator = self._iterator, None
        if it is None:
            return
        if not hasattr(it, "_shutdown_workers"):
            raise RuntimeError(f"{type(it).__name__} has no _shutdown_workers: cannot stop its workers")
        it._shutdown_workers()
