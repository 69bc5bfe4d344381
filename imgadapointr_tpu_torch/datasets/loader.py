"""The data loader: a ``torch.utils.data.DataLoader`` in the JAX package's
order (``imgadapointr_tpu/datasets/loader.py:114-150``, one host).

- An epoch visits ``np.random.default_rng(seed + epoch).permutation(n)``
  when shuffled, ``0 .. n-1`` otherwise, in contiguous batches (the last
  one dropped when short, with ``drop_last``).
- Sample ``i`` draws its randomness from
  ``np.random.default_rng((base_seed, i))``, ``base_seed = (seed * 7919 +
  epoch) & 0x7FFFFFFF``.

The sampler yields ``(index, base_seed)`` pairs, so a worker process needs
no epoch of its own: a sample is the same with 0 workers or 8. Workers
start from a ``forkserver``, as the JAX loader's process pool does:
``fork`` is unsafe in a process that runs threads, and a ``spawn`` worker
ends through the interpreter's whole shutdown, where a worker stopped with
batches still in flight was seen to abort (``terminate called without an
active exception``); a forkserver child leaves by ``os._exit``.
A batch is ``(taxonomy_ids, model_ids, {key: stacked tensor})``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset, Sampler


def base_seed(seed: int, epoch: int) -> int:
    """The seed every sample of ``epoch`` combines with its index."""
    return (seed * 7919 + epoch) & 0x7FFFFFFF


class EpochOrderSampler(Sampler):
    """``(index, base_seed)`` pairs of one epoch in the JAX loader's order."""

    def __init__(self, n: int, shuffle: bool, seed: int = 0):
        self.n, self.shuffle, self.seed = n, shuffle, seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def order(self) -> np.ndarray:
        if self.shuffle:
            return np.random.default_rng(self.seed + self.epoch).permutation(self.n)
        return np.arange(self.n)

    def __iter__(self):
        base = base_seed(self.seed, self.epoch)
        return iter([(int(i), base) for i in self.order()])

    def __len__(self) -> int:
        return self.n


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


def collate(samples) -> tuple:
    """``(taxonomy_ids, model_ids, {key: stacked tensor})`` of a batch."""
    keys = samples[0][2].keys()
    return ([s[0] for s in samples], [s[1] for s in samples],
            {k: torch.from_numpy(np.stack([s[2][k] for s in samples])) for k in keys})


class Loader(DataLoader):
    """The batches of a reader in the JAX loader's order; ``set_epoch``
    picks the epoch's order and seeds."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, drop_last: bool, seed: int = 0,
                 num_workers: int = 0):
        super().__init__(SeededSamples(dataset), batch_size=batch_size,
                         sampler=EpochOrderSampler(len(dataset), shuffle, seed),
                         drop_last=drop_last, collate_fn=collate, num_workers=num_workers,
                         persistent_workers=num_workers > 0,
                         multiprocessing_context="forkserver" if num_workers > 0 else None)

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def close(self) -> None:
        """Stop the persistent worker processes (none with 0 workers).
        ``DataLoader`` offers no public call for it, so this uses its
        iterator's ``_shutdown_workers`` and raises if a torch release
        has renamed either, rather than leave the workers running."""
        if not hasattr(self, "_iterator"):
            raise RuntimeError("DataLoader has no _iterator: cannot stop its workers")
        it, self._iterator = self._iterator, None
        if it is None:
            return
        if not hasattr(it, "_shutdown_workers"):
            raise RuntimeError(f"{type(it).__name__} has no _shutdown_workers: cannot stop its workers")
        it._shutdown_workers()
