"""Ray-shard datasets: pre-shuffled, pre-batched numpy arrays on disk.

Equivalent of the reference MmapDataset/ArrayDataset (sunerf/data/dataset.py):
batch-per-item over memory-mapped arrays. Batches have a fixed size (a
ragged last batch is dropped), and iteration is a plain numpy generator —
no framework DataLoader, so the batch order is the JAX package's for the
same seed. A copy of sunerf_tpu/data/datasets.py (the port imports nothing
of the JAX package), but for one thing: MmapDataset maps its files once,
where the JAX one maps each file again for every batch (an open, a header
parse and an mmap a file a step, which the host pays inside every training
step); the batches are the same.
"""
from __future__ import annotations

import os
from typing import Iterator

import numpy as np


class MmapDataset:
    """Lazy batches from pre-shuffled on-disk .npy arrays (batch-per-item)."""

    def __init__(self, batch_files: dict, batch_size: int = 8192):
        self.batch_files = dict(batch_files)
        self.batch_size = int(batch_size)
        self._maps = {k: np.load(f, mmap_mode='r') for k, f in self.batch_files.items()}
        self._n_rows = next(iter(self._maps.values())).shape[0]

    def __len__(self) -> int:
        return int(np.ceil(self._n_rows / self.batch_size))

    def __getitem__(self, idx: int) -> dict:
        lo, hi = idx * self.batch_size, (idx + 1) * self.batch_size
        return {k: np.copy(m[lo:hi]) for k, m in self._maps.items()}

    def clear(self):
        self._maps = {}
        for f in self.batch_files.values():
            if os.path.exists(f):
                os.remove(f)


class ArrayDataset:
    """Batch-per-item over in-memory arrays (validation sets)."""

    def __init__(self, arrays: dict, batch_size: int = 8192):
        self.arrays = dict(arrays)
        self.batch_size = int(batch_size)
        self._n_rows = next(iter(self.arrays.values())).shape[0]

    def __len__(self) -> int:
        return int(np.ceil(self._n_rows / self.batch_size))

    def __getitem__(self, idx: int) -> dict:
        lo, hi = idx * self.batch_size, (idx + 1) * self.batch_size
        return {k: np.copy(v[lo:hi]) for k, v in self.arrays.items()}


def iterate_batches(dataset, epochs: int | None = None, shuffle: bool = True,
                    drop_ragged: bool = True,
                    seed: int = 0) -> Iterator[dict]:
    """Endless (or epochs-bounded) batch stream. Ragged final batches are
    dropped by default so jit never recompiles and shard_map shapes stay
    static."""
    epoch = 0
    n = len(dataset)
    full = dataset._n_rows // dataset.batch_size
    limit = full if drop_ragged and full > 0 else n
    if limit == 0:
        raise ValueError(
            f'dataset yields no batches ({dataset._n_rows} rows, batch size '
            f'{dataset.batch_size}) — the iterator would spin forever')
    rng = np.random.default_rng(seed)
    while epochs is None or epoch < epochs:
        order = rng.permutation(limit) if shuffle else np.arange(limit)
        for idx in order:
            yield dataset[int(idx)]
        epoch += 1
