"""Datasets on the host and a prefetching batch loader (counterpart of
:mod:`shapegan_tpu.data.datasets`): a list of ``.npy`` SDF volumes, clamped
and optionally rescaled as they are read; an in-memory array; per-shape
point samples (:class:`PointDataset`); and :class:`BatchLoader`, which
collates shuffled batches in worker threads ahead of the training loop.

The loader has the thread backend only. The JAX package's process pool
(spawn) pickles the dataset, which fails for datasets defined in a local
scope; threads need no pickling, and ``np.load`` releases the GIL."""

from __future__ import annotations

import collections
import concurrent.futures
import glob as globlib
import os
from typing import Optional, Sequence

import numpy as np


class VoxelDataset:
    def __init__(self, files: Sequence[str], clamp: Optional[float] = 0.1, rescale_sdf: bool = True):
        self.files = list(files)
        self.clamp = clamp
        self.rescale_sdf = rescale_sdf

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, index: int) -> np.ndarray:
        array = np.load(self.files[index]).astype(np.float32)
        if self.clamp is not None:
            array = np.clip(array, -self.clamp, self.clamp)
            if self.rescale_sdf:
                array = array / self.clamp
        return array

    @staticmethod
    def glob(pattern: str, clamp: float = 0.1, rescale_sdf: bool = True) -> "VoxelDataset":
        files = sorted(globlib.glob(pattern, recursive=True))
        if not files:
            raise FileNotFoundError(f"No files found for glob pattern {pattern}.")
        return VoxelDataset(files, clamp=clamp, rescale_sdf=rescale_sdf)

    @staticmethod
    def from_split(pattern: str, split_file_name: str, clamp: float = 0.1,
                   rescale_sdf: bool = True) -> "VoxelDataset":
        with open(split_file_name) as f:
            ids = [line.strip() for line in f if line.strip()]
        files = [pattern.format(i) for i in ids]
        files = [f for f in files if os.path.exists(f)]
        return VoxelDataset(files, clamp=clamp, rescale_sdf=rescale_sdf)


class ArrayDataset:
    """Map-style dataset over an in-memory array (synthetic data, tests)."""

    def __init__(self, array: np.ndarray):
        self.array = array

    def __len__(self) -> int:
        return len(self.array)

    def __getitem__(self, index: int) -> np.ndarray:
        return self.array[index]


class PointDataset:
    """Per-shape uniform and near-surface SDF point samples ([P, 4]: xyz +
    sdf) in ``root/uniform/<name>.npy`` and ``root/surface/<name>.npy``,
    subsampled to ``num_points`` per item. With a ``seed`` item ``idx``
    draws from ``default_rng((seed, epoch, idx))`` (the epoch set by
    :meth:`set_epoch`, which :class:`BatchLoader` forwards), so a resumed run
    sees the samples of an uninterrupted one; without one each draw is
    fresh. Both files share one index draw when they hold the same count."""

    def __init__(self, root: str, filenames: Sequence[str], num_points: int = 1024,
                 seed: Optional[int] = None):
        if not 0 < num_points <= 64**3:
            raise ValueError(f"num_points must be in (0, 64^3], got {num_points}")
        self.root = os.path.expanduser(os.path.normpath(root))
        self.filenames = list(filenames)
        self.num_points = num_points
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.filenames)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __getitem__(self, idx: int):
        name = self.filenames[idx]
        uniform = np.load(os.path.join(self.root, "uniform", f"{name}.npy")).astype(np.float32)
        surface = np.load(os.path.join(self.root, "surface", f"{name}.npy")).astype(np.float32)
        rng = (np.random.default_rng() if self.seed is None
               else np.random.default_rng((self.seed, self.epoch, idx)))
        sample = rng.choice(uniform.shape[0], self.num_points)
        if surface.shape[0] == uniform.shape[0]:
            return uniform[sample], surface[sample]
        return uniform[sample], surface[rng.choice(surface.shape[0], self.num_points)]

    @staticmethod
    def from_split(root: str, split: str, num_points: int = 1024,
                   seed: Optional[int] = None) -> "PointDataset":
        with open(os.path.join(root, f"{split}.txt")) as f:
            filenames = [line for line in f.read().split("\n") if line]
        return PointDataset(root, filenames, num_points, seed=seed)


class BatchLoader:
    """Shuffled batches of a map-style dataset, collated (``np.stack``, per
    part for tuple items) in ``num_workers`` threads, at most ``num_workers +
    prefetch`` batches ahead of the consumer. The order equals the JAX
    package's ``BatchLoader``: with a ``seed``, :meth:`set_epoch` reseeds the
    shuffle from ``(seed, epoch)`` and forwards the epoch to the dataset; an
    iteration without a preceding ``set_epoch`` advances the epoch by one
    itself, so an epoch-keyed dataset never serves the same subsample twice.
    ``drop_remainder`` drops the last short batch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, drop_remainder: bool = False,
                 num_workers: int = 4, prefetch: int = 4, seed: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self._epoch = None
        self._epoch_pinned = False
        self._rng = np.random.default_rng(seed)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)
        self._epoch_pinned = True
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        if self.seed is not None:
            self._rng = np.random.default_rng((self.seed, epoch))

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            chunk = order[start:start + self.batch_size]
            if self.drop_remainder and len(chunk) < self.batch_size:
                return
            yield chunk

    def _collate(self, indices):
        items = [self.dataset[int(i)] for i in indices]
        if isinstance(items[0], tuple):
            return tuple(np.stack(parts) for parts in zip(*items))
        return np.stack(items)

    def __iter__(self):
        if self._epoch_pinned:
            self._epoch_pinned = False
        else:
            self.set_epoch(0 if self._epoch is None else self._epoch + 1)
            self._epoch_pinned = False
        pool = concurrent.futures.ThreadPoolExecutor(self.num_workers)
        pending = collections.deque()
        try:
            for indices in self._batch_indices():
                pending.append(pool.submit(self._collate, indices))
                if len(pending) > self.num_workers + self.prefetch:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            # An early break or an exception drops the queued work.
            pool.shutdown(wait=False, cancel_futures=True)
