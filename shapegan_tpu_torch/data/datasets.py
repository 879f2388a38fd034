"""Datasets on the host and a prefetching batch loader (counterpart of
:mod:`shapegan_tpu.data.datasets`): a list of ``.npy`` SDF volumes, clamped
and optionally rescaled as they are read; an in-memory array; per-shape
point samples (:class:`PointDataset`); :class:`BatchLoader`, which collates
shuffled batches in worker threads or processes ahead of the training loop;
and :func:`prefetch_to_device`, which keeps the next batches' host→device
copies queued while a step runs.
"""

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


def _process_worker_init(dataset) -> None:
    """Runs once in each loader worker process: keeps the dataset, so a
    task ships only its indices."""
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _process_worker_collate(indices, epoch=None):
    # The worker's dataset is a copy made when the pool started: the
    # parent's set_epoch never reaches it, so the epoch comes with each task.
    if epoch is not None and hasattr(_WORKER_DATASET, "set_epoch"):
        _WORKER_DATASET.set_epoch(epoch)
    return _collate(_WORKER_DATASET, indices)


def _collate(dataset, indices):
    items = [dataset[int(i)] for i in indices]
    if isinstance(items[0], tuple):
        return tuple(np.stack(parts) for parts in zip(*items))
    return np.stack(items)


class BatchLoader:
    """Shuffled batches of a map-style dataset, collated (``np.stack``, per
    part for tuple items) by ``num_workers`` workers, at most ``num_workers +
    prefetch`` batches ahead of the consumer. The order equals the JAX
    package's ``BatchLoader``: with a ``seed``, :meth:`set_epoch` reseeds the
    shuffle from ``(seed, epoch)`` and forwards the epoch to the dataset; an
    iteration without a preceding ``set_epoch`` advances the epoch by one
    itself, so an epoch-keyed dataset never serves the same subsample twice.
    ``drop_remainder`` drops the last short batch.

    ``backend``: ``"thread"`` (the default: no pickling; ``np.load``
    releases the GIL), ``"process"`` (a persistent pool of ``spawn``
    workers, each given the dataset once, which must pickle; the epoch
    travels with each task), or ``"auto"``, the JAX package's rule:
    processes for a dataset that is not an :class:`ArrayDataset` when there
    are several workers and at least four cores, threads otherwise.
    :meth:`close` ends the pool (as does garbage collection)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, drop_remainder: bool = False,
                 num_workers: int = 4, prefetch: int = 4, seed: Optional[int] = None,
                 backend: str = "thread"):
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
        self._pool = None
        if backend == "auto":
            in_memory = isinstance(dataset, ArrayDataset)
            multicore = (os.cpu_count() or 1) >= 4
            several = self.num_workers > 1
            backend = "process" if (several and multicore and not in_memory) else "thread"
        if backend not in ("thread", "process"):
            raise ValueError(f"unknown loader backend {backend!r}")
        self.backend = backend

    def _process_pool(self):
        """The persistent worker pool, started at first use. ``spawn``, not
        ``fork``: the training process has torch's threads (and CUDA) live,
        and forking those is unsafe."""
        if self._pool is None:
            import multiprocessing

            context = multiprocessing.get_context("spawn")
            self._pool = context.Pool(self.num_workers, initializer=_process_worker_init,
                                      initargs=(self.dataset,))
        return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        self.close()

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

    def __iter__(self):
        if self._epoch_pinned:
            self._epoch_pinned = False
        else:
            self.set_epoch(0 if self._epoch is None else self._epoch + 1)
            self._epoch_pinned = False
        window = self.num_workers + self.prefetch
        if self.backend == "process":
            # An early break leaves at most `window` submitted batches to
            # finish in the pool; they are dropped.
            pool = self._process_pool()
            epoch = self._epoch
            for handle in prefetch_to_device(
                    self._batch_indices(),
                    lambda idx: pool.apply_async(_process_worker_collate, (idx, epoch)),
                    buffer_size=window):
                yield handle.get()
            return
        pool = concurrent.futures.ThreadPoolExecutor(self.num_workers)
        try:
            for future in prefetch_to_device(
                    self._batch_indices(), lambda idx: pool.submit(_collate, self.dataset, idx),
                    buffer_size=window):
                yield future.result()
        finally:
            # An early break or an exception drops the queued work.
            pool.shutdown(wait=False, cancel_futures=True)


def prefetch_to_device(iterator, put, buffer_size: int = 2):
    """Map ``put`` over ``iterator`` ``buffer_size`` items ahead of the
    consumer, in order: with ``put`` an asynchronous host→device copy, the
    next batches' copies are queued while the current step runs (with a
    submit to a pool, the loader's bounded window)."""
    buffer = collections.deque()
    it = iter(iterator)
    for _ in range(buffer_size):
        try:
            buffer.append(put(next(it)))
        except StopIteration:
            break
    while buffer:
        item = buffer.popleft()
        try:
            buffer.append(put(next(it)))
        except StopIteration:
            pass
        yield item
