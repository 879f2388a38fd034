"""Shared training pieces of the ported trainers (counterpart of
:mod:`shapegan_tpu.train.common`).

The reference's observability conventions: space-separated CSV logs in
``plots/`` (append on ``continue``, flushed per epoch; the same format, so
``create_plot.py`` reads both packages), rolling 50-step histories, epoch
timers and host-clock step times. The voxel dataset lives on the device
whole and each batch is gathered there, in the JAX package's shuffle order.
Streaming batches from the host (for datasets larger than the card's
memory) is not ported.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from shapegan_tpu_torch.util import create_text_slice, ensure_directory


class CSVLogger:
    """Space-separated CSV in the reference's format; the line count doubles
    as resume state."""

    def __init__(self, path: str, resume: bool = False):
        ensure_directory(os.path.dirname(path) or ".")
        self.path = path
        self.first_epoch = 0
        if resume and os.path.exists(path):
            with open(path) as f:
                self.first_epoch = sum(1 for _ in f)
        self._file = open(path, "a" if resume else "w")

    def write(self, *values) -> None:
        self._file.write(" ".join(f"{v:.6f}" if isinstance(v, float) else str(v)
                                  for v in values) + "\n")
        self._file.flush()

    def close(self) -> None:
        self._file.close()


def effective_batch_size(requested: int, dataset_len: int) -> int:
    """The batch size clamped to the dataset size: batches drop the
    remainder, so a dataset smaller than one batch trains on one
    full-dataset batch instead of none."""
    if dataset_len <= 0:
        raise ValueError("dataset is empty — nothing to train on")
    if dataset_len < requested:
        print(f"Dataset has only {dataset_len} samples; clamping batch size "
              f"{requested} -> {dataset_len}.")
        return dataset_len
    return requested


class RollingHistory:
    """Rolling mean over the last N steps (the reference's deque(maxlen=50))."""

    def __init__(self, maxlen: int = 50):
        self._values = collections.deque(maxlen=maxlen)

    def append(self, value) -> None:
        self._values.append(float(value))

    @property
    def mean(self) -> float:
        return float(np.mean(self._values)) if self._values else float("nan")

    def __len__(self):
        return len(self._values)


class EpochTimer:
    def __enter__(self):
        self.start = time.time()
        return self

    def __exit__(self, *exc):
        self.duration = time.time() - self.start
        return False


class StepProfiler:
    """Host-clock time of each step, taken after synchronizing the device,
    so it covers the device work the step queued."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.times = collections.deque(maxlen=200)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.times.append(time.perf_counter() - self._t0)
        return False

    @property
    def mean_step_time(self) -> float:
        """Mean over recent steps, without first-call outliers (samples more
        than 20x the median: kernel builds, cuDNN algorithm searches)."""
        if not self.times:
            return float("nan")
        times = np.asarray(self.times)
        return float(times[times <= 20 * np.median(times)].mean())


def maybe_print_slice(volume: torch.Tensor, enabled: bool, scale: float = 1.0) -> None:
    """The reference's headless visual check (``show_slice``)."""
    if enabled:
        print(create_text_slice(volume.detach().float().cpu().numpy() / scale))


def resolve_voxel_dataset(config, resolution: int = 32, rescale_sdf: bool = True,
                          clamp: float = 0.1):
    """Voxel dataset: synthetic (if requested), else the split file, else
    the glob — the JAX package's order."""
    from shapegan_tpu_torch.data.datasets import ArrayDataset, VoxelDataset
    from shapegan_tpu_torch.data.synthetic import make_voxel_dataset

    if config.synthetic:
        return ArrayDataset(make_voxel_dataset(config.synthetic, resolution, clamp=clamp,
                                               rescale=rescale_sdf, seed=config.seed))
    split = os.path.join(config.data_dir, config.category, "train.txt")
    pattern_dir = os.path.join(config.data_dir, config.category, f"voxels_{resolution}")
    if os.path.exists(split):
        return VoxelDataset.from_split(os.path.join(pattern_dir, "{:s}.npy"), split, clamp=clamp,
                                       rescale_sdf=rescale_sdf)
    return VoxelDataset.glob(os.path.join(pattern_dir, "**.npy"), clamp=clamp,
                             rescale_sdf=rescale_sdf)


class ResidentBatches:
    """The whole dataset on the device, each batch gathered there from a
    host-drawn index vector. The shuffle order equals the JAX package's
    ``ResidentBatches``/``BatchLoader``: ``default_rng((seed, epoch))`` after
    :meth:`set_epoch`, remainder dropped."""

    def __init__(self, dataset, batch_size: int, seed: Optional[int], device):
        array = getattr(dataset, "array", None)
        if array is None:
            array = np.stack([dataset[i] for i in range(len(dataset))])
        self.data = torch.tensor(np.asarray(array, dtype=np.float32), device=device)
        self.batch_size = batch_size
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    def set_epoch(self, epoch: int) -> None:
        if self.seed is not None:
            self._rng = np.random.default_rng((self.seed, int(epoch)))

    def __len__(self) -> int:
        return len(self.data) // self.batch_size

    def __iter__(self) -> Iterator[torch.Tensor]:
        order = np.arange(len(self.data))
        self._rng.shuffle(order)
        for start in range(0, len(self) * self.batch_size, self.batch_size):
            idx = torch.tensor(order[start:start + self.batch_size], device=self.data.device)
            yield self.data.index_select(0, idx)
