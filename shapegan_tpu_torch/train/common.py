"""Shared training pieces of the ported trainers (counterpart of
:mod:`shapegan_tpu.train.common`).

The reference's observability conventions: space-separated CSV logs in
``plots/`` (append on ``continue``, flushed per epoch; the same format, so
``create_plot.py`` reads both packages), rolling 50-step histories, epoch
timers and host-clock step times. The voxel trainers take their batches
from :func:`make_voxel_batches`: the whole dataset on the device, each
batch gathered there, when it fits :data:`RESIDENT_MAX_BYTES`; otherwise
streamed from the host through pinned buffers. Both give the JAX package's
shuffle order. Under a mesh of ranks (:mod:`shapegan_tpu_torch.parallel.mesh`)
every rank draws the same global order and takes its rows of each batch;
the CSV logs and checkpoints are written by rank 0 alone, and only rank 0
opens the live viewer (:func:`make_viewer`).
"""

from __future__ import annotations

import collections
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from shapegan_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, is_writer
from shapegan_tpu_torch.util import create_text_slice, ensure_directory


class CSVLogger:
    """Space-separated CSV in the reference's format; the line count doubles
    as resume state. Every rank reads it; rank 0 alone writes it."""

    def __init__(self, path: str, resume: bool = False):
        self.path = path
        self.first_epoch = 0
        if resume and os.path.exists(path):
            with open(path) as f:
                self.first_epoch = sum(1 for _ in f)
        self._file = None
        if is_writer():
            ensure_directory(os.path.dirname(path) or ".")
            self._file = open(path, "a" if resume else "w")

    def write(self, *values) -> None:
        if self._file is None:
            return
        self._file.write(" ".join(f"{v:.6f}" if isinstance(v, float) else str(v)
                                  for v in values) + "\n")
        self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()


def average_over_data(mesh: Optional[Mesh], tensors: dict) -> dict:
    """Gradients (or metrics) averaged over the mesh's data group: each rank
    differentiates the mean over its rows, so the mean of the ranks' values
    is the global batch's. Without a mesh, or with one data shard, the
    tensors as they are."""
    return tensors if mesh is None else mesh.mean_over_data(tensors)


def idle_result(mesh: Mesh) -> dict:
    """What a trainer returns on a rank outside its mesh (a batch that
    divides over fewer ranks than were started): it trains nothing."""
    print(f"rank {mesh.rank} is outside the {mesh}: idle", flush=True)
    return {"idle": True}


def make_viewer(nogui: bool):
    """The live viewer of a training run (the JAX package's rule): None
    under ``nogui``, else a :class:`~shapegan_tpu_torch.render.viewer.MeshRenderer`
    with its window's render thread, or None with a printed reason where
    one cannot be made; it never raises, so a host without GL trains
    headless (where only the window is missing, the render thread prints
    why and the viewer keeps its scene). Under ranks only the writer rank
    gets one."""
    if nogui or not is_writer():
        return None
    try:
        from shapegan_tpu_torch.render.viewer import MeshRenderer

        return MeshRenderer()
    except Exception as e:
        print(f"Viewer unavailable ({type(e).__name__}: {e}); continuing headless.")
        return None


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
    """Rolling mean over the last N steps (the reference's deque(maxlen=50)).
    A tensor is kept on its device as it is appended and read back only
    when :attr:`mean` is read, so appending never waits for the device."""

    def __init__(self, maxlen: int = 50):
        self._values = collections.deque(maxlen=maxlen)

    def append(self, value) -> None:
        self._values.append(value.detach() if torch.is_tensor(value) else float(value))

    @property
    def mean(self) -> float:
        if not self._values:
            return float("nan")
        values = list(self._values)
        tensors = [v.reshape(()) for v in values if torch.is_tensor(v)]
        if tensors:  # one copy to the host for all of them
            host = iter(torch.stack(tensors).double().cpu().tolist())
            values = [next(host) if torch.is_tensor(v) else v for v in values]
        return float(np.mean(values))

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
    """The time of each step. On a CUDA device, a pair of CUDA events around
    the step on the current stream, resolved when :attr:`times` is read
    (the epoch's print), so a step never waits for the device: it covers
    the device's work from the step's first queued operation to its last,
    and the device's idle time between them. On the CPU, the host clock."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._steps = collections.deque(maxlen=200)   # seconds, or a pending event pair

    def _mark(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def __enter__(self):
        self._t0 = self._mark()
        return self

    def __exit__(self, *exc):
        end = self._mark()
        self._steps.append(end - self._t0 if self.device.type != "cuda" else (self._t0, end))
        return False

    @property
    def times(self) -> list:
        """Each recent step's seconds (the last 200)."""
        for i, step in enumerate(self._steps):
            if isinstance(step, tuple):
                step[1].synchronize()
                self._steps[i] = step[0].elapsed_time(step[1]) * 1e-3
        return list(self._steps)

    @property
    def mean_step_time(self) -> float:
        """Mean over recent steps, without first-call outliers (samples more
        than 20x the median: kernel builds, cuDNN algorithm searches)."""
        times = np.asarray(self.times)
        if not times.size:
            return float("nan")
        return float(times[times <= 20 * np.median(times)].mean())


def load_generator(net, name: str, base: str) -> None:
    """Copy a saved SDF-MLP checkpoint into ``net``'s parameters in place."""
    from shapegan_tpu_torch import checkpoints

    restored = checkpoints.load_tree(net.param_dict(), name, base=base)
    with torch.no_grad():
        for key, param in net.param_dict().items():
            param.copy_(restored[key])


def load_critic(module: torch.nn.Module, name: str, base: str) -> None:
    """Copy a saved flax conv critic (``<layer>/kernel|bias``) into
    ``module``'s parameters in place."""
    from shapegan_tpu_torch import checkpoints
    from shapegan_tpu_torch.models import progressive_gan

    params = dict(module.named_parameters())
    restored = checkpoints.load_tree(progressive_gan.params_to_jax(params), name, base=base)
    restored = progressive_gan.params_from_jax(restored, device=next(iter(params.values())).device)
    with torch.no_grad():
        for key, param in params.items():
            param.copy_(restored[key])


def network_payload(module: torch.nn.Module, opt, epoch) -> dict:
    """A network and its optimizer in one file, as the JAX package's voxel
    trainers save them: flax's ``params`` (and ``batch_stats``), the
    optimizer's ``opt_state`` under optax's paths, and ``epoch``."""
    from shapegan_tpu_torch.models import flax_layers
    from shapegan_tpu_torch.optim import optimizer_tree

    return {**flax_layers.variables_to_jax(module),
            "opt_state": optimizer_tree(opt, lambda tensors: flax_layers.to_jax(module, tensors)),
            "epoch": epoch}


def load_network(module: torch.nn.Module, opt, name: str, base: str) -> int:
    """Restore ``module`` and ``opt`` in place from a file of
    :func:`network_payload` (what it lacks keeps its value); returns the
    file's epoch."""
    from shapegan_tpu_torch import checkpoints
    from shapegan_tpu_torch.models import flax_layers
    from shapegan_tpu_torch.optim import load_optimizer_tree

    template = network_payload(module, opt, torch.tensor(0))
    restored = checkpoints.load_tree(template, name, base=base)
    flax_layers.load_variables(module, restored)
    load_optimizer_tree(opt, restored["opt_state"], lambda tree: flax_layers.from_jax(module, tree))
    return int(restored["epoch"])


def load_module(module: torch.nn.Module, name: str, base: str, epoch: Optional[int] = None) -> None:
    """Restore ``module``'s flax variables (``params`` and ``batch_stats``)
    in place from a checkpoint (the snapshot of ``epoch`` if given); the
    bundled example stands in when ``base``'s latest file is missing
    (``checkpoints.load_tree``), and what the file holds besides (an
    optimizer's state, the epoch) is ignored."""
    from shapegan_tpu_torch import checkpoints
    from shapegan_tpu_torch.models import flax_layers

    template = flax_layers.variables_to_jax(module)
    flax_layers.load_variables(module, checkpoints.load_tree(template, name, epoch=epoch, base=base))


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
    :meth:`set_epoch`, remainder dropped. With a ``mesh`` each batch is this
    rank's rows of the global batch (the same order on every rank)."""

    def __init__(self, dataset, batch_size: int, seed: Optional[int], device,
                 mesh: Optional[Mesh] = None):
        array = getattr(dataset, "array", None)
        if array is None:
            array = np.stack([dataset[i] for i in range(len(dataset))])
        self.data = torch.tensor(np.asarray(array, dtype=np.float32), device=device)
        self.batch_size = batch_size
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._rows = _rows_of(mesh, batch_size)

    def set_epoch(self, epoch: int) -> None:
        if self.seed is not None:
            self._rng = np.random.default_rng((self.seed, int(epoch)))

    def __len__(self) -> int:
        return len(self.data) // self.batch_size

    def __iter__(self) -> Iterator[torch.Tensor]:
        order = np.arange(len(self.data))
        self._rng.shuffle(order)
        for start in range(0, len(self) * self.batch_size, self.batch_size):
            idx = torch.tensor(order[start:start + self.batch_size][self._rows],
                               device=self.data.device)
            yield self.data.index_select(0, idx)


# The device-resident dataset cap: the JAX package's value (4 GiB), not
# retuned for the card. extras['resident_max_gb'] moves it.
RESIDENT_MAX_BYTES = 4 << 30


class StreamingBatches:
    """:class:`ResidentBatches`'s surface over a host
    :class:`~shapegan_tpu_torch.data.datasets.BatchLoader`: each batch is
    copied to ``device`` as it is needed, ``prefetch_to_device``'s two
    batches ahead. On the GPU a batch is copied from pinned host memory
    with ``non_blocking=True``, and its pinned buffer is kept until the
    consumer asks for the next batch, after the step that read it was
    queued; without CUDA the copy fails. With a ``mesh`` only this rank's
    rows of each global batch are copied."""

    def __init__(self, loader, device, mesh: Optional[Mesh] = None):
        self.loader = loader
        self.device = torch.device(device)
        self._rows = _rows_of(mesh, loader.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def _put(self, batch: np.ndarray):
        host = torch.from_numpy(np.ascontiguousarray(batch[self._rows], dtype=np.float32))
        if self.device.type != "cuda":
            return host.to(self.device), None
        pinned = host.pin_memory()
        return pinned.to(self.device, non_blocking=True), pinned

    def __iter__(self) -> Iterator[torch.Tensor]:
        from shapegan_tpu_torch.data.datasets import prefetch_to_device

        for batch, pinned in prefetch_to_device(self.loader, self._put):
            yield batch
            del pinned  # the consumer asked for the next batch


def _rows_of(mesh: Optional[Mesh], batch_size: int) -> slice:
    """This rank's rows of a global batch: all of them without a data axis."""
    if mesh is None or mesh.shape[DATA_AXIS] == 1:
        return slice(None)
    return mesh.data_slice(batch_size)


def make_voxel_batches(dataset, batch_size: int, seed: Optional[int],
                       extras: Optional[dict] = None, device="cpu", mesh: Optional[Mesh] = None):
    """The voxel trainers' batch source, by the JAX package's rule: on the
    device (:class:`ResidentBatches`) when the dataset's bytes are at most
    ``extras['resident_max_gb']`` GiB (default :data:`RESIDENT_MAX_BYTES`),
    estimated from the first item and checked again once stacked (ragged
    items); streamed from the host otherwise (:class:`StreamingBatches`
    over a ``BatchLoader`` with the ``auto`` backend: worker processes for
    files). ``extras['resident']`` = ``auto`` (default), ``1`` or ``0``
    forces the choice, though a stacked array above the cap streams even
    with ``1``. Both draw the same shuffle order and drop the remainder;
    under a ``mesh`` a batch is this rank's rows of the global batch."""
    from shapegan_tpu_torch.data.datasets import ArrayDataset, BatchLoader

    extras = extras or {}
    mode = str(extras.get("resident", "auto")).lower()
    max_bytes = int(float(extras.get("resident_max_gb", RESIDENT_MAX_BYTES / 2**30)) * 2**30)
    resident = None
    if mode in ("1", "true", "yes"):
        resident = True
    elif mode in ("0", "false", "no"):
        resident = False
    elif mode != "auto":
        raise ValueError(f"resident={mode!r}: expected auto/0/1")

    if resident is None:
        probe = np.asarray(dataset[0]) if len(dataset) else None
        resident = (0 if probe is None else probe.nbytes * len(dataset)) <= max_bytes
    if resident:
        if isinstance(dataset, ArrayDataset):
            array = dataset.array
        else:
            array = np.stack([dataset[i] for i in range(len(dataset))])
        if array.nbytes <= max_bytes:
            return ResidentBatches(ArrayDataset(array), batch_size, seed, device, mesh)
    loader = BatchLoader(dataset, batch_size, shuffle=True, drop_remainder=True, seed=seed,
                         backend="auto")
    return StreamingBatches(loader, device, mesh)
