"""Host-streamed voxel batches and the loader's backends, held against the
JAX package on the CPU: ``make_voxel_batches`` picks the JAX package's mode
for ``resident=auto|0|1`` and ``resident_max_gb``; streamed and resident
batches are equal, in the same order, epoch after epoch; the thread and
process backends give the same batches; ``prefetch_to_device`` keeps the
order. The trainers streamed and resident: test_torch_streaming_trainers.py."""

import os

import numpy as np
import pytest
import torch

from shapegan_tpu.data import datasets as jax_datasets
from shapegan_tpu.parallel.mesh import get_mesh
from shapegan_tpu.train import common as jax_common
from shapegan_tpu_torch.data import datasets, synthetic
from shapegan_tpu_torch.train import common


def voxel_files(directory, count=10, resolution=8, seed=0):
    names = synthetic.write_voxel_dataset_files(str(directory), count, resolution, seed)
    return [os.path.join(str(directory), f"{n}.npy") for n in names]


def mode(batches):
    return {common.ResidentBatches: "resident", common.StreamingBatches: "streaming"}[type(batches)]


def jax_mode(batches):
    return "resident" if isinstance(batches, jax_common.ResidentBatches) else "streaming"


@pytest.mark.parametrize("extras", [
    {}, {"resident": "0"}, {"resident": "1"}, {"resident": "auto"}, {"resident": "no"},
    {"resident_max_gb": 1e-9}, {"resident": "1", "resident_max_gb": 1e-9},
    {"resident_max_gb": 2 * 10 * 8**3 * 4 / 2**30}])
@pytest.mark.parametrize("source", ["array", "files"])
def test_mode_selection_matches_jax(extras, source, tmp_path):
    if source == "array":
        ours_ds = datasets.ArrayDataset(synthetic.make_voxel_dataset(10, 8))
        theirs_ds = jax_datasets.ArrayDataset(ours_ds.array)
    else:
        paths = voxel_files(tmp_path)
        ours_ds, theirs_ds = datasets.VoxelDataset(paths), jax_datasets.VoxelDataset(paths)
    ours = common.make_voxel_batches(ours_ds, 4, 0, extras, "cpu")
    theirs = jax_common.make_voxel_batches(theirs_ds, get_mesh(batch_size=4), 4, 0, extras)
    assert mode(ours) == jax_mode(theirs)
    assert len(ours) == len(theirs) == 2


def test_mode_selection_edges():
    ds = datasets.ArrayDataset(np.zeros((4, 2, 2, 2), np.float32))
    with pytest.raises(ValueError):
        common.make_voxel_batches(ds, 2, 0, {"resident": "sometimes"})
    assert common.RESIDENT_MAX_BYTES == jax_common.RESIDENT_MAX_BYTES == 4 << 30

    class Mixed:  # item 0 is float32, the rest float64: the stacked array outgrows the probe
        def __len__(self):
            return 4

        def __getitem__(self, i):
            return np.zeros((2, 2, 2), np.float32 if i == 0 else np.float64)

    cap = {"resident_max_gb": 200 / 2**30}  # the probe's estimate is 128 bytes, the stack 256
    assert mode(common.make_voxel_batches(Mixed(), 2, 0, cap)) == "streaming"
    assert jax_mode(jax_common.make_voxel_batches(Mixed(), get_mesh(batch_size=2), 2, 0, cap)) == (
        "streaming")


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_streamed_equals_resident_for_several_epochs(backend, tmp_path):
    dataset = datasets.VoxelDataset(voxel_files(tmp_path, count=11))
    resident = common.make_voxel_batches(dataset, 3, 7, {"resident": "1"})
    streamed = common.make_voxel_batches(dataset, 3, 7, {"resident": "0"})
    streamed.loader = datasets.BatchLoader(dataset, 3, drop_remainder=True, seed=7,
                                           backend=backend)
    try:
        assert len(resident) == len(streamed) == 3
        for epoch in (0, 1, 4, 1):
            resident.set_epoch(epoch)
            streamed.set_epoch(epoch)
            got, want = list(streamed), list(resident)
            assert len(got) == len(want) == 3
            for a, b in zip(got, want):
                assert a.dtype == torch.float32 and a.shape == (3, 8, 8, 8)
                assert torch.equal(a, b)
        orders = [torch.stack(list(resident)).sum((2, 3, 4)) for _ in range(2)]
        assert not torch.equal(orders[0], orders[1])  # no set_epoch: the stream moves on
    finally:
        streamed.loader.close()


def test_streaming_on_the_card_copies_or_fails(tmp_path):
    """Without CUDA the pinned copy raises: no batch lands on the CPU."""
    dataset = datasets.ArrayDataset(np.zeros((4, 2, 2, 2), np.float32))
    streamed = common.StreamingBatches(datasets.BatchLoader(dataset, 2, drop_remainder=True),
                                       "cuda")
    if torch.cuda.is_available():
        assert next(iter(streamed)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            next(iter(streamed))


def test_process_backend_equals_thread_and_jax(tmp_path):
    """Tuple items of a point dataset with a seed, so each epoch's draws
    must reach the worker processes with their tasks."""
    rng = np.random.default_rng(0)
    for kind in ("uniform", "surface"):
        os.makedirs(tmp_path / kind)
        for i in range(5):
            np.save(tmp_path / kind / f"s{i}.npy", rng.normal(size=(64, 4)).astype(np.float32))
    names = [f"s{i}" for i in range(5)]
    ours_ds = datasets.PointDataset(str(tmp_path), names, num_points=16, seed=3)
    theirs_ds = jax_datasets.PointDataset(str(tmp_path), names, num_points=16, seed=3)
    loaders = [datasets.BatchLoader(ours_ds, 2, seed=5, num_workers=2, backend=b)
               for b in ("thread", "process", "auto")]
    assert loaders[2].backend == ("process" if (os.cpu_count() or 1) >= 4 else "thread")
    in_memory = datasets.BatchLoader(datasets.ArrayDataset(np.zeros(4)), 2, backend="auto")
    assert in_memory.backend == "thread"
    theirs = jax_datasets.BatchLoader(theirs_ds, 2, seed=5, num_workers=2, backend="thread")
    try:
        for epoch in (2, None, 9):
            for loader in loaders + [theirs]:
                if epoch is not None:
                    loader.set_epoch(epoch)
            runs = [list(loader) for loader in loaders + [theirs]]
            assert [len(r) for r in runs] == [3] * 4 and runs[0][-1][0].shape == (1, 16, 4)
            for run in runs[1:]:
                for (a_u, a_s), (b_u, b_s) in zip(runs[0], run):
                    np.testing.assert_array_equal(a_u, b_u)
                    np.testing.assert_array_equal(a_s, b_s)
        pool = loaders[1]._pool
        assert pool is not None and list(loaders[1]) and loaders[1]._pool is pool
    finally:
        for loader in loaders:
            loader.close()
    assert loaders[1]._pool is None
    with pytest.raises(ValueError):
        datasets.BatchLoader(ours_ds, 2, backend="fibers")


def test_prefetch_to_device_keeps_order_and_runs_ahead():
    seen = []

    def put(b):
        seen.append(b)
        return b * 10

    out = datasets.prefetch_to_device(iter(range(5)), put, buffer_size=2)
    assert next(out) == 0 and seen == [0, 1, 2]
    assert list(out) == [10, 20, 30, 40] and seen == [0, 1, 2, 3, 4]
    assert list(datasets.prefetch_to_device([7], lambda b: b, buffer_size=4)) == [7]
    assert list(datasets.prefetch_to_device([], lambda b: b)) == []
