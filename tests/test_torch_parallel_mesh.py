"""The port's process-group mesh (shapegan_tpu_torch.parallel.mesh) against
the JAX package's device mesh: on 8 gloo ranks the meshes' shapes, each
rank's coordinates and its rows of a batch equal the JAX mesh's device
layout and shards on the 8 virtual CPU devices; the sharded voxel batches
(resident and streamed) are the single-process batches' rows; without a
process group the mesh is 1 x 1 and every collective is the identity."""

import numpy as np
import pytest
import torch

import jax

from shapegan_tpu.parallel import mesh as jax_mesh
from shapegan_tpu_torch.data.datasets import ArrayDataset
from shapegan_tpu_torch.parallel import mesh as mesh_lib
from shapegan_tpu_torch.parallel import rank_checks
from shapegan_tpu_torch.train.common import make_voxel_batches

WORLD = 8
BATCH = np.arange(WORLD * 3, dtype=np.float32).reshape(WORLD, 3)
VOXEL_BATCH = 4
VOXELS = np.random.default_rng(0).normal(size=(10, 4, 4, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks():
    return mesh_lib.spawn(rank_checks.mesh_layout, WORLD, "cpu",
                          args=(BATCH, VOXELS, VOXEL_BATCH))


@pytest.mark.parametrize("name,kw", [("default", {}), ("points2", {"points": 2}),
                                     ("batch6", {"batch_size": 6})])
def test_get_mesh_shapes_match_jax(ranks, name, kw):
    """Each rank sits where its device sits in the JAX mesh of the same
    arguments; ranks beyond data x points are outside, as the devices the
    JAX mesh leaves out."""
    jm = jax_mesh.get_mesh(**kw)
    shape = {"data": jm.shape["data"], "points": jm.shape["points"]}
    position = {d.id: tuple(int(i) for i in idx) for idx, d in np.ndenumerate(jm.devices)}
    devices = jax.devices()
    for r, out in enumerate(ranks):
        assert out[name]["shape"] == shape
        assert out[name]["member"] == (devices[r].id in position)
        if out[name]["member"]:
            assert out[name]["coords"] == position[devices[r].id]


@pytest.mark.parametrize("name,kw", [("default", {}), ("points2", {"points": 2}),
                                     ("batch6", {"batch_size": 6})])
def test_shard_batch_layout_matches_jax(ranks, name, kw):
    """A rank's rows are the shard the JAX package's shard_batch puts on
    the device at its position."""
    jm = jax_mesh.get_mesh(**kw)
    sharded = jax_mesh.shard_batch(jm, BATCH)
    by_device = {s.device.id: np.asarray(s.data) for s in sharded.addressable_shards}
    for r, out in enumerate(ranks):
        if out[name]["member"]:
            np.testing.assert_array_equal(out[name]["rows"], by_device[jax.devices()[r].id])


@pytest.mark.parametrize("resident", ["1", "0"])
def test_sharded_voxel_batches_are_rows_of_the_single_batches(ranks, resident):
    """Every data rank draws the single process's shuffle and takes its rows
    of each batch: stacked in rank order they give the single batches, in
    both epochs, resident and streamed."""
    single = make_voxel_batches(ArrayDataset(VOXELS), VOXEL_BATCH, 3, {"resident": resident}, "cpu")
    data = np.gcd(WORLD, VOXEL_BATCH)
    for epoch in range(2):
        single.set_epoch(epoch)
        want = [b.numpy() for b in single]
        got = [np.concatenate([ranks[r][f"resident{resident}"][epoch][i] for r in range(data)])
               for i in range(len(want))]
        assert len(ranks[0][f"resident{resident}"][epoch]) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_no_process_group_mesh_is_the_identity():
    """Without a process group the mesh is 1 x 1, every operation leaves its
    tensors as they are, and a larger mesh is refused."""
    mesh = mesh_lib.get_mesh(batch_size=6)
    assert mesh.shape == {"data": 1, "points": 1} and mesh.member and mesh.size == 1
    x = torch.arange(6.0).reshape(2, 3)
    assert mesh_lib.shard_batch(mesh, x) is x
    assert mesh.gather_points(x) is x and mesh.sum_grads_over_points(x)[0] is x
    grads = {"a": x}
    assert mesh.mean_over_data(grads) is grads
    assert mesh_lib.ambient_mesh() is None
    with mesh:
        assert mesh_lib.ambient_mesh() is mesh
    assert mesh_lib.ambient_mesh() is None
    with pytest.raises(ValueError, match="needs more than 1 ranks"):
        mesh_lib.get_mesh(data=2)


def test_init_from_env_without_a_launch_and_without_cuda(monkeypatch):
    """Without WORLD_SIZE > 1 the device comes back as it is; a launch of
    several ranks that asks for CUDA where there is none raises."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh_lib.init_from_env("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="without CUDA"):
        mesh_lib.init_from_env("cuda")
