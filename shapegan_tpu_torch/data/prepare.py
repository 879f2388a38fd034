"""Offline data preparation: triangle meshes → training artifacts
(counterpart of :mod:`shapegan_tpu.data.prepare`).

Per mesh, with the C++ engine's scan-signed SDF (:mod:`.mesh_to_sdf`):

  * voxel grids of the unit-cube-scaled mesh at each resolution (default
    8, 16, 32, 64) → ``<out>/voxels_<res>/<id>.npy``;
  * uniform unit-ball samples → ``<out>/uniform/<id>.npy`` [N, 4] (xyz,
    sdf) and jittered near-surface samples → ``<out>/surface/<id>.npy``,
    of the unit-sphere-scaled mesh;
  * the DeepSDF cloud (200,000 points) → ``<out>/cloud/<id>.npy`` [N, 4];

then :func:`combine_sdf_clouds` concatenates the clouds into the
autodecoder's ``sdf_points.npy`` / ``sdf_values.npy`` and
:func:`write_split_file` writes ``train.txt`` / ``test.txt``.

Meshes fan out over a pool of ``cpu_count // 2`` worker processes started
with ``spawn`` (the caller may have torch's threads or CUDA live, and
forking those is unsafe). A run is idempotent: a mesh whose outputs exist
is skipped, and a mesh that yields implausible samples is quarantined with
a ``<id>.badmesh`` marker, which later runs skip too.

The voxels equal the JAX package's to the bit. The point samples differ in
their seed: each mesh draws from ``default_rng((crc32(id), k))`` — k = 0
for the uniform samples, 1 for the surface samples, 2 for the cloud — so a
run reproduces itself; the JAX package seeds with the interpreter's salted
``hash(id)`` and draws the cloud unseeded.
"""

from __future__ import annotations

import multiprocessing
import os
import traceback
import zlib
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

VOXEL_RESOLUTIONS = [8, 16, 32, 64]
UNIFORM_SAMPLE_COUNT = 64**3
SURFACE_SAMPLE_COUNT = 64**3
CLOUD_SAMPLE_COUNT = 200000


@dataclass
class PrepareConfig:
    output_dir: str = "data/prepared"
    voxel_resolutions: List[int] = field(default_factory=lambda: list(VOXEL_RESOLUTIONS))
    make_voxels: bool = True
    make_points: bool = True
    make_cloud: bool = True
    uniform_count: int = UNIFORM_SAMPLE_COUNT
    surface_count: int = SURFACE_SAMPLE_COUNT
    cloud_count: int = CLOUD_SAMPLE_COUNT
    rotation: Optional[float] = None  # a y-rotation in degrees
    workers: Optional[int] = None
    id_mode: str = "stem"  # 'stem' = file name; 'shapenet' = <id>/models/model_normalized.obj


def mesh_id(path: str, mode: str = "stem") -> str:
    if mode == "shapenet":
        return os.path.normpath(path).split(os.sep)[-3]
    return os.path.splitext(os.path.basename(path))[0]


def mesh_seed(name: str) -> int:
    """The point samples' seed of the mesh with id ``name``: its CRC-32
    (the same in every process and run)."""
    return zlib.crc32(name.encode())


def _badmesh_path(config: PrepareConfig, name: str) -> str:
    return os.path.join(config.output_dir, f"{name}.badmesh")


def _outputs_exist(config: PrepareConfig, name: str) -> bool:
    checks = []
    if config.make_voxels:
        checks += [os.path.join(config.output_dir, f"voxels_{r}", f"{name}.npy")
                   for r in config.voxel_resolutions]
    if config.make_points:
        checks += [os.path.join(config.output_dir, "uniform", f"{name}.npy"),
                   os.path.join(config.output_dir, "surface", f"{name}.npy")]
    if config.make_cloud:
        checks.append(os.path.join(config.output_dir, "cloud", f"{name}.npy"))
    return bool(checks) and all(os.path.exists(p) for p in checks)


def _save(config: PrepareConfig, kind: str, name: str, make) -> None:
    """Write ``make()`` to ``<out>/<kind>/<name>.npy`` unless it exists."""
    directory = os.path.join(config.output_dir, kind)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{name}.npy")
    if not os.path.exists(path):
        np.save(path, make())


def process_mesh_file(path: str, config: PrepareConfig) -> str:
    """Prepare one mesh; returns ``"ok"``, ``"skipped"`` (done before, or
    quarantined) or ``"bad"`` (quarantined now, or it failed)."""
    from shapegan_tpu_torch.data.mesh_io import load_mesh
    from shapegan_tpu_torch.data.mesh_to_sdf import (
        BadMeshException,
        MeshSDF,
        sample_sdf_near_surface,
        sample_surface_sdf,
        sample_uniform_sdf,
    )
    from shapegan_tpu_torch.ops.coords import _voxel_coordinates_np
    from shapegan_tpu_torch.render.camera import rotation_matrix

    name = mesh_id(path, config.id_mode)
    if os.path.exists(_badmesh_path(config, name)) or _outputs_exist(config, name):
        return "skipped"
    try:
        mesh = load_mesh(path)
        if config.rotation is not None:
            rot = rotation_matrix(config.rotation, "y")[:3, :3].astype(np.float32)
            mesh = type(mesh)(mesh.vertices @ rot.T, mesh.faces)

        if config.make_voxels:
            oracle = MeshSDF(mesh.scaled_to_unit_cube())
            for res in config.voxel_resolutions:
                _save(config, f"voxels_{res}", name, lambda: oracle.query(
                    _voxel_coordinates_np(res, 1.0, (0.0, 0.0, 0.0))).reshape((res,) * 3))

        if config.make_points or config.make_cloud:
            unit_sphere = mesh.scaled_to_unit_sphere()
            oracle = MeshSDF(unit_sphere)
            seed = mesh_seed(name)
            if config.make_points:
                _save(config, "uniform", name, lambda: sample_uniform_sdf(
                    unit_sphere, config.uniform_count, rng=np.random.default_rng((seed, 0)),
                    oracle=oracle))

                def surface():
                    rng = np.random.default_rng((seed, 1))
                    return sample_surface_sdf(unit_sphere, config.surface_count, rng=rng,
                                              oracle=oracle, seed=int(rng.integers(2**31)))

                _save(config, "surface", name, surface)
            if config.make_cloud:
                def cloud():
                    points, sdf = sample_sdf_near_surface(
                        unit_sphere, config.cloud_count, rng=np.random.default_rng((seed, 2)))
                    return np.concatenate([points, sdf[:, None]], axis=1)

                _save(config, "cloud", name, cloud)
        return "ok"
    except BadMeshException:
        os.makedirs(config.output_dir, exist_ok=True)
        open(_badmesh_path(config, name), "w").close()
        return "bad"
    except Exception:  # one mesh's failure is reported, and the run goes on
        traceback.print_exc()
        return "bad"


def process_mesh_files(paths: List[str], config: PrepareConfig,
                       workers: Optional[int] = None) -> List[str]:
    """Prepare ``paths`` over a pool of ``workers`` (default
    ``config.workers``, else ``cpu_count // 2``) spawned processes, or in
    this process with one worker; returns each mesh's result in order."""
    os.makedirs(config.output_dir, exist_ok=True)
    workers = workers or config.workers or max(1, (os.cpu_count() or 2) // 2)
    if workers == 1:
        results = [process_mesh_file(p, config) for p in paths]
    else:
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            handles = [pool.apply_async(process_mesh_file, (p, config)) for p in paths]
            results = [h.get() for h in handles]
    counts = {s: results.count(s) for s in ("ok", "skipped", "bad")}
    print(f"prepared {counts['ok']}, skipped {counts['skipped']}, bad {counts['bad']}")
    return results


def combine_sdf_clouds(config: PrepareConfig, out_dir: Optional[str] = None) -> None:
    """Concatenate the per-mesh clouds, in sorted id order, into
    ``sdf_points.npy`` [N, 3] and ``sdf_values.npy`` [N] in ``out_dir``
    (default: the parent of ``config.output_dir``)."""
    cloud_dir = os.path.join(config.output_dir, "cloud")
    files = sorted(os.path.join(cloud_dir, f) for f in os.listdir(cloud_dir) if f.endswith(".npy"))
    if not files:
        raise FileNotFoundError(f"no clouds found in {cloud_dir}")
    points, values = [], []
    for f in files:
        data = np.load(f)
        points.append(data[:, :3].astype(np.float32))
        values.append(data[:, 3].astype(np.float32))
    out_dir = out_dir or os.path.dirname(config.output_dir.rstrip("/")) or "."
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "sdf_points.npy"), np.concatenate(points))
    np.save(os.path.join(out_dir, "sdf_values.npy"), np.concatenate(values))
    print(f"combined {len(files)} clouds -> {out_dir}/sdf_points.npy")


def write_split_file(config: PrepareConfig, train_fraction: float = 0.9, seed: int = 0) -> None:
    """``train.txt`` / ``test.txt``: the ids with voxels at the first
    resolution, shuffled from ``default_rng(seed)`` and split at
    ``train_fraction``."""
    vox_dir = os.path.join(config.output_dir, f"voxels_{config.voxel_resolutions[0]}")
    ids = sorted(os.path.splitext(f)[0] for f in os.listdir(vox_dir) if f.endswith(".npy"))
    rng = np.random.default_rng(seed)
    rng.shuffle(ids)
    split = int(len(ids) * train_fraction)
    with open(os.path.join(config.output_dir, "train.txt"), "w") as f:
        f.write("\n".join(ids[:split]) + "\n")
    with open(os.path.join(config.output_dir, "test.txt"), "w") as f:
        f.write("\n".join(ids[split:]) + "\n")
