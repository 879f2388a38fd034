"""Shape metrics: surface point clouds and their Chamfer-based scores
(counterpart of :mod:`shapegan_tpu.metrics` and of the root ``metrics.py``).

    python -m shapegan_tpu_torch.metrics [sample|checkpoints|dataset|test] [cpu] \\
        [model_dir=D] [synthetic=N] ...

Sampling: :func:`sample_point_clouds` meshes a DeepSDF network's volumes
(:meth:`~shapegan_tpu_torch.models.sdf_net.SDFNet.get_mesh`: on the GPU the
points kernel, one folded latent a mesh) and :func:`sample_from_voxels`
meshes SDF volumes (:func:`~shapegan_tpu_torch.ops.mesh_extract.extract_mesh`
on the device); both draw area-weighted surface points and rescale each
cloud to the half-unit sphere (or cube). Scores: the symmetric Chamfer
distance of two clouds, the matrix of it between two sets, MMD-CD (the mean
over reference clouds of the closest generated one) and COV-CD (the share of
reference clouds that are some generated cloud's nearest).

The Chamfer matrix runs on the device, batched over pairs, in plain torch
ops as the JAX package's runs in plain ``jnp``: squared distances summed as
``(a - b)^2`` per coordinate, never the ``|a|^2 + |b|^2 - 2ab`` product form
(``torch.cdist``'s choice for large sets), which cancels away the small
distances MMD-CD is made of; no matrix product, so TF32 cannot touch it.
The ``min`` / ``argmin`` over the [n, m] matrix run on the host with numpy,
as the JAX functions do, so ties between identical clouds resolve alike.

The CLI writes the clouds to ``data/eval/*.npy`` (``sample``: from the
``sdf_net`` checkpoint and its latent codes; ``checkpoints``: from every
epoch snapshot; ``dataset``: from the voxel dataset; ``test``: a Chamfer
self-check) and prints MMD-CD and COV-CD when both ``generated.npy`` and
``dataset.npy`` exist. It runs on the GPU unless given ``cpu``.
"""

from __future__ import annotations

import glob
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from shapegan_tpu_torch import checkpoints
from shapegan_tpu_torch.core.config import BOOL_TOKENS, parse_cli, resolve_device
from shapegan_tpu_torch.data.mesh_io import TriangleMesh
from shapegan_tpu_torch.models import LATENT_CODES_FILENAME
from shapegan_tpu_torch.ops.mesh_extract import extract_mesh
from shapegan_tpu_torch.util import ensure_directory

SAMPLE_COUNT = 64
POINT_COUNT = 2048
OUT_DIR = "data/eval"
MODES = ("sample", "checkpoints", "dataset", "test")
# Pairs of clouds a device call holds: [pairs, Na, Nb] float32 distances and
# one [pairs, Na, Nb] temporary (2048 x 2048 points: 16.8 MB each a pair).
PAIR_CHUNK = 32


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def rescale_point_cloud(points: np.ndarray, method: str = "sphere") -> np.ndarray:
    """Centre a cloud and scale it into the half-unit sphere ('sphere') or
    half-unit cube ('cube')."""
    points = points - points.mean(axis=0, keepdims=True)
    if method == "sphere":
        scale = np.linalg.norm(points, axis=1).max() * 2.0
    elif method == "cube":
        scale = np.abs(points).max() * 2.0
    else:
        raise ValueError(method)
    return (points / max(scale, 1e-12)).astype(np.float32)


def sample_point_clouds(net, latent_codes, point_count: int = 2048, voxel_resolution: int = 32,
                        rescale: str = "sphere", seed: int = 0) -> np.ndarray:
    """[N, point_count, 3] surface samples of the network ``net`` (an
    :class:`~shapegan_tpu_torch.models.sdf_net.SDFNet`) at each latent code,
    one mesh a code; an empty mesh leaves its cloud all zeros."""
    clouds = np.zeros((len(latent_codes), point_count, 3), dtype=np.float32)
    for i, code in enumerate(latent_codes):
        mesh = net.get_mesh(code, voxel_resolution=voxel_resolution)
        if mesh is None:
            continue
        clouds[i] = rescale_point_cloud(mesh.sample(point_count, seed=seed + i), rescale)
    return clouds


def sample_from_voxels(voxels: np.ndarray, point_count: int = 2048, rescale: str = "sphere",
                       seed: int = 0, device=None) -> np.ndarray:
    """Surface samples of SDF volumes [N, R, R, R], each padded with +1 and
    meshed at level 0 on ``device`` (the GPU if None); an empty mesh leaves
    its cloud all zeros."""
    clouds = np.zeros((len(voxels), point_count, 3), dtype=np.float32)
    for i, volume in enumerate(voxels):
        res = volume.shape[0]
        padded = torch.nn.functional.pad(torch.as_tensor(np.asarray(volume, np.float32)),
                                          (1,) * 6, value=1.0)
        vertices, faces = extract_mesh(padded.to(_device(device)), spacing=2.0 / res)
        if vertices.shape[0] == 0:
            continue
        mesh = TriangleMesh(vertices, faces)
        clouds[i] = rescale_point_cloud(mesh.sample(point_count, seed=seed + i), rescale)
    return clouds


def _squared_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., Na, Nb] squared distances of [..., Na, 3] and [..., Nb, 3],
    summed coordinate by coordinate (x, then y, then z)."""
    d2 = (a[..., :, None, 0] - b[..., None, :, 0]) ** 2
    for k in (1, 2):
        d2 = d2 + (a[..., :, None, k] - b[..., None, :, k]) ** 2
    return d2


def chamfer_distance(a, b, device=None) -> torch.Tensor:
    """Symmetric Chamfer distance of two point sets [Na, 3], [Nb, 3]: the
    mean squared distance to the nearest point of the other set, both ways."""
    device = _device(device)
    d2 = _squared_distances(torch.as_tensor(a, dtype=torch.float32, device=device),
                            torch.as_tensor(b, dtype=torch.float32, device=device))
    return d2.min(dim=1).values.mean() + d2.min(dim=0).values.mean()


def pairwise_chamfer(set_a: np.ndarray, set_b: np.ndarray, device=None) -> np.ndarray:
    """[len(a), len(b)] Chamfer matrix between two sets of clouds [n, Na,
    3] and [m, Nb, 3], computed on ``device`` (the GPU if None) in chunks of
    ``PAIR_CHUNK`` pairs, returned as float32 on the host."""
    device = _device(device)
    a = torch.as_tensor(np.asarray(set_a, np.float32), device=device)
    b = torch.as_tensor(np.asarray(set_b, np.float32), device=device)
    n, m = len(a), len(b)
    pairs = torch.cartesian_prod(torch.arange(n), torch.arange(m)).reshape(-1, 2).to(device)
    out = torch.empty(n * m, dtype=torch.float32, device=device)
    for start in range(0, n * m, PAIR_CHUNK):
        chunk = pairs[start:start + PAIR_CHUNK]
        d2 = _squared_distances(a[chunk[:, 0]], b[chunk[:, 1]])
        out[start:start + len(chunk)] = (d2.min(dim=2).values.mean(dim=1)
                                         + d2.min(dim=1).values.mean(dim=1))
    return out.reshape(n, m).cpu().numpy()


def minimum_matching_distance(generated: np.ndarray, reference: np.ndarray, device=None) -> float:
    """MMD-CD: the mean over reference clouds of the closest generated
    cloud's Chamfer distance."""
    d = pairwise_chamfer(generated, reference, device)
    return float(d.min(axis=0).mean())


def coverage(generated: np.ndarray, reference: np.ndarray, device=None) -> float:
    """COV-CD: the share of reference clouds that are some generated cloud's
    nearest."""
    d = pairwise_chamfer(generated, reference, device)
    return float(len(np.unique(d.argmin(axis=1))) / len(reference))


# ----------------------------------------------------------------- the CLI


def load_net(config, device, epoch: Optional[int] = None):
    """The ``sdf_net`` checkpoint (or its ``epoch`` snapshot) as an
    :class:`SDFNet` on ``device`` and its latent codes."""
    from shapegan_tpu_torch.models.sdf_net import SDFNet

    params = checkpoints.load("sdf_net", epoch=epoch, base=config.model_dir, device=device)
    codes = checkpoints.load_array(LATENT_CODES_FILENAME, epoch=epoch, base=config.model_dir)
    return SDFNet(params), codes


def _sample_codes(codes: np.ndarray) -> np.ndarray:
    idx = np.random.default_rng(0).choice(len(codes), min(SAMPLE_COUNT, len(codes)), replace=False)
    return codes[idx]


def main(argv: Optional[List[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    bare = [a for a in argv if "=" not in a and not a.startswith("--") and a not in BOOL_TOKENS]
    mode = bare[0] if bare else "sample"
    if mode not in MODES:
        raise SystemExit(f"unknown mode {mode}")
    config = parse_cli([a for a in argv if a != mode])
    device = resolve_device(config)
    ensure_directory(OUT_DIR)

    if mode == "sample":
        net, codes = load_net(config, device)
        clouds = sample_point_clouds(net, _sample_codes(codes), POINT_COUNT)
        np.save(os.path.join(OUT_DIR, "generated.npy"), clouds)
        print(f"wrote {clouds.shape} -> {OUT_DIR}/generated.npy")
    elif mode == "checkpoints":
        for path in sorted(glob.glob(os.path.join(config.model_dir, "checkpoints",
                                                  "sdf_net-epoch-*.npz"))):
            epoch = int(path.split("-epoch-")[1].split(".")[0])
            try:
                net, codes = load_net(config, device, epoch=epoch)
            except FileNotFoundError:
                continue
            clouds = sample_point_clouds(net, _sample_codes(codes), POINT_COUNT)
            np.save(os.path.join(OUT_DIR, f"generated-epoch-{epoch:05d}.npy"), clouds)
            print(f"epoch {epoch}: wrote {clouds.shape}")
    elif mode == "dataset":
        from shapegan_tpu_torch.train.common import resolve_voxel_dataset

        dataset = resolve_voxel_dataset(config, resolution=32)
        idx = np.random.default_rng(0).choice(len(dataset), min(SAMPLE_COUNT, len(dataset)),
                                              replace=False)
        voxels = np.stack([np.asarray(dataset[int(i)]) for i in idx])
        clouds = sample_from_voxels(voxels, POINT_COUNT, device=device)
        np.save(os.path.join(OUT_DIR, "dataset.npy"), clouds)
        print(f"wrote {clouds.shape} -> {OUT_DIR}/dataset.npy")
    else:  # test
        a = np.random.default_rng(0).normal(size=(512, 3)).astype(np.float32)
        print("chamfer(a, a) =", float(chamfer_distance(a, a, device)))
        print("chamfer(a, a+0.1) =", float(chamfer_distance(a, a + 0.1, device)))

    gen_path = os.path.join(OUT_DIR, "generated.npy")
    data_path = os.path.join(OUT_DIR, "dataset.npy")
    if os.path.exists(gen_path) and os.path.exists(data_path):
        generated, reference = np.load(gen_path), np.load(data_path)
        print("MMD-CD:", minimum_matching_distance(generated, reference, device))
        print("COV-CD:", coverage(generated, reference, device))


if __name__ == "__main__":
    main()
