"""Analytic SDF shapes for dataset-free training (counterpart of
:mod:`shapegan_tpu.data.synthetic`, whose module imports jax through its
coordinate grid).

Random unions of spheres, boxes, capsules and tori, evaluated in numpy on
the port's voxel grid (the same float32 coordinates as the JAX package's),
so :func:`make_voxel_dataset` returns bit-identical volumes for the same
``(count, resolution, clamp, rescale, seed)``.
"""

from __future__ import annotations

import numpy as np

from shapegan_tpu_torch.ops.coords import voxel_coordinates


def sphere_sdf(points: np.ndarray, center=(0.0, 0.0, 0.0), radius: float = 0.5) -> np.ndarray:
    return np.linalg.norm(points - np.asarray(center, dtype=points.dtype), axis=-1) - radius


def box_sdf(points: np.ndarray, half_extents=(0.4, 0.4, 0.4), center=(0.0, 0.0, 0.0)) -> np.ndarray:
    q = np.abs(points - np.asarray(center, dtype=points.dtype)) - np.asarray(half_extents, dtype=points.dtype)
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    inside = np.minimum(np.max(q, axis=-1), 0.0)
    return outside + inside


def capsule_sdf(points: np.ndarray, a=(0.0, -0.3, 0.0), b=(0.0, 0.3, 0.0), radius: float = 0.25) -> np.ndarray:
    a = np.asarray(a, dtype=points.dtype)
    b = np.asarray(b, dtype=points.dtype)
    pa = points - a
    ba = b - a
    h = np.clip(np.einsum("...i,i->...", pa, ba) / np.dot(ba, ba), 0.0, 1.0)
    return np.linalg.norm(pa - h[..., None] * ba, axis=-1) - radius


def torus_sdf(points: np.ndarray, major: float = 0.4, minor: float = 0.15) -> np.ndarray:
    qx = np.sqrt(points[..., 0] ** 2 + points[..., 2] ** 2) - major
    return np.sqrt(qx**2 + points[..., 1] ** 2) - minor


_PRIMITIVES = ("sphere", "box", "capsule", "torus")


def random_shape_sdf(points: np.ndarray, seed: int) -> np.ndarray:
    """A random union of 1-3 primitives, drawn from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(rng.integers(1, 4)):
        kind = _PRIMITIVES[rng.integers(0, len(_PRIMITIVES))]
        center = rng.uniform(-0.3, 0.3, 3)
        if kind == "sphere":
            parts.append(sphere_sdf(points, center, rng.uniform(0.2, 0.5)))
        elif kind == "box":
            parts.append(box_sdf(points, rng.uniform(0.15, 0.4, 3), center))
        elif kind == "capsule":
            a = center + rng.uniform(-0.35, 0.35, 3)
            b = center - rng.uniform(-0.35, 0.35, 3)
            parts.append(capsule_sdf(points, a, b, rng.uniform(0.1, 0.25)))
        else:
            parts.append(torus_sdf(points - center, rng.uniform(0.25, 0.45), rng.uniform(0.08, 0.2)))
    return np.minimum.reduce(parts)


def make_voxel_dataset(count: int, resolution: int = 32, clamp: float = 0.1, rescale: bool = True,
                       seed: int = 0) -> np.ndarray:
    """[count, res, res, res] clamped (optionally rescaled) synthetic SDF volumes."""
    pts = voxel_coordinates(resolution).numpy()
    volumes = np.empty((count, resolution, resolution, resolution), dtype=np.float32)
    for i in range(count):
        sdf = random_shape_sdf(pts, seed=seed + i).astype(np.float32)
        sdf = np.clip(sdf, -clamp, clamp)
        if rescale:
            sdf = sdf / clamp
        volumes[i] = sdf.reshape(resolution, resolution, resolution)
    return volumes
