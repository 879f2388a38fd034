"""Analytic SDF shapes for dataset-free training (counterpart of
:mod:`shapegan_tpu.data.synthetic`, whose module imports jax through its
coordinate grid).

Random unions of spheres, boxes, capsules and tori, evaluated in numpy on
the port's voxel grid (the same float32 coordinates as the JAX package's),
so :func:`make_voxel_dataset` returns bit-identical volumes for the same
``(count, resolution, clamp, rescale, seed)``, and
:func:`make_sdf_pointcloud` bit-identical ``(points, sdf)`` for the same
``(count_shapes, points_per_shape, clamp, seed)``.
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


def make_sdf_pointcloud(count_shapes: int, points_per_shape: int, clamp: float = 0.1,
                        seed: int = 0):
    """The autodecoder's monolithic (points [S*P, 3], sdf [S*P]) float32
    arrays from random analytic shapes: per shape, uniform samples in
    [-1, 1]^3, the first half moved toward the surface (along a random
    direction scaled by the SDF, plus N(0, 0.02) jitter, clipped to the
    cube) and evaluated again; SDF clipped to +-clamp."""
    rng = np.random.default_rng(seed)
    all_points = np.empty((count_shapes * points_per_shape, 3), dtype=np.float32)
    all_sdf = np.empty(count_shapes * points_per_shape, dtype=np.float32)
    for s in range(count_shapes):
        uniform = rng.uniform(-1, 1, (points_per_shape, 3)).astype(np.float32)
        sdf = random_shape_sdf(uniform, seed=seed + s).astype(np.float32)
        half = points_per_shape // 2
        jitter = rng.normal(0, 0.02, (half, 3)).astype(np.float32)
        near = uniform[:half] - sdf[:half, None] * _normalize(rng.normal(size=(half, 3))) + jitter
        near = np.clip(near, -1, 1)
        near_sdf = random_shape_sdf(near, seed=seed + s).astype(np.float32)
        uniform[:half], sdf[:half] = near, near_sdf
        lo, hi = s * points_per_shape, (s + 1) * points_per_shape
        all_points[lo:hi] = uniform
        all_sdf[lo:hi] = np.clip(sdf, -clamp, clamp)
    return all_points, all_sdf


def _normalize(x: np.ndarray) -> np.ndarray:
    return (x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)).astype(np.float32)
