"""Triangle mesh container (counterpart of the parts of
:mod:`shapegan_tpu.data.mesh_io` that the port uses): a small numpy mesh
type with face normals and area-weighted surface sampling."""

from __future__ import annotations

from typing import Optional

import numpy as np


class TriangleMesh:
    """An indexed triangle mesh: ``vertices`` [V, 3] float32, ``faces`` [F, 3] int32."""

    def __init__(self, vertices, faces):
        self.vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
        self.faces = np.asarray(faces, dtype=np.int32).reshape(-1, 3)

    @property
    def triangles(self) -> np.ndarray:
        return self.vertices[self.faces]  # [F, 3, 3]

    @property
    def face_normals(self) -> np.ndarray:
        tri = self.triangles
        n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)

    @property
    def face_areas(self) -> np.ndarray:
        tri = self.triangles
        return 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)

    def sample(self, count: int, seed: Optional[int] = None, return_normals: bool = False):
        """Area-weighted uniform surface sampling from ``default_rng(seed)``."""
        rng = np.random.default_rng(seed)
        areas = self.face_areas
        probabilities = areas / max(areas.sum(), 1e-12)
        face_idx = rng.choice(len(self.faces), size=count, p=probabilities)
        tri = self.triangles[face_idx]
        u, v = rng.random((2, count)).astype(np.float32)
        flip = u + v > 1.0
        u[flip], v[flip] = 1.0 - u[flip], 1.0 - v[flip]
        pts = tri[:, 0] + u[:, None] * (tri[:, 1] - tri[:, 0]) + v[:, None] * (tri[:, 2] - tri[:, 0])
        if return_normals:
            return pts.astype(np.float32), self.face_normals[face_idx]
        return pts.astype(np.float32)
