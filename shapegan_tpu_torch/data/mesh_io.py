"""Triangle mesh container, OBJ/STL I/O and sampling (counterpart of
:mod:`shapegan_tpu.data.mesh_io`).

A small numpy mesh type with area-weighted surface sampling, area-weighted
vertex normals, welding, the two normalizations of the data pipeline (unit
sphere for point samples, unit cube for voxels), and OBJ and STL (ASCII
read, binary read and write) files in the JAX package's formats, so a file
written by either package loads in the other to the same arrays.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np


class TriangleMesh:
    """An indexed triangle mesh: ``vertices`` [V, 3] float32, ``faces`` [F, 3] int32."""

    def __init__(self, vertices, faces, vertex_normals=None):
        self.vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
        self.faces = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
        self._vertex_normals = vertex_normals

    # ------------------------------------------------------------- geometry

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

    @property
    def area(self) -> float:
        return float(self.face_areas.sum())

    @property
    def vertex_normals(self) -> np.ndarray:
        """Area-weighted sums of the adjacent face normals, normalized
        (computed once)."""
        if self._vertex_normals is None:
            normals = np.zeros_like(self.vertices)
            fn = self.face_normals * self.face_areas[:, None]
            for i in range(3):
                np.add.at(normals, self.faces[:, i], fn)
            self._vertex_normals = normals / np.maximum(
                np.linalg.norm(normals, axis=1, keepdims=True), 1e-12)
        return self._vertex_normals

    @property
    def bounding_box(self):
        return self.vertices.min(axis=0), self.vertices.max(axis=0)

    @property
    def bounding_radius(self) -> float:
        return float(np.linalg.norm(self.vertices, axis=1).max())

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
        pts = (tri[:, 0] + u[:, None] * (tri[:, 1] - tri[:, 0])
               + v[:, None] * (tri[:, 2] - tri[:, 0]))
        if return_normals:
            return pts.astype(np.float32), self.face_normals[face_idx]
        return pts.astype(np.float32)

    # -------------------------------------------------------- normalization

    def scaled_to_unit_sphere(self) -> "TriangleMesh":
        """Centered on the bounding box's midpoint, scaled so the farthest
        vertex lies on the unit sphere (the point samples' convention)."""
        lo, hi = self.bounding_box
        v = self.vertices - (lo + hi) / 2.0
        scale = np.linalg.norm(v, axis=1).max()
        return TriangleMesh(v / max(scale, 1e-12), self.faces)

    def scaled_to_unit_cube(self) -> "TriangleMesh":
        """Centered, scaled so the longest side of the bounding box is 2
        (fills [-1, 1]^3; the voxels' convention)."""
        lo, hi = self.bounding_box
        v = self.vertices - (lo + hi) / 2.0
        scale = (hi - lo).max() / 2.0
        return TriangleMesh(v / max(scale, 1e-12), self.faces)

    # ---------------------------------------------------------------- misc

    def weld(self, decimals: int = 6) -> "TriangleMesh":
        """Merge vertices equal after rounding to ``decimals`` and drop the
        faces that collapse (a triangle soup becomes an indexed mesh with
        shared vertex normals)."""
        rounded = np.round(self.vertices, decimals)
        unique, inverse = np.unique(rounded, axis=0, return_inverse=True)
        faces = inverse.reshape(-1)[self.faces]
        ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
              & (faces[:, 0] != faces[:, 2]))
        return TriangleMesh(unique, faces[ok])

    def __repr__(self):
        return f"TriangleMesh(V={len(self.vertices)}, F={len(self.faces)})"

    def save(self, path: str) -> None:
        if path.endswith(".obj"):
            save_obj(self, path)
        elif path.endswith(".stl"):
            save_stl(self, path)
        else:
            raise ValueError(f"unsupported mesh format: {path}")


def load_mesh(path: str) -> TriangleMesh:
    if path.endswith(".obj"):
        return load_obj(path)
    if path.endswith(".stl"):
        return load_stl(path)
    raise ValueError(f"unsupported mesh format: {path}")


# ---------------------------------------------------------------------- OBJ


def load_obj(path: str) -> TriangleMesh:
    """Vertices and faces of an OBJ file (1-based or negative indices,
    ``v/vt/vn`` tokens, polygons fan-triangulated)."""
    vertices, faces = [], []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                vertices.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(vertices) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return TriangleMesh(np.array(vertices, dtype=np.float32), np.array(faces, dtype=np.int32))


def save_obj(mesh: TriangleMesh, path: str) -> None:
    with open(path, "w") as f:
        for v in mesh.vertices:
            f.write(f"v {v[0]:.8f} {v[1]:.8f} {v[2]:.8f}\n")
        for face in mesh.faces + 1:
            f.write(f"f {face[0]} {face[1]} {face[2]}\n")


# ---------------------------------------------------------------------- STL


def load_stl(path: str) -> TriangleMesh:
    """An ASCII or binary STL file's triangles, welded."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:5] == b"solid":
        text = raw.decode(errors="replace")
        if "facet" in text:
            return _load_stl_ascii(text)
    return _load_stl_binary(raw)


def _load_stl_ascii(data: str) -> TriangleMesh:
    vertices = []
    for line in data.splitlines():
        line = line.strip()
        if line.startswith("vertex"):
            parts = line.split()
            vertices.append([float(parts[1]), float(parts[2]), float(parts[3])])
    vertices = np.array(vertices, dtype=np.float32)
    faces = np.arange(len(vertices), dtype=np.int32).reshape(-1, 3)
    return TriangleMesh(vertices, faces).weld()


def _load_stl_binary(raw: bytes) -> TriangleMesh:
    count = struct.unpack("<I", raw[80:84])[0]
    records = np.frombuffer(raw[84:84 + count * 50], dtype=np.uint8).reshape(count, 50)
    tri = records[:, 12:48].copy().view(np.float32).reshape(count, 3, 3)
    vertices = tri.reshape(-1, 3)
    faces = np.arange(len(vertices), dtype=np.int32).reshape(-1, 3)
    return TriangleMesh(vertices, faces).weld()


def save_stl(mesh: TriangleMesh, path: str) -> None:
    """Binary STL: an 80-byte header of zeros, the count, and per triangle
    its face normal, three vertices and a zero attribute word."""
    tri = mesh.triangles
    normals = mesh.face_normals
    count = len(tri)
    record = np.zeros((count, 50), dtype=np.uint8)
    record[:, 0:12] = normals.astype("<f4").view(np.uint8).reshape(count, 12)
    record[:, 12:48] = tri.astype("<f4").reshape(count, 9).view(np.uint8).reshape(count, 36)
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", count))
        f.write(record.tobytes())
