"""Mesh → SDF ground truth (counterpart of :mod:`shapegan_tpu.data.mesh_to_sdf`).

The engine is host C++ (``data/csrc/mesh_sdf.cpp``, the JAX package's
source copied): a BVH over the triangles with exact point-to-triangle
distances, and two sign oracles, selected by ``MeshSDF(sign_method=...)``:

  * ``"scan"`` (default): a point is outside iff at least one of 50
    orthographic depth scans (Fibonacci-sphere directions, 1024^2) sees it
    — the reference's virtual-scan method, which gives usable signs on
    non-watertight, double-walled and self-intersecting meshes;
  * ``"parity"``: the majority of three skew-direction ray-crossing
    parities, exact for closed surfaces and cheaper (no scans).

The library is built at first use with the host compiler
(:mod:`shapegan_tpu_torch.host_build`, the JAX package's flags) into the
git-ignored ``data/csrc/build/`` and bound with ctypes; a build that fails
raises. The numpy functions below are the engine's plain versions (the
oracle of the tests): they run only when ``use_native=False`` asks for
them, and then default to scans at :data:`NUMPY_SCAN_RESOLUTION`.

The sampling functions (``mesh_to_voxels``, ``sample_uniform_sdf``,
``sample_surface_sdf``, ``sample_sdf_near_surface``) are the JAX package's,
draw for draw from the same ``numpy`` generator.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import numpy as np

from shapegan_tpu_torch.data.mesh_io import TriangleMesh
from shapegan_tpu_torch.host_build import build_shared_library

SCAN_COUNT = 50
SCAN_RESOLUTION = 1024
# The plain versions' scan resolution: their per-face Python loop takes tens
# of seconds per mesh at 1024^2. The sign's one-texel bias grows 4x at
# 256^2; the adversarial fixtures keep their signs.
NUMPY_SCAN_RESOLUTION = 256
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "mesh_sdf.cpp")


class BadMeshException(Exception):
    """Raised when a mesh yields implausible SDF data (fewer than 1 % of
    uniform samples inside)."""


def build_engine() -> str:
    """Compile the engine if this source revision has no library yet;
    returns the library's path. Raises when the compiler is missing or
    fails."""
    return build_shared_library(SOURCE, "libmesh_sdf", "the C++ mesh SDF engine")


@functools.lru_cache(maxsize=None)
def _engine() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_engine())
    f32p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    lib.mesh_sdf_create.restype = ctypes.c_void_p
    lib.mesh_sdf_create.argtypes = [f32p, ctypes.c_int, i32p, ctypes.c_int]
    query = [ctypes.c_void_p, f32p, ctypes.c_int, f32p]
    for name in ("mesh_sdf_query", "mesh_sdf_query_scan", "mesh_sdf_query_unsigned"):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = query
    lib.mesh_sdf_build_scans.restype = None
    lib.mesh_sdf_build_scans.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.mesh_sdf_destroy.restype = None
    lib.mesh_sdf_destroy.argtypes = [ctypes.c_void_p]
    return lib


class MeshSDF:
    """Signed-distance oracle for one triangle mesh: the C++ engine, or
    with ``use_native=False`` its numpy plain versions. ``sign_method``:
    ``"scan"`` (visibility scans, built at the first scan-signed query) or
    ``"parity"`` (ray parity)."""

    def __init__(self, mesh: TriangleMesh, use_native: bool = True,
                 sign_method: str = "scan", scan_count: int = SCAN_COUNT,
                 scan_resolution: Optional[int] = None):
        self._handle = None
        if sign_method not in ("scan", "parity"):
            raise ValueError(f"unknown sign_method {sign_method!r}")
        self.mesh = mesh
        self.sign_method = sign_method
        self.scan_count = scan_count
        self.scan_resolution = scan_resolution or (
            SCAN_RESOLUTION if use_native else NUMPY_SCAN_RESOLUTION)
        self._numpy_scans = None
        self._scans_built = False
        if use_native and len(mesh.faces) > 0:
            self._lib = _engine()
            # The engine copies the triangles into its BVH at creation; the
            # arrays are kept with the handle all the same.
            self._buffers = (np.ascontiguousarray(mesh.vertices, dtype=np.float32),
                             np.ascontiguousarray(mesh.faces, dtype=np.int32))
            vertices, faces = self._buffers
            self._handle = self._lib.mesh_sdf_create(
                vertices.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(vertices),
                faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(faces))

    def _ensure_scans(self) -> None:
        """Build the depth scans on the first scan-signed query (a stack of
        ``scan_count`` x res^2 floats: 200 MB at the defaults)."""
        if self._scans_built:
            return
        if self._handle is not None:
            self._lib.mesh_sdf_build_scans(self._handle, self.scan_count, self.scan_resolution)
        else:
            self._numpy_scans = _numpy_build_scans(self.mesh, self.scan_count, self.scan_resolution)
        self._scans_built = True

    def __del__(self):
        if self._handle is not None:
            self._lib.mesh_sdf_destroy(self._handle)
            self._handle = None

    def query(self, points: np.ndarray, signed: bool = True) -> np.ndarray:
        """[P] float32 distances of ``points`` [P, 3] to the surface, signed
        (negative inside) unless ``signed=False``."""
        if len(self.mesh.faces) == 0:
            raise ValueError("the mesh has no faces")
        points = np.ascontiguousarray(points, dtype=np.float32).reshape(-1, 3)
        if signed and self.sign_method == "scan":
            self._ensure_scans()
        if self._handle is not None:
            out = np.empty(points.shape[0], dtype=np.float32)
            if not signed:
                fn = self._lib.mesh_sdf_query_unsigned
            elif self.sign_method == "scan":
                fn = self._lib.mesh_sdf_query_scan
            else:
                fn = self._lib.mesh_sdf_query
            fn(self._handle, points.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
               points.shape[0], out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            return out
        if signed and self.sign_method == "scan":
            dist = _numpy_signed_distance(self.mesh, points, signed=False)
            visible = _numpy_visible_any(self._numpy_scans, points)
            return np.where(visible, dist, -dist).astype(np.float32)
        return _numpy_signed_distance(self.mesh, points, signed=signed)


# ------------------------------------------------ the engine's plain versions


def _numpy_signed_distance(mesh: TriangleMesh, points: np.ndarray, signed: bool = True,
                           chunk: int = 2048) -> np.ndarray:
    """Exact distances by brute force over all triangles, signed by ray
    parity."""
    tri = mesh.triangles  # [F, 3, 3]
    out = np.empty(points.shape[0], dtype=np.float32)
    for start in range(0, points.shape[0], chunk):
        p = points[start:start + chunk]
        dist = np.sqrt(_point_triangle_dist2_batch(p, tri).min(axis=1))
        if signed:
            dist = np.where(_inside_by_parity(p, tri), -dist, dist)
        out[start:start + p.shape[0]] = dist
    return out


def _point_triangle_dist2_batch(points: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """[P, F] squared distances (Ericson's closest point, vectorized)."""
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]  # [F, 3]
    ab, ac = b - a, c - a
    p = points[:, None, :]  # [P, 1, 3]
    ap = p - a[None]
    d1 = np.einsum("fk,pfk->pf", ab, ap)
    d2 = np.einsum("fk,pfk->pf", ac, ap)
    bp = p - b[None]
    d3 = np.einsum("fk,pfk->pf", ab, bp)
    d4 = np.einsum("fk,pfk->pf", ac, bp)
    cp = p - c[None]
    d5 = np.einsum("fk,pfk->pf", ab, cp)
    d6 = np.einsum("fk,pfk->pf", ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom = va + vb + vc
    denom = np.where(np.abs(denom) < 1e-20, 1e-20, denom)
    v = vb / denom
    w = vc / denom
    closest = a[None] + ab[None] * v[..., None] + ac[None] * w[..., None]

    # Edge and vertex regions, by the same case analysis.
    v_ab = np.clip(d1 / np.where(d1 - d3 == 0, 1e-20, d1 - d3), 0, 1)
    v_ac = np.clip(d2 / np.where(d2 - d6 == 0, 1e-20, d2 - d6), 0, 1)
    denom_bc = (d4 - d3) + (d5 - d6)
    v_bc = np.clip((d4 - d3) / np.where(denom_bc == 0, 1e-20, denom_bc), 0, 1)

    closest = np.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[..., None],
                       a[None] + ab[None] * v_ab[..., None], closest)
    closest = np.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[..., None],
                       a[None] + ac[None] * v_ac[..., None], closest)
    closest = np.where(((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0))[..., None],
                       b[None] + (c - b)[None] * v_bc[..., None], closest)
    closest = np.where(((d1 <= 0) & (d2 <= 0))[..., None], a[None], closest)
    closest = np.where(((d3 >= 0) & (d4 <= d3))[..., None], b[None], closest)
    closest = np.where(((d6 >= 0) & (d5 <= d6))[..., None], c[None], closest)
    return np.sum((p - closest) ** 2, axis=-1)


_PARITY_DIRS = np.array([
    [0.8491679, 0.3717402, 0.3756200],
    [-0.2917509, 0.9124136, 0.2877602],
    [0.3266091, -0.2465251, 0.9124458],
])


def _inside_by_parity(points: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Majority vote of three skew-direction ray-crossing parities
    (Möller–Trumbore, the engine's directions)."""
    votes = np.zeros(points.shape[0], dtype=np.int32)
    a, b, c = (tri[:, i].astype(np.float64) for i in range(3))
    e1, e2 = b - a, c - a
    tvec = points[:, None, :].astype(np.float64) - a[None]  # [P, F, 3]
    qvec = np.cross(tvec, e1[None])
    for d in _PARITY_DIRS:
        pvec = np.cross(d, e2)  # [F, 3]
        det = np.einsum("fk,fk->f", e1, pvec)
        ok = np.abs(det) > 1e-12
        inv = np.where(ok, 1.0 / np.where(det == 0, 1, det), 0.0)
        u = np.einsum("pfk,fk->pf", tvec, pvec) * inv[None]
        v = np.einsum("pfk,k->pf", qvec, d) * inv[None]
        t = np.einsum("pfk,fk->pf", qvec, e2) * inv[None]
        hit = ok[None] & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 1e-8)
        votes += (hit.sum(axis=1) % 2 == 1).astype(np.int32)
    return votes >= 2


class _NumpyScans:
    """Depth buffers and bases of the plain version's scans (the engine's
    DepthScans)."""

    __slots__ = ("res", "center", "half_extent", "bias", "right", "up", "fwd", "depth")


def _fibonacci_directions(n: int) -> np.ndarray:
    golden = 2.3999632297286533  # 2*pi*(1 - 1/phi)
    i = np.arange(n)
    y = 1.0 - 2.0 * (i + 0.5) / n
    r = np.sqrt(np.maximum(0.0, 1.0 - y * y))
    theta = golden * i
    return np.stack([r * np.cos(theta), y, r * np.sin(theta)], axis=1)


def _numpy_build_scans(mesh: TriangleMesh, n_scans: int, res: int) -> _NumpyScans:
    """``n_scans`` orthographic z-buffers of ``res``^2 texels over the
    bounding sphere, one triangle at a time."""
    scans = _NumpyScans()
    scans.res = res
    v = np.asarray(mesh.vertices, np.float64)
    lo, hi = v.min(axis=0), v.max(axis=0)
    scans.center = (lo + hi) / 2
    scans.half_extent = float(np.linalg.norm((hi - lo) / 2)) * 1.02 + 1e-6
    scans.bias = 2.0 * scans.half_extent / res
    fwd = _fibonacci_directions(n_scans)
    ref = np.where(np.abs(fwd[:, 1:2]) < 0.99, [[0.0, 1.0, 0.0]], [[1.0, 0.0, 0.0]])
    right = np.cross(fwd, ref)
    right /= np.linalg.norm(right, axis=1, keepdims=True)
    up = np.cross(right, fwd)
    scans.right, scans.up, scans.fwd = right, up, fwd
    scans.depth = np.full((n_scans, res, res), np.inf, np.float32)

    tri = np.asarray(mesh.triangles, np.float64) - scans.center  # [F, 3, 3]
    scale = res / (2.0 * scans.half_extent)
    for s in range(n_scans):
        zbuf = scans.depth[s]
        sx = (tri @ right[s] + scans.half_extent) * scale  # [F, 3]
        sy = (tri @ up[s] + scans.half_extent) * scale
        sz = tri @ fwd[s]
        area = (sx[:, 1] - sx[:, 0]) * (sy[:, 2] - sy[:, 0]) - (
            sy[:, 1] - sy[:, 0]) * (sx[:, 2] - sx[:, 0])
        for f in np.nonzero(np.abs(area) >= 1e-12)[0]:
            x0 = max(0, int(np.floor(sx[f].min())))
            x1 = min(res - 1, int(np.ceil(sx[f].max())))
            y0 = max(0, int(np.floor(sy[f].min())))
            y1 = min(res - 1, int(np.ceil(sy[f].max())))
            if x0 > x1 or y0 > y1:
                continue
            xs, ys = np.meshgrid(np.arange(x0, x1 + 1) + 0.5, np.arange(y0, y1 + 1) + 0.5)
            inv_area = 1.0 / area[f]
            w0 = ((sx[f, 1] - xs) * (sy[f, 2] - ys) - (sy[f, 1] - ys) * (sx[f, 2] - xs)) * inv_area
            w1 = ((sx[f, 2] - xs) * (sy[f, 0] - ys) - (sy[f, 2] - ys) * (sx[f, 0] - xs)) * inv_area
            w2 = 1.0 - w0 - w1
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
            z = w0 * sz[f, 0] + w1 * sz[f, 1] + w2 * sz[f, 2]
            window = zbuf[y0:y1 + 1, x0:x1 + 1]
            np.minimum(window, np.where(inside, z, np.inf).astype(np.float32), out=window)
    return scans


def _numpy_visible_any(scans: _NumpyScans, points: np.ndarray) -> np.ndarray:
    """[P] bool: visible in at least one scan (the largest depth of the 3x3
    texels around the point's, plus a one-texel bias, as the engine
    compares)."""
    res = scans.res
    scale = res / (2.0 * scans.half_extent)
    q = points.astype(np.float64) - scans.center
    visible = np.zeros(points.shape[0], dtype=bool)
    for s in range(scans.depth.shape[0]):
        x = (q @ scans.right[s] + scans.half_extent) * scale
        y = (q @ scans.up[s] + scans.half_extent) * scale
        z = q @ scans.fwd[s]
        px = np.floor(x).astype(np.int64)
        py = np.floor(y).astype(np.int64)
        out_of_view = (px <= 0) | (py <= 0) | (px >= res - 1) | (py >= res - 1)
        pxc = np.clip(px, 1, res - 2)
        pyc = np.clip(py, 1, res - 2)
        zbuf = scans.depth[s]
        zmax = np.full(points.shape[0], -np.inf)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                zmax = np.maximum(zmax, zbuf[pyc + dy, pxc + dx])
        visible |= out_of_view | (z <= zmax + scans.bias)
        if visible.all():
            break
    return visible


# ------------------------------------------------------------ sampling API


def mesh_to_voxels(mesh: TriangleMesh, voxel_resolution: int = 32, pad: bool = False) -> np.ndarray:
    """Dense [res]^3 SDF grid over [-1, 1]^3 of the unit-cube-scaled mesh,
    'ij' ordered; ``pad`` adds a border of +1."""
    from shapegan_tpu_torch.ops.coords import _voxel_coordinates_np

    oracle = MeshSDF(mesh.scaled_to_unit_cube())
    pts = _voxel_coordinates_np(int(voxel_resolution), 1.0, (0.0, 0.0, 0.0))
    sdf = oracle.query(pts).reshape((voxel_resolution,) * 3)
    if pad:
        sdf = np.pad(sdf, 1, mode="constant", constant_values=1.0)
    return sdf


def sample_uniform_sdf(mesh: TriangleMesh, count: int, rng=None, oracle: Optional[MeshSDF] = None):
    """[count, 4] uniform samples of the unit ball with their SDF (xyz,
    sdf) of a unit-sphere-scaled mesh. Raises :class:`BadMeshException`
    when fewer than 1 % land inside."""
    rng = rng or np.random.default_rng()
    direction = rng.normal(size=(count, 3))
    direction /= np.maximum(np.linalg.norm(direction, axis=1, keepdims=True), 1e-12)
    radius = rng.random((count, 1)) ** (1 / 3)
    points = (direction * radius).astype(np.float32)
    sdf = (oracle or MeshSDF(mesh)).query(points)
    if (sdf < 0).mean() < 0.01:
        raise BadMeshException("less than 1% of uniform samples are inside the mesh")
    return np.concatenate([points, sdf[:, None]], axis=1)


def sample_surface_sdf(mesh: TriangleMesh, count: int, jitter: float = 0.04, rng=None,
                       oracle: Optional[MeshSDF] = None, seed: Optional[int] = None):
    """[count, 4] near-surface samples: surface points drawn with
    ``seed``, moved by N(0, ``jitter``) noise from ``rng`` (``default_rng(seed)``
    if None), with their true SDF."""
    rng = rng or np.random.default_rng(seed)
    points = mesh.sample(count, seed=seed)
    points = points + rng.normal(0, jitter, points.shape).astype(np.float32)
    sdf = (oracle or MeshSDF(mesh)).query(points)
    return np.concatenate([points, sdf[:, None]], axis=1)


def sample_sdf_near_surface(mesh: TriangleMesh, count: int = 200000, rng=None):
    """The DeepSDF cloud of a unit-sphere-scaled mesh: 47.5 % surface
    points with N(0, 0.0025) jitter, 47.5 % with N(0, 0.00025) (variances),
    5 % uniform in the unit ball, signed by an oracle of its own. Returns
    (points [N, 3], sdf [N])."""
    rng = rng or np.random.default_rng()
    oracle = MeshSDF(mesh)
    n_tight = n_loose = int(count * 0.475)
    n_uniform = count - n_tight - n_loose
    surface = mesh.sample(n_tight + n_loose, seed=int(rng.integers(2**31)))
    tight = surface[:n_tight] + rng.normal(0, 0.0025**0.5, (n_tight, 3))
    loose = surface[n_tight:] + rng.normal(0, 0.00025**0.5, (n_loose, 3))
    direction = rng.normal(size=(n_uniform, 3))
    direction /= np.maximum(np.linalg.norm(direction, axis=1, keepdims=True), 1e-12)
    uniform = direction * rng.random((n_uniform, 1)) ** (1 / 3)
    points = np.concatenate([tight, loose, uniform]).astype(np.float32)
    return points, oracle.query(points)
