"""Procedural mesh fixtures with the pathologies ShapeNet is full of
(counterpart of :mod:`shapegan_tpu.data.fixtures`): non-watertight shells,
double walls, self-intersections, degenerate faces.

ShapeNetCore.v2's meshes are mostly not closed 2-manifolds, which is why
the mesh → SDF ground truth uses visibility scans rather than crossing
parity. These functions make each pathology in a controlled form, so the
scan-sign oracle can be checked against analytic truth and the whole
prepare → train → evaluate pipeline can run on a realistic corpus without
a download (:func:`make_fixture_corpus`, whose ``.obj`` files are the JAX
package's byte for byte for the same ``count`` and ``seed``)."""

from __future__ import annotations

import os

import numpy as np

from shapegan_tpu_torch.data.mesh_io import TriangleMesh, save_obj

# Box faces keyed by outward axis; each entry is (axis, sign).
_BOX_FACES = {
    "+x": (0, 1), "-x": (0, -1),
    "+y": (1, 1), "-y": (1, -1),
    "+z": (2, 1), "-z": (2, -1),
}


def box_mesh(half_extents=(0.5, 0.5, 0.5), center=(0.0, 0.0, 0.0),
             skip_faces=(), flip_winding=False) -> TriangleMesh:
    """Axis-aligned box; ``skip_faces`` (e.g. ``("+y",)``) omits sides to
    make open shells. ``flip_winding`` inverts orientation (the sign oracles
    must not care)."""
    h = np.asarray(half_extents, np.float32)
    c = np.asarray(center, np.float32)
    vertices = []
    faces = []
    for name, (axis, sign) in _BOX_FACES.items():
        if name in skip_faces:
            continue
        u_axis, v_axis = [a for a in range(3) if a != axis]
        corners = []
        for dv in (-1, 1):
            for du in (-1, 1):
                p = np.zeros(3, np.float32)
                p[axis] = sign * h[axis]
                p[u_axis] = du * h[u_axis]
                p[v_axis] = dv * h[v_axis]
                corners.append(c + p)
        base = len(vertices)
        vertices.extend(corners)
        quad = [(0, 1, 3), (0, 3, 2)] if sign > 0 else [(0, 3, 1), (0, 2, 3)]
        for tri in quad:
            tri = tri[::-1] if flip_winding else tri
            faces.append([base + i for i in tri])
    return TriangleMesh(np.asarray(vertices, np.float32), np.asarray(faces, np.int32))


def uv_sphere_mesh(radius=0.5, center=(0.0, 0.0, 0.0), n_lat=24, n_lon=48) -> TriangleMesh:
    """Watertight UV sphere (the control fixture where parity == scan)."""
    c = np.asarray(center, np.float32)
    verts = [c + np.array([0, radius, 0], np.float32)]
    for i in range(1, n_lat):
        phi = np.pi * i / n_lat
        for j in range(n_lon):
            theta = 2 * np.pi * j / n_lon
            verts.append(c + radius * np.array(
                [np.sin(phi) * np.cos(theta), np.cos(phi), np.sin(phi) * np.sin(theta)],
                np.float32))
    verts.append(c + np.array([0, -radius, 0], np.float32))
    bottom = len(verts) - 1
    faces = []
    for j in range(n_lon):
        faces.append([0, 1 + j, 1 + (j + 1) % n_lon])
    for i in range(n_lat - 2):
        ring0 = 1 + i * n_lon
        ring1 = ring0 + n_lon
        for j in range(n_lon):
            j1 = (j + 1) % n_lon
            faces.append([ring0 + j, ring1 + j, ring1 + j1])
            faces.append([ring0 + j, ring1 + j1, ring0 + j1])
    ring = 1 + (n_lat - 2) * n_lon
    for j in range(n_lon):
        faces.append([bottom, ring + (j + 1) % n_lon, ring + j])
    return TriangleMesh(np.asarray(verts, np.float32), np.asarray(faces, np.int32))


def merge_meshes(*meshes: TriangleMesh) -> TriangleMesh:
    """Concatenate meshes into one triangle soup (no welding, no CSG — the
    self-intersecting unions ShapeNet models actually contain)."""
    vertices, faces, offset = [], [], 0
    for m in meshes:
        vertices.append(np.asarray(m.vertices, np.float32))
        faces.append(np.asarray(m.faces, np.int64) + offset)
        offset += len(m.vertices)
    return TriangleMesh(np.concatenate(vertices), np.concatenate(faces).astype(np.int32))


def open_box(half_extents=(0.5, 0.5, 0.5), missing="+y") -> TriangleMesh:
    """Open shell: a box with one side removed. No enclosed volume — every
    point is reachable by some view ray through the opening."""
    return box_mesh(half_extents, skip_faces=(missing,))


def double_wall_box(outer=0.5, wall=0.1) -> TriangleMesh:
    """Closed double-walled shell: outer box + inner box surface. The cavity
    between is invisible from outside → the scan method calls the whole slab
    solid (matching the reference); crossing parity sees 2 surfaces and
    wrongly calls the cavity outside."""
    return merge_meshes(
        box_mesh((outer,) * 3),
        box_mesh((outer - wall,) * 3, flip_winding=True),
    )


def overlapping_union(offset=0.35, half=0.4) -> TriangleMesh:
    """Self-intersecting union of two boxes with interior walls retained —
    the canonical ShapeNet pathology. Points in the overlap lie behind two
    surfaces along most rays (even parity → wrongly outside); the scan
    method correctly calls them inside."""
    return merge_meshes(
        box_mesh((half,) * 3, center=(-offset, 0.0, 0.0)),
        box_mesh((half,) * 3, center=(offset, 0.0, 0.0)),
    )


def degenerate_soup(base: TriangleMesh | None = None, seed: int = 0) -> TriangleMesh:
    """A valid shape plus the junk real scans choke on: zero-area triangles,
    duplicated faces, and an orphan sliver far from the surface."""
    rng = np.random.default_rng(seed)
    base = base or box_mesh((0.4, 0.3, 0.35))
    v = np.asarray(base.vertices, np.float32)
    f = np.asarray(base.faces, np.int64)
    extra_v = [
        v[0], v[0], v[0],                       # zero-area (repeated vertex)
        *(v[1] + rng.normal(0, 1e-9, (3, 3))),  # near-zero-area sliver
    ]
    n = len(v)
    extra_f = [
        [n, n + 1, n + 2],
        [n + 3, n + 4, n + 5],
        list(f[0]),  # duplicated face
    ]
    return TriangleMesh(
        np.concatenate([v, np.asarray(extra_v, np.float32)]),
        np.concatenate([f, np.asarray(extra_f, np.int64)]).astype(np.int32),
    )


def chair_like(seed: int = 0) -> TriangleMesh:
    """A chair-shaped union of boxes with a double-walled seat, as real
    ShapeNet chairs have."""
    rng = np.random.default_rng(seed)
    jitter = lambda s: float(rng.uniform(-s, s))
    seat_y = 0.0 + jitter(0.05)
    legs = [
        box_mesh((0.05, 0.35, 0.05), center=(sx * 0.35, seat_y - 0.35, sz * 0.35))
        for sx in (-1, 1) for sz in (-1, 1)
    ]
    seat = double_wall_box(outer=0.42, wall=0.06)
    seat = TriangleMesh(
        seat.vertices * np.array([1.0, 0.15, 1.0], np.float32)
        + np.array([0, seat_y, 0], np.float32),
        seat.faces,
    )
    back = box_mesh((0.42, 0.4, 0.05), center=(0.0, seat_y + 0.45, -0.37 + jitter(0.02)))
    return merge_meshes(seat, back, *legs)


def make_fixture_corpus(directory: str, count: int = 12, seed: int = 0):
    """Write a corpus of pathological meshes as .obj files for end-to-end
    pipeline runs (prepare → train → plot). Mix: open shells, double walls,
    self-intersecting unions, degenerate soups, chair-likes, and watertight
    controls. Returns the list of written paths."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    makers = [
        lambda r: open_box(half_extents=(0.5, 0.4 + 0.1 * r.random(), 0.45), missing="+y"),
        lambda r: double_wall_box(outer=0.5, wall=0.08 + 0.04 * r.random()),
        lambda r: overlapping_union(offset=0.3 + 0.1 * r.random()),
        lambda r: degenerate_soup(seed=int(r.integers(2**31))),
        lambda r: chair_like(seed=int(r.integers(2**31))),
        lambda r: uv_sphere_mesh(radius=0.4 + 0.1 * r.random()),
        lambda r: box_mesh((0.45, 0.3 + 0.1 * r.random(), 0.4), flip_winding=True),
    ]
    paths = []
    for i in range(count):
        mesh = makers[i % len(makers)](rng)
        path = os.path.join(directory, f"fixture_{i:03d}.obj")
        save_obj(mesh, path)
        paths.append(path)
    return paths
