"""Iso-surface extraction from dense SDF volumes, on the device
(counterpart of :mod:`shapegan_tpu.ops.mesh_extract`).

Marching tetrahedra in plain PyTorch: every cube cell is split into 6
tetrahedra around its main diagonal, each emits 0-2 triangles through a
16-case table, and each triangle is flipped so its normal points away from
the centroid of its tetrahedron's inside (SDF < level) corners. Tables and
output order are the JAX package's: triangles come out in (cell, tet,
triangle) order, with the x-major cell order of its ``meshgrid``.

The JAX version computes every (cell, tet) pair at static shape and masks;
here only the pairs the surface crosses (case not 0 or 15) are gathered
before the interpolation, which emits exactly the same triangles in the
same order.
"""

from __future__ import annotations

import numpy as np
import torch

# Cube corner offsets, index = bit order (x, y, z).
_CUBE_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]],
    dtype=np.int64,
)

# 6-tetrahedra decomposition of the cube around the 0-7 main diagonal.
_TETS = np.array(
    [[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]],
    dtype=np.int64,
)

# Tet edges: edge e connects corners _EDGE_ENDS[e].
_EDGE_ENDS = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64)

# Triangulation per inside-bitmask (bit i set = tet corner i has SDF < level):
# up to 2 triangles of edge indices, -1 = unused.
_TRI_TABLE = -np.ones((16, 2, 3), dtype=np.int64)
_TRI_TABLE[0b0001, 0] = (0, 1, 2)
_TRI_TABLE[0b0010, 0] = (0, 3, 4)
_TRI_TABLE[0b0100, 0] = (1, 3, 5)
_TRI_TABLE[0b1000, 0] = (2, 4, 5)
_TRI_TABLE[0b0011] = ((1, 3, 4), (1, 4, 2))
_TRI_TABLE[0b0101] = ((0, 3, 5), (0, 5, 2))
_TRI_TABLE[0b1001] = ((0, 4, 5), (0, 5, 1))
_TRI_TABLE[0b0110] = ((0, 4, 5), (0, 5, 1))
_TRI_TABLE[0b1010] = ((0, 3, 5), (0, 5, 2))
_TRI_TABLE[0b1100] = ((1, 3, 4), (1, 4, 2))
_TRI_TABLE[0b0111, 0] = (2, 4, 5)
_TRI_TABLE[0b1011, 0] = (1, 3, 5)
_TRI_TABLE[0b1101, 0] = (0, 3, 4)
_TRI_TABLE[0b1110, 0] = (0, 1, 2)


def _march(voxels: torch.Tensor, level: float) -> torch.Tensor:
    """Triangles [F, 3, 3] (index space, on the volume's device) of the
    ``level`` iso-surface of a [R, R, R] volume, in (cell, tet, triangle)
    order."""
    device = voxels.device
    n = voxels.shape[0] - 1  # cells per axis
    corners = torch.as_tensor(_CUBE_CORNERS, device=device)
    tets = torch.as_tensor(_TETS, device=device)

    # Corner values per cell: [C, 8]; tet corner values [C, 6, 4].
    corner_vals = torch.stack(
        [voxels[o[0]:o[0] + n, o[1]:o[1] + n, o[2]:o[2] + n].reshape(-1) for o in _CUBE_CORNERS],
        dim=-1,
    )
    tet_vals = corner_vals[:, tets]
    inside = tet_vals < level
    case = (inside * torch.tensor([1, 2, 4, 8], device=device)).sum(-1)  # [C, 6]

    # Only (cell, tet) pairs the surface crosses emit triangles.
    cell, tet = torch.nonzero((case != 0) & (case != 15), as_tuple=True)
    vals = tet_vals[cell, tet]  # [A, 4]
    ins = inside[cell, tet]
    cell_idx = torch.stack([cell // (n * n), (cell // n) % n, cell % n], dim=-1)
    pos = (cell_idx[:, None, :] + corners[tets[tet]]).float()  # [A, 4, 3]

    # Interpolated point on each of the 6 tet edges: [A, 6, 3].
    ends = torch.as_tensor(_EDGE_ENDS, device=device)
    va, vb = vals[:, ends[:, 0]], vals[:, ends[:, 1]]
    pa, pb = pos[:, ends[:, 0]], pos[:, ends[:, 1]]
    denom = vb - va
    t = torch.where(denom.abs() > 1e-12,
                    (level - va) / torch.where(denom == 0, torch.ones_like(denom), denom),
                    torch.full_like(denom, 0.5))
    t = t.clamp(0.0, 1.0)
    edge_points = pa + t[..., None] * (pb - pa)

    # Triangles through the case table: [A, 2, 3] edge ids → [A, 2, 3, 3].
    tri_edges = torch.as_tensor(_TRI_TABLE, device=device)[case[cell, tet]]
    valid = tri_edges[..., 0] >= 0
    tris = torch.gather(
        edge_points[:, None, :, :].expand(-1, 2, -1, -1),
        2, tri_edges.clamp(min=0)[..., None].expand(-1, -1, -1, 3))

    # Orientation: flip so the normal points away from the inside centroid.
    insf = ins.float()
    inside_centroid = (pos * insf[..., None]).sum(1) / insf.sum(-1).clamp(min=1.0)[:, None]
    normal = torch.linalg.cross(tris[..., 1, :] - tris[..., 0, :], tris[..., 2, :] - tris[..., 0, :])
    outward = (normal * (tris.mean(2) - inside_centroid[:, None, :])).sum(-1) >= 0
    tris = torch.where(outward[..., None, None], tris, tris[..., [0, 2, 1], :])
    return tris[valid]


def extract_mesh(voxels: torch.Tensor, level: float = 0.0, spacing: float = 1.0, origin=None):
    """Extract the ``level`` iso-surface of a dense [R, R, R] volume ('ij',
    x-major, as :func:`shapegan_tpu_torch.ops.coords.voxel_coordinates`
    orders it).

    Returns (vertices [V, 3] float32, faces [F, 3] int32) as numpy arrays: a
    triangle soup with zero-area triangles dropped, vertex positions =
    index * spacing (+ origin).
    """
    tris = _march(voxels.float(), float(level)) * float(spacing)
    if origin is not None:
        tris = tris + torch.as_tensor(origin, dtype=torch.float32, device=tris.device)
    area2 = torch.linalg.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]).norm(dim=1)
    vertices = tris[area2 > 1e-12].reshape(-1, 3).cpu().numpy()
    faces = np.arange(vertices.shape[0], dtype=np.int32).reshape(-1, 3)
    return vertices, faces


def marching_cubes(voxels: torch.Tensor, level: float = 0.0, spacing=(1.0, 1.0, 1.0)):
    """``skimage.measure.marching_cubes``-style facade over
    :func:`extract_mesh`: (vertices, faces, normals, values), the normals
    each vertex's copy of its face normal in the triangle soup, the values
    zero. Only isotropic spacing is supported."""
    if isinstance(spacing, (int, float)):
        spacing = (spacing,) * 3
    if len(set(spacing)) != 1:
        raise NotImplementedError("anisotropic spacing not supported")
    vertices, faces = extract_mesh(torch.as_tensor(voxels), level=level, spacing=spacing[0])
    tri = vertices.reshape(-1, 3, 3)
    fnormals = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    fnormals = fnormals / np.maximum(np.linalg.norm(fnormals, axis=1, keepdims=True), 1e-12)
    normals = np.repeat(fnormals, 3, axis=0)
    values = np.zeros(vertices.shape[0], dtype=np.float32)
    return vertices, faces, normals, values
