"""Binary voxel meshing (counterpart of
:mod:`shapegan_tpu.render.binary_voxels`): one cube face between every
occupied and empty neighbour pair, from a single face table over the six
(axis, direction) pairs, welded into an indexed mesh. Host numpy, as in
the JAX package."""

from __future__ import annotations

import numpy as np

from shapegan_tpu_torch.data.mesh_io import TriangleMesh

# For each (axis, direction): the four face corners, counter-clockwise seen
# from the side the face normal points to, relative to the occupied voxel's
# min corner.
_FACE_CORNERS = {
    (0, +1): [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)],
    (0, -1): [(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)],
    (1, +1): [(0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0)],
    (1, -1): [(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)],
    (2, +1): [(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)],
    (2, -1): [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0)],
}


def create_binary_voxel_mesh(voxels, threshold: float = 0.0) -> TriangleMesh:
    """Cube-face mesh of the occupied (< ``threshold``) voxels of a volume
    [R, R, R] (an array or a tensor), in voxel index space (vertices in
    [0, R]^3), welded at 4 decimals."""
    if hasattr(voxels, "detach"):
        voxels = voxels.detach().cpu().numpy()
    occupied = np.pad(np.asarray(voxels) < threshold, 1, mode="constant")

    triangles = []
    for (axis, direction), corners in _FACE_CORNERS.items():
        inner = [slice(None)] * 3
        outer = [slice(None)] * 3
        inner[axis] = slice(None, -1) if direction > 0 else slice(1, None)
        outer[axis] = slice(1, None) if direction > 0 else slice(None, -1)
        cells = np.argwhere(occupied[tuple(inner)] & ~occupied[tuple(outer)])
        if cells.shape[0] == 0:
            continue
        # With direction < 0 the occupied slice starts at 1: its padded index
        # is one further along the axis. Then undo the padding.
        if direction < 0:
            cells = cells + np.eye(3, dtype=cells.dtype)[axis][None, :]
        quad = (cells - 1)[:, None, :] + np.asarray(corners)[None, :, :]  # [F, 4, 3]
        triangles.append(quad[:, [0, 1, 2], :])
        triangles.append(quad[:, [0, 2, 3], :])

    if not triangles:
        return TriangleMesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    vertices = np.concatenate(triangles).astype(np.float32).reshape(-1, 3)
    faces = np.arange(vertices.shape[0], dtype=np.int32).reshape(-1, 3)
    return TriangleMesh(vertices, faces).weld(decimals=4)
