"""Headless mesh and voxel viewer (counterpart of the offscreen part of
:mod:`shapegan_tpu.render.viewer`).

:class:`MeshRenderer` keeps the JAX viewer's scene state (rotation, model
size and colour, ground level, the triangle soup and its face normals),
meshes voxel volumes with the port's marching tetrahedra, and renders a
frame with :func:`shapegan_tpu_torch.render.software.render_scene` (the
C++ rasterizer: a light-space shadow map, then the shaded camera pass and a
shadowed floor), which is the JAX viewer's own ``get_image`` route on a
host without GL. ``get_image`` crops and resizes as the JAX one does; the
card's machine has neither OpenCV nor Pillow, so the resize is
:func:`shapegan_tpu_torch.util.resize_area`, OpenCV's ``INTER_AREA`` rule
written out.

``set_voxels(use_marching_cubes=False)`` shows binary cubes
(:func:`shapegan_tpu_torch.render.binary_voxels.create_binary_voxel_mesh`).
Not ported: the GL window, its event loop and screenshots.
"""

from __future__ import annotations

import numpy as np
import torch

from shapegan_tpu_torch.data.mesh_io import TriangleMesh
from shapegan_tpu_torch.ops.mesh_extract import extract_mesh
from shapegan_tpu_torch.render.binary_voxels import create_binary_voxel_mesh
from shapegan_tpu_torch.render.camera import get_camera_transform
from shapegan_tpu_torch.render.software import render_scene
from shapegan_tpu_torch.util import crop_image, resize_area

DEFAULT_ROTATION = (147.0, 20.0)


class MeshRenderer:
    """The scene of one offscreen viewer: set a mesh or voxels, then read
    frames with :meth:`get_image`."""

    def __init__(self, size: int = 800, background_color=(1, 1, 1, 1)):
        self.size = size
        self.background_color = background_color
        self.rotation = list(DEFAULT_ROTATION)
        self.model_size = 1.0
        self.model_color = (0.8, 0.1, 0.1)
        self.ground_level = -1.0
        self._vertices = np.zeros((0, 3), np.float32)  # triangle soup
        self._normals = np.zeros((0, 3), np.float32)

    def set_mesh(self, mesh, center_and_scale: bool = False) -> None:
        """Show a :class:`TriangleMesh` (None clears the scene), framed at
        the model size 1.08; ``center_and_scale`` centres its bounding box
        and scales it into the unit sphere."""
        if mesh is None:
            self._vertices = np.zeros((0, 3), np.float32)
            self._normals = np.zeros((0, 3), np.float32)
            return
        tri = mesh.triangles.reshape(-1, 3).astype(np.float32)
        if center_and_scale and tri.size:
            tri = tri - (tri.min(axis=0) + tri.max(axis=0))[None, :] / 2.0
            tri = tri / max(float(np.linalg.norm(tri, axis=1).max()), 1e-9)
        self._vertices = tri
        self._normals = np.repeat(mesh.face_normals, 3, axis=0).astype(np.float32)
        self.model_size = 1.08
        self.ground_level = float(tri[:, 1].min()) if tri.size else -1.0

    def set_voxels(self, voxels, use_marching_cubes: bool = True, level: float = 0.0) -> None:
        """Show an SDF volume [R, R, R] (a tensor, meshed on its device, or
        an array, meshed on the CPU) placed in [-1, 1]^3 and framed at the
        model size 1.4: its ``level`` iso-surface, padded with +1, or with
        ``use_marching_cubes=False`` the cubes of its voxels below
        ``level``."""
        voxels = torch.as_tensor(voxels, dtype=torch.float32)
        res = voxels.shape[0]
        if use_marching_cubes:
            padded = torch.nn.functional.pad(voxels, (1,) * 6, value=1.0)
            vertices, faces = extract_mesh(padded, level=level, spacing=2.0 / res)
            mesh = TriangleMesh(vertices - 1.0 - 1.0 / res, faces)
        else:
            mesh = create_binary_voxel_mesh(voxels, threshold=level)
            mesh = TriangleMesh(mesh.vertices * (2.0 / res) - 1.0, mesh.faces)
        self.set_mesh(mesh)
        self.model_size = 1.4

    def _matrices(self):
        """(camera VP, light VP) for the current rotation: the camera at
        twice the model size, the light at distance 6 and pitch 50, its yaw
        following the camera's."""
        camera_vp = get_camera_transform(self.model_size * 2.0, self.rotation[0], self.rotation[1],
                                         project=True)
        light_vp = get_camera_transform(6.0, self.rotation[0], 50.0, project=True)
        return camera_vp, light_vp

    def get_image(self, crop: bool = False, output_size: int = None, greyscale: bool = False):
        """The current frame as a uint8 array [size, size, 3] (or [size,
        size] with ``greyscale``), cropped to its content with ``crop`` and
        resized to ``output_size`` by :func:`resize_area`."""
        camera_vp, light_vp = self._matrices()
        image = render_scene(self._vertices, self._normals, camera_vp, light_vp, size=self.size,
                             ground_level=self.ground_level, albedo=self.model_color,
                             background=self.background_color[:3])
        if greyscale:
            image = image.mean(axis=2).astype(np.uint8)
        if crop:
            image = crop_image(image, background=255)
        if output_size is not None and output_size != image.shape[0]:
            image = resize_area(image, output_size)
        return image
