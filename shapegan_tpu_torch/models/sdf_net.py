"""DeepSDF network: the implicit MLP plus its inference surface (counterpart
of :mod:`shapegan_tpu.models.sdf_net`).

Inference goes through the hand-written kernels: a single latent code is
folded into the biases (``sdf_mlp.fold_latent``) and its points run through
the points kernel; a batch of codes over one grid runs through the grid
kernel (:mod:`shapegan_tpu_torch.ops.sdf_mlp_kernels`). Normals and surface
points take the gradient with respect to the points through the grid
kernel and its backward kernel, in chunks. On the CPU the kernels' plain
versions run instead.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from shapegan_tpu_torch.data.mesh_io import TriangleMesh
from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.ops.coords import unit_sphere_mask, voxel_coordinates
from shapegan_tpu_torch.ops.mesh_extract import extract_mesh
from shapegan_tpu_torch.ops.sdf_mlp_kernels import ROW_CAP, apply_grid_best, points_value_and_gradient


class SDFNet(nn.Module):
    """The DeepSDF MLP's parameters (the JAX package's keys and ``[in, out]``
    layout, float32) and the user-facing inference helpers. The parameters
    are trainable (a trainer updates them in place); the inference helpers
    run under ``no_grad``."""

    def __init__(self, params: Optional[sdf_mlp.Params] = None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        """Wrap ``params`` (e.g. from ``checkpoints.load``) where they lie, or
        draw fresh ones from ``generator`` (seed 0 if none is given) on
        ``device`` (the CPU if none is given). Parameters are never moved:
        ``device`` must match the given ``params``' device."""
        super().__init__()
        if params is None:
            params = sdf_mlp.init(generator or torch.Generator().manual_seed(0),
                                  device=device or "cpu")
        devices = {v.device for v in params.values()}
        if len(devices) != 1:
            raise ValueError(f"SDFNet parameters lie on several devices: {sorted(map(str, devices))}")
        have = next(iter(devices))
        want = torch.device(device) if device is not None else have
        if want.type != have.type or want.index not in (None, have.index):
            raise ValueError(f"SDFNet parameters lie on {have}, not on {want}")
        self.params = nn.ParameterDict(
            {k: nn.Parameter(v.detach().to(dtype=torch.float32)) for k, v in params.items()})

    @property
    def device(self) -> torch.device:
        return self.params["w2"].device

    def param_dict(self) -> sdf_mlp.Params:
        return dict(self.params.items())

    # ---------------------------------------------------------------- core

    def apply_grid(self, grid_points: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        """Shared points [P, 3] x shape latents [B, L] → [B, P] (float32)."""
        return sdf_mlp.apply_grid(self.param_dict(), grid_points, latents)

    def apply_indexed(self, points: torch.Tensor, latent_table: torch.Tensor,
                      shape_indices: torch.Tensor) -> torch.Tensor:
        """Points [N, 3] with latents ``latent_table[shape_indices]`` → [N]
        (float32)."""
        return sdf_mlp.apply_indexed(self.param_dict(), points, latent_table, shape_indices)

    # ----------------------------------------------------------- inference

    @torch.no_grad()
    def evaluate(self, points: torch.Tensor, latent_code: torch.Tensor,
                 chunk_size: int = 262144) -> torch.Tensor:
        """SDF of many points for one latent code, folded into the biases,
        through the points kernel in chunks of ``chunk_size`` to bound
        memory."""
        points = torch.as_tensor(points, dtype=torch.float32, device=self.device)
        latent_code = torch.as_tensor(latent_code, dtype=torch.float32, device=self.device)
        folded = sdf_mlp.fold_latent(self.param_dict(), latent_code)
        empty = latent_code[:0][None, :]
        return torch.cat([apply_grid_best(folded, chunk, empty)[0]
                          for chunk in points.split(chunk_size)])

    @torch.no_grad()
    def get_voxels(self, latent_code: torch.Tensor, voxel_resolution: int = 64,
                   sphere_only: bool = True, pad: bool = False) -> torch.Tensor:
        """Dense SDF volume [res, res, res] on the network's device.

        ``sphere_only`` assigns +1 outside the radius-1.1 sphere, reproducing
        the reference's sphere-masked evaluation output.
        """
        res = int(voxel_resolution)
        latent_code = torch.as_tensor(latent_code, dtype=torch.float32, device=self.device)
        folded = sdf_mlp.fold_latent(self.param_dict(), latent_code)
        pts = voxel_coordinates(res, device=self.device)
        voxels = apply_grid_best(folded, pts, latent_code[:0][None, :])[0].reshape(res, res, res)
        if sphere_only:
            voxels = torch.where(unit_sphere_mask(res, device=self.device), voxels, 1.0)
        elif pad:
            voxels = torch.nn.functional.pad(voxels, (1,) * 6, value=1.0)
        return voxels

    @torch.no_grad()
    def get_mesh(self, latent_code: torch.Tensor, voxel_resolution: int = 64,
                 sphere_only: bool = True, level: float = 0.0,
                 raise_on_empty: bool = False) -> Optional[TriangleMesh]:
        """The iso-surface triangle mesh at ``level``: the volume is padded
        with +1 so the surface closes at the boundary, extracted on the
        device by marching tetrahedra, and centered."""
        size = 2.0
        voxels = self.get_voxels(latent_code, voxel_resolution, sphere_only=sphere_only)
        voxels = torch.nn.functional.pad(voxels, (1,) * 6, value=1.0)
        vertices, faces = extract_mesh(voxels, level=level, spacing=size / voxel_resolution)
        if vertices.shape[0] == 0:
            if raise_on_empty:
                raise ValueError("marching tetrahedra produced an empty mesh")
            return None
        return TriangleMesh(vertices - size / 2.0, faces)

    def get_uniform_surface_points(self, latent_code: torch.Tensor, point_count: int = 1000,
                                   voxel_resolution: int = 64, sphere_only: bool = True,
                                   level: float = 0.0, seed: int = 0) -> np.ndarray:
        """``point_count`` points drawn uniformly by area from the mesh's
        surface (numpy [point_count, 3])."""
        mesh = self.get_mesh(latent_code, voxel_resolution, sphere_only=sphere_only, level=level,
                             raise_on_empty=True)
        return mesh.sample(point_count, seed=seed)

    def project_to_surface(self, latent_code: torch.Tensor, points: torch.Tensor,
                           chunk_size: int = ROW_CAP):
        """(projected [N, 3], normals [N, 3], sdf [N]) of ``points``: the
        unit normals are the normalized gradient of the SDF with respect to
        the points (the latent folded into the biases; the grid kernel and
        its backward kernel, in chunks of at most ``chunk_size`` points),
        and each point moves by -sdf along its normal."""
        latent_code = torch.as_tensor(latent_code, dtype=torch.float32, device=self.device)
        points = torch.as_tensor(points, dtype=torch.float32, device=self.device)
        folded = sdf_mlp.fold_latent(self.param_dict(), latent_code)
        sdf, grads = points_value_and_gradient(folded, points, latent_code[:0], chunk_size)
        normals = grads / (torch.linalg.norm(grads, dim=1, keepdim=True) + 1e-12)
        return points - normals * sdf[:, None], normals, sdf

    def get_normals(self, latent_code: torch.Tensor, points: torch.Tensor,
                    chunk_size: int = ROW_CAP) -> torch.Tensor:
        """Unit surface normals [N, 3] of ``points`` (see
        :meth:`project_to_surface`)."""
        return self.project_to_surface(latent_code, points, chunk_size)[1]

    @torch.no_grad()
    def get_surface_points(self, latent_code: torch.Tensor, sample_size: int = 100000,
                           sdf_cutoff: float = 0.1, return_normals: bool = False,
                           use_unit_sphere: bool = True,
                           generator: Optional[torch.Generator] = None):
        """Sample points (uniform in the radius-1.1 ball, or in the cube
        [-1.1, 1.1]^3), project each onto the zero level set along its
        normal, and keep those whose |SDF| was below ``sdf_cutoff``. Returns
        the points [M, 3] (and their normals) on the network's device. The
        samples come from ``generator`` (on the network's device; a randomly
        seeded one if none is given)."""
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.seed()
        shape = (int(sample_size), 3)
        if use_unit_sphere:
            direction = torch.randn(shape, generator=generator, device=self.device)
            direction = direction / (torch.linalg.norm(direction, dim=1, keepdim=True) + 1e-12)
            radius = torch.rand((shape[0], 1), generator=generator, device=self.device) ** (1 / 3)
            points = direction * radius * 1.1
        else:
            points = torch.rand(shape, generator=generator, device=self.device) * 2.2 - 1.1
        projected, normals, sdf = self.project_to_surface(latent_code, points)
        keep = (sdf.abs() < sdf_cutoff) & torch.isfinite(projected).all(dim=1)
        if return_normals:
            return projected[keep], normals[keep]
        return projected[keep]

    def get_surface_points_in_batches(self, latent_code: torch.Tensor, amount: int = 1000,
                                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[amount, 3] surface points, from up to 20 rounds of
        :meth:`get_surface_points` with ``6 * amount`` samples each; rows
        the rounds do not fill stay zero."""
        result = torch.zeros((amount, 3), device=self.device)
        position = 0
        for _ in range(20):
            if position >= amount:
                break
            pts = self.get_surface_points(latent_code, sample_size=amount * 6, generator=generator)
            used = min(amount - position, pts.shape[0])
            result[position:position + used] = pts[:used]
            position += used
        return result
