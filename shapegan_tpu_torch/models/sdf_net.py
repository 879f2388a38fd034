"""DeepSDF network: the implicit MLP plus its inference surface (counterpart
of :mod:`shapegan_tpu.models.sdf_net`).

Inference goes through the hand-written kernels: a single latent code is
folded into the biases (``sdf_mlp.fold_latent``) and its points run through
the points kernel; a batch of codes over one grid runs through the grid
kernel (:mod:`shapegan_tpu_torch.ops.sdf_mlp_kernels`). On the CPU the
kernels' plain versions run instead.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from shapegan_tpu.data.mesh_io import TriangleMesh
from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.ops.coords import unit_sphere_mask, voxel_coordinates
from shapegan_tpu_torch.ops.mesh_extract import extract_mesh
from shapegan_tpu_torch.ops.sdf_mlp_kernels import apply_grid_best


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
