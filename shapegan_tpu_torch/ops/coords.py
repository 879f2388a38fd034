"""Grid/point-space coordinate conventions (counterpart of
:mod:`shapegan_tpu.ops.coords`).

A flat point list maps onto a voxel volume in 'ij' (x-major) order:
``points.reshape(res, res, res)`` is indexed ``[x][y][z]``. The grid is built
in numpy exactly as the JAX package builds it (float64 ``linspace`` cast to
float32), so both packages evaluate bit-identical coordinates, and is then
moved to the requested device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _voxel_coordinates_np(resolution: int, size: float, center: tuple) -> np.ndarray:
    axes = [
        np.linspace(center[i] - size, center[i] + size, resolution, dtype=np.float64)
        for i in range(3)
    ]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)  # [res,res,res,3]
    out = np.ascontiguousarray(grid.reshape(-1, 3).astype(np.float32))
    out.flags.writeable = False  # cached: shared by every caller
    return out


def voxel_coordinates(resolution: int = 32, size: float = 1.0, center=0.0,
                      device="cpu") -> torch.Tensor:
    """Flat [res^3, 3] float32 grid coordinates in x-major ('ij') order."""
    if isinstance(center, (int, float)):
        center = (float(center),) * 3
    grid = _voxel_coordinates_np(int(resolution), float(size), tuple(center))
    return torch.tensor(grid, device=device)


def voxel_coordinate_grid(resolution: int = 32, size: float = 1.0, center=0.0,
                          device="cpu") -> torch.Tensor:
    """[res, res, res, 3] coordinate grid (same ordering, unflattened)."""
    return voxel_coordinates(resolution, size, center, device).reshape(
        resolution, resolution, resolution, 3)


@functools.lru_cache(maxsize=8)
def _unit_sphere_mask_np(resolution: int, radius: float) -> np.ndarray:
    pts = _voxel_coordinates_np(resolution, 1.0, (0.0, 0.0, 0.0))
    out = (np.linalg.norm(pts, axis=1) < radius).reshape(resolution, resolution, resolution)
    out.flags.writeable = False
    return out


def unit_sphere_mask(resolution: int, radius: float = 1.1, device="cpu") -> torch.Tensor:
    """Boolean [res,res,res] mask of grid points with ||p|| < radius: cells
    outside it get SDF +1, reproducing the reference's sphere-masked
    voxelization."""
    return torch.tensor(_unit_sphere_mask_np(int(resolution), float(radius)), device=device)


def unit_ball_from_draws(normal: torch.Tensor, uniform: torch.Tensor) -> torch.Tensor:
    """Points in the unit ball from a normal draw [n, 3] and a uniform draw
    [n, 1] in [0, 1): the direction over its norm (+1e-12) times the radius
    ``uniform ** (1/3)``, whose cubic CDF makes the points uniform in the
    ball."""
    direction = normal / (torch.linalg.norm(normal, dim=1, keepdim=True) + 1e-12)
    return direction * uniform ** (1.0 / 3.0)


def sample_unit_sphere(n: int, generator: torch.Generator, device="cpu") -> torch.Tensor:
    """``n`` float32 points [n, 3] uniform in the unit ball, at a static
    shape (no rejection), drawn from ``generator`` (on ``device``)."""
    normal = torch.randn((n, 3), generator=generator, device=device)
    uniform = torch.rand((n, 1), generator=generator, device=device)
    return unit_ball_from_draws(normal, uniform)
