"""Analytic SDF volumes made on the device: each shape a union of 1-3
primitives (sphere, box, capsule, torus) with the parameter ranges of
``shapegan_tpu_torch.data.synthetic.random_shape_sdf``, evaluated on the
voxel grid and clamped. A frozen copy in torch, drawn from a
``torch.Generator`` in a few calls, so that a later change to the
program's generator cannot change the benchmark's data."""

from __future__ import annotations

import torch

SLOTS = 3


def voxel_grid(resolution: int, device) -> torch.Tensor:
    """[res^3, 3] float32 points of [-1, 1]^3 in x-major ('ij') order,
    float64 ``linspace`` cast to float32."""
    axis = torch.linspace(-1.0, 1.0, resolution, dtype=torch.float64, device=device)
    grid = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), dim=-1)
    return grid.reshape(-1, 3).to(torch.float32).contiguous()


def _length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1))


def _part_sdf(p, kind, center, u):
    """SDF [S, P] of each shape's part: ``kind`` [S], ``center`` [S, 3],
    ``u`` [S, 8] uniforms in [0, 1) mapped onto the kind's ranges; p [P, 3]."""
    q = p[None] - center[:, None]                                    # [S, P, 3]
    sphere = _length(q) - (0.2 + 0.3 * u[:, 0:1])
    half = 0.15 + 0.25 * u[:, None, 0:3]
    d = q.abs() - half
    box = _length(d.clamp_min(0.0)) + d.max(-1).values.clamp_max(0.0)
    a = 0.7 * u[:, None, 0:3] - 0.35                                  # a = c + U(-.35, .35)
    b = -(0.7 * u[:, None, 3:6] - 0.35)                              # b = c - U(-.35, .35)
    ba = b - a
    h = (((q - a) * ba).sum(-1) / (ba * ba).sum(-1).clamp_min(1e-12)).clamp(0.0, 1.0)
    capsule = _length(q - a - h[..., None] * ba) - (0.1 + 0.15 * u[:, 6:7])
    ring = torch.sqrt(q[..., 0] ** 2 + q[..., 2] ** 2) - (0.25 + 0.2 * u[:, 0:1])
    torus = torch.sqrt(ring ** 2 + q[..., 1] ** 2) - (0.08 + 0.12 * u[:, 1:2])
    k = kind[:, None]
    return torch.where(k == 0, sphere, torch.where(k == 1, box, torch.where(k == 2, capsule, torus)))


def make_volumes(count: int, resolution: int, clamp: float, generator: torch.Generator,
                 device, chunk: int = 64) -> torch.Tensor:
    """[count, res, res, res] float32 volumes, clamped to +-``clamp``."""
    parts = torch.randint(1, SLOTS + 1, (count,), generator=generator, device=device)
    kinds = torch.randint(0, 4, (count, SLOTS), generator=generator, device=device)
    centers = torch.rand((count, SLOTS, 3), generator=generator, device=device) * 0.6 - 0.3
    uniforms = torch.rand((count, SLOTS, 8), generator=generator, device=device)
    points = voxel_grid(resolution, device)
    out = torch.empty((count, resolution ** 3), dtype=torch.float32, device=device)
    for lo in range(0, count, chunk):
        hi = min(lo + chunk, count)
        sdf = torch.full((hi - lo, points.shape[0]), float("inf"), device=device)
        for slot in range(SLOTS):
            part = _part_sdf(points, kinds[lo:hi, slot], centers[lo:hi, slot], uniforms[lo:hi, slot])
            used = (parts[lo:hi] > slot)[:, None]
            sdf = torch.where(used, torch.minimum(sdf, part), sdf)
        out[lo:hi] = sdf.clamp(-clamp, clamp)
    return out.reshape(count, resolution, resolution, resolution)
