"""Hybrid GAN: DeepSDF implicit generator + voxel discriminator (counterpart
of :mod:`shapegan_tpu.train.hybrid_gan`).

Ported so far: the forward-only generation path that produces the GAN's
samples, on one device. The trainer and the sharded branch come later.
"""

from __future__ import annotations

import torch

from shapegan_tpu_torch.models.sdf_net import SDFNet
from shapegan_tpu_torch.ops.sdf_mlp_kernels import apply_grid_best


@torch.no_grad()
def generate_volumes_inference(net: SDFNet, grid_points: torch.Tensor,
                               latent_codes: torch.Tensor, resolution: int) -> torch.Tensor:
    """Latents [B, L] over grid points [res^3, 3] → SDF volumes
    [B, res, res, res], forward only: the grid kernel on CUDA (the points
    kernel when B == 1)."""
    flat = apply_grid_best(net.param_dict(), grid_points, latent_codes)
    return flat.reshape(-1, resolution, resolution, resolution)
