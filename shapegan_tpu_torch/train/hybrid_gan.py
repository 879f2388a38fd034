"""Hybrid GAN: DeepSDF implicit generator + voxel discriminator (counterpart
of :mod:`shapegan_tpu.train.hybrid_gan`).

Ported so far: the generation paths the progressive WGAN-GP trainer uses,
on one device — forward only for the critic's fakes, and trainable for the
generator's loss. The trainer of this module and the sharded branch come
later.
"""

from __future__ import annotations

import torch

from shapegan_tpu_torch.models.sdf_net import SDFNet
from shapegan_tpu_torch.ops.sdf_mlp_kernels import apply_grid_best, apply_grid_trainable


def generate_volumes(net: SDFNet, grid_points: torch.Tensor, latent_codes: torch.Tensor,
                     resolution: int) -> torch.Tensor:
    """Latents [B, L] over grid points [res^3, 3] → SDF volumes
    [B, res, res, res] with gradients for the network's parameters (and the
    points and latents): the grid kernel forward and the grid backward kernel
    on CUDA, their plain versions on the CPU."""
    flat = apply_grid_trainable(net.param_dict(), grid_points, latent_codes)
    return flat.reshape(-1, resolution, resolution, resolution)


@torch.no_grad()
def generate_volumes_inference(net: SDFNet, grid_points: torch.Tensor,
                               latent_codes: torch.Tensor, resolution: int) -> torch.Tensor:
    """Latents [B, L] over grid points [res^3, 3] → SDF volumes
    [B, res, res, res], forward only: the grid kernel on CUDA (the points
    kernel when B == 1)."""
    flat = apply_grid_best(net.param_dict(), grid_points, latent_codes)
    return flat.reshape(-1, resolution, resolution, resolution)
