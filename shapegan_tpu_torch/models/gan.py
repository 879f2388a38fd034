"""The voxel GAN's discriminator (counterpart of
:mod:`shapegan_tpu.models.gan`; the voxel ``Generator`` is not ported).

``Discriminator``: a 32^3 SDF volume through Conv3d 1→64→128→256 (kernel 4,
stride 2, padding 1), each followed by LeakyReLU 0.2, then Conv3d 256→1
(kernel 4, stride 1, no padding) → one score per volume, through a sigmoid
when ``use_sigmoid`` (the GAN) and raw without (the WGAN critic).
:func:`clip_parameters` is the WGAN's weight clipping as a pure function of
the parameters.

Layout: NCDHW ``Conv3d``s (weights ``OIDHW``) named ``conv0``..``conv3``,
the flax module's names; :func:`params_to_jax` / :func:`params_from_jax`
convert to and from flax's ``{'conv0': {'kernel': DHWIO, 'bias'}, ...}``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from shapegan_tpu_torch.models import torch_uniform_init_
# The flax layouts of the progressive critic's convolutions are these too.
from shapegan_tpu_torch.models.progressive_gan import params_from_jax, params_to_jax

__all__ = ["Discriminator", "clip_parameters", "params_from_jax", "params_to_jax"]

CHANNELS = (1, 64, 128, 256)


class Discriminator(nn.Module):
    """32^3 voxel volume → per-volume score."""

    def __init__(self, use_sigmoid: bool = True, generator: Optional[torch.Generator] = None,
                 device=None):
        """Weights and biases drawn from U(-1/sqrt(fan_in), 1/sqrt(fan_in))
        (the JAX package's ``torch_uniform_init`` / ``make_torch_bias_init``)
        with ``generator`` (seed 0 if none is given), then moved to
        ``device``."""
        super().__init__()
        self.use_sigmoid = use_sigmoid
        for i, (c_in, c_out) in enumerate(zip(CHANNELS, CHANNELS[1:])):
            setattr(self, f"conv{i}", nn.Conv3d(c_in, c_out, kernel_size=4, stride=2, padding=1))
        self.conv3 = nn.Conv3d(CHANNELS[-1], 1, kernel_size=4, stride=1)
        generator = generator or torch.Generator().manual_seed(0)
        for i in range(4):
            torch_uniform_init_(getattr(self, f"conv{i}"), generator)
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """SDF volumes [B, 32, 32, 32] → scores [B]."""
        x = x.reshape(x.shape[0], 1, *x.shape[1:])
        for i in range(3):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x), negative_slope=0.2)
        x = self.conv3(x).reshape(x.shape[0])
        return torch.sigmoid(x) if self.use_sigmoid else x


def clip_parameters(params: Dict[str, torch.Tensor], limit: float) -> Dict[str, torch.Tensor]:
    """Every tensor clamped to [-limit, limit] (WGAN weight clipping); the
    tensors given are not changed."""
    return {k: v.clamp(-limit, limit) for k, v in params.items()}
