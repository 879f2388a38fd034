"""The voxel GAN's generator and discriminator (counterpart of
:mod:`shapegan_tpu.models.gan`).

``Generator``: a latent code z [B, 128] as a [B, 128, 1, 1, 1] volume
through ConvTranspose3d 128→256 (kernel 4, stride 1, no padding: 4^3), then
256→128→64→1 (kernel 4, stride 2, padding 1: 8^3, 16^3, 32^3), flax's
BatchNorm (:class:`~shapegan_tpu_torch.models.flax_layers.BatchNorm`) and
LeakyReLU 0.2 after each but the last, tanh at the end → SDF volumes [B,
32, 32, 32]. Layers ``convt0``..``convt3`` and ``bn0``..``bn2``, the flax
module's names; :func:`~shapegan_tpu_torch.models.flax_layers.variables_to_jax`
and :func:`~shapegan_tpu_torch.models.flax_layers.load_variables` convert its
``params`` and ``batch_stats``.

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

from shapegan_tpu_torch import LATENT_CODE_SIZE
from shapegan_tpu_torch.models import torch_uniform_init_
from shapegan_tpu_torch.models.flax_layers import BatchNorm
# The flax layouts of the progressive critic's convolutions are these too.
from shapegan_tpu_torch.models.progressive_gan import params_from_jax, params_to_jax

__all__ = ["Generator", "Discriminator", "clip_parameters", "params_from_jax", "params_to_jax"]

CHANNELS = (1, 64, 128, 256)
GENERATOR_CHANNELS = (LATENT_CODE_SIZE, 256, 128, 64, 1)


class Generator(nn.Module):
    """Latent codes [B, 128] → SDF volumes [B, 32, 32, 32] in [-1, 1]."""

    def __init__(self, generator: Optional[torch.Generator] = None, device=None):
        """Weights and biases drawn from U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
        fan_in = out_channels x 4^3 as torch's ConvTranspose init (the JAX
        package's ``torch_uniform_init_transpose``), with ``generator`` (seed 0
        if none is given); BatchNorm scale 1, bias 0, statistics 0 and 1;
        then moved to ``device``."""
        super().__init__()
        channels = GENERATOR_CHANNELS
        for i, (c_in, c_out) in enumerate(zip(channels, channels[1:])):
            stride, padding = (1, 0) if i == 0 else (2, 1)
            setattr(self, f"convt{i}", nn.ConvTranspose3d(c_in, c_out, kernel_size=4, stride=stride,
                                                          padding=padding))
            if i < 3:
                setattr(self, f"bn{i}", BatchNorm(c_out))
        generator = generator or torch.Generator().manual_seed(0)
        for i in range(4):
            torch_uniform_init_(getattr(self, f"convt{i}"), generator)
        if device is not None:
            self.to(device)

    def forward(self, z: torch.Tensor, train: bool = True,
                update_stats: bool = True) -> torch.Tensor:
        """Train mode normalizes with batch statistics and stores them in
        the running ones unless ``update_stats`` is False (the D steps'
        fakes); eval mode reads the running ones."""
        x = z.reshape(-1, LATENT_CODE_SIZE, 1, 1, 1)
        for i in range(3):
            x = getattr(self, f"bn{i}")(getattr(self, f"convt{i}")(x), train, update_stats)
            x = F.leaky_relu(x, negative_slope=0.2)
        return torch.tanh(self.convt3(x).squeeze(1))


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
