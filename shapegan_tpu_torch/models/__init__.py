"""The network zoo, all seven families of the JAX package's:

* :class:`~shapegan_tpu_torch.models.autoencoder.Autoencoder` — the 32^3
  voxel AE / VAE;
* :class:`~shapegan_tpu_torch.models.gan.Generator` and
  :class:`~shapegan_tpu_torch.models.gan.Discriminator` — the voxel GAN;
* :class:`~shapegan_tpu_torch.models.progressive_gan.ProgressiveDiscriminator`;
* :class:`~shapegan_tpu_torch.models.classifier.Classifier`;
* :class:`~shapegan_tpu_torch.models.point_sdf_net.PointNet` and
  :class:`~shapegan_tpu_torch.models.point_sdf_net.SDFGenerator` — the
  point-set GAN;
* :class:`~shapegan_tpu_torch.models.sdf_net.SDFNet` — the DeepSDF network.

The conv networks' BatchNorm follows flax's, and their layouts convert to
and from flax's in :mod:`~shapegan_tpu_torch.models.flax_layers`."""

from __future__ import annotations

import math

import torch
from torch import nn

LATENT_CODES_FILENAME = "sdf_net_latent_codes"


@torch.no_grad()
def torch_uniform_init_(layer: nn.Module, generator: torch.Generator) -> None:
    """PyTorch's default Linear/Conv initialisation, drawn from ``generator``:
    weight and bias from U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in being
    the weight's size per output (the JAX package's ``torch_uniform_init``
    and ``make_torch_bias_init``). The weight is drawn first, on the CPU, then
    copied to wherever the layer lies."""
    bound = 1.0 / math.sqrt(layer.weight[0].numel())
    for param in (layer.weight, layer.bias):
        u = torch.rand(param.shape, generator=generator, dtype=torch.float32)
        param.copy_(u * (2 * bound) - bound)
