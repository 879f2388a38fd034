"""Loss functions of the ported trainers (counterpart of
:mod:`shapegan_tpu.ops.losses`): the WGAN-GP penalty, the binary cross
entropy, and the (V)AE's reconstruction, KL and sign-difference terms."""

from __future__ import annotations

from typing import Callable

import torch


def gradient_penalty(critic_fn: Callable[[torch.Tensor], torch.Tensor], alpha: torch.Tensor,
                     real: torch.Tensor, fake: torch.Tensor, weight: float = 10.0) -> torch.Tensor:
    """WGAN-GP penalty on real/fake interpolates: ``weight * mean((|d critic
    / d x| - 1)^2)`` with the norm ``sqrt(sum(g^2) + 1e-12)`` over all
    non-batch axes. ``alpha`` [B, 1, ..., 1] is the per-sample interpolation
    coefficient, drawn by the caller (the JAX package draws it inside from a
    key). The interpolate is a leaf: only the critic's parameters get
    gradients, through ``create_graph=True``."""
    interpolated = (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(critic_fn(interpolated).sum(), interpolated, create_graph=True)
    norms = torch.sqrt((grads**2).sum(dim=tuple(range(1, real.ndim))) + 1e-12)
    return weight * ((norms - 1.0) ** 2).mean()


def bce_loss(predictions: torch.Tensor, targets: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Binary cross entropy over probabilities (a discriminator's outputs
    after its sigmoid), clipped to [eps, 1 - eps] first: ``-mean(t log p +
    (1 - t) log(1 - p))``, as the JAX package's ``bce_loss``."""
    p = predictions.clamp(eps, 1.0 - eps)
    return -(targets * torch.log(p) + (1.0 - targets) * torch.log(1.0 - p)).mean()


def sdf_reconstruction_loss(output: torch.Tensor, target: torch.Tensor,
                            interior_weight: float = 32.0) -> torch.Tensor:
    """Sign-weighted L1 of SDF volumes: the absolute error, times
    ``interior_weight`` where the target is occupied (< 0), averaged over
    every element."""
    weight = torch.where(target < 0, interior_weight, 1.0)
    return ((output - target).abs() * weight).mean()


def kld_loss(mean: torch.Tensor, log_variance: torch.Tensor) -> torch.Tensor:
    """The VAE's KL divergence over the element count:
    ``-0.5 * sum(1 + log_variance - mean^2 - exp(log_variance)) / mean.numel()``."""
    return -0.5 * (1.0 + log_variance - mean**2 - torch.exp(log_variance)).sum() / mean.numel()


def voxel_sign_difference(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The share of voxels whose SDF sign disagrees (``output * target <
    0``)."""
    return ((output * target) < 0).float().mean()
