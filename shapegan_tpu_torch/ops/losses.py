"""Loss functions of the ported trainers (counterpart of
:mod:`shapegan_tpu.ops.losses`; ported so far: the WGAN-GP penalty)."""

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
