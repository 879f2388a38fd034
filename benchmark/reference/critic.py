"""The progressive WGAN-GP critic in plain PyTorch (marian42/shapegan
``model/progressive_gan.py`` with the JAX package's entry slice): at growth
iteration i the volume enters through conv i (its kernel sliced to the one
real input channel), passes convs i-1 .. 0 (k4, s2, p1, LeakyReLU 0.2) down
to 4^3 x 256, is flattened channels-last, then Linear -> LeakyReLU ->
Linear. Fade 1: the grown layer fully in."""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from benchmark.reference.precision import Precision

Params = Dict[str, torch.Tensor]


def _lrelu(x):
    return F.leaky_relu(x, negative_slope=0.2)


def critic(params: Params, volumes: torch.Tensor, iteration: int,
           precision: Precision = Precision.F32) -> torch.Tensor:
    """Critic scores [B] of SDF volumes [B, r, r, r] (float32 out)."""
    cast = (lambda t: t.to(torch.bfloat16)) if precision.critic_bf16 else (lambda t: t)
    res = volumes.shape[-1]
    h = cast(volumes.reshape(-1, 1, res, res, res))
    for i in range(iteration, -1, -1):
        w = params[f"optional_layers.{i}.weight"]
        if i == iteration:
            w = w[:, :1]
        h = _lrelu(F.conv3d(h, cast(w), cast(params[f"optional_layers.{i}.bias"]),
                            stride=2, padding=1))
    h = h.permute(0, 2, 3, 4, 1).reshape(h.shape[0], -1)
    h = _lrelu(F.linear(h, cast(params["head_dense1.weight"]), cast(params["head_dense1.bias"])))
    out = F.linear(h, cast(params["head_dense2.weight"]), cast(params["head_dense2.bias"]))
    return out.float().reshape(-1)


def gradient_penalty(score: Callable[[torch.Tensor], torch.Tensor], alpha: torch.Tensor,
                     real: torch.Tensor, fake: torch.Tensor, weight: float) -> torch.Tensor:
    """WGAN-GP: ``weight * mean((|d score / d x| - 1)^2)`` at the
    interpolates ``alpha * real + (1 - alpha) * fake``, the norm
    ``sqrt(sum(g^2) + 1e-12)`` over each volume."""
    x = (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_(True)
    (g,) = torch.autograd.grad(score(x).sum(), x, create_graph=True)
    norms = torch.sqrt((g * g).sum(dim=tuple(range(1, g.ndim))) + 1e-12)
    return weight * ((norms - 1.0) ** 2).mean()
