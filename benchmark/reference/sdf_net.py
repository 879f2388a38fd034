"""The DeepSDF MLP in plain PyTorch, float32 (marian42/shapegan
``model/sdf_net.py``): 8 fully connected layers of 256 with ReLU over
concat(point, latent), the raw input concatenated again before layer 5,
tanh at the end. Weights are [in, out], each fan-in layer's split by
input, so ``concat(p, z) @ W == p @ W_p + z @ W_z``; the latent's part is
computed once per shape and broadcast over its points."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from benchmark.reference.precision import Precision, mm

Params = Dict[str, torch.Tensor]
F32 = Precision.F32


def latent_terms(params: Params, latents: torch.Tensor,
                 precision: Precision = F32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer 1's and layer 5's latent parts with their biases, [B, 256]."""
    return (mm(latents, params["w1z"], precision) + params["b1"],
            mm(latents, params["w5z"], precision) + params["b5"])


def rows(params: Params, points: torch.Tensor, zz1: torch.Tensor, zz5: torch.Tensor,
         precision: Precision = F32) -> torch.Tensor:
    """SDF of points [..., 3] whose latent parts zz1 / zz5 broadcast against
    [..., 256] → [...]."""
    h = torch.relu(mm(points, params["w1p"], precision) + zz1)
    for i in (2, 3, 4):
        h = torch.relu(mm(h, params[f"w{i}"], precision) + params[f"b{i}"])
    h = torch.relu(mm(h, params["w5h"], precision) + mm(points, params["w5p"], precision) + zz5)
    for i in (6, 7):
        h = torch.relu(mm(h, params[f"w{i}"], precision) + params[f"b{i}"])
    return torch.tanh(mm(h, params["w8"], precision) + params["b8"])[..., 0]


def grid_block(params: Params, points: torch.Tensor, latents: torch.Tensor,
               precision: Precision = F32) -> torch.Tensor:
    """Points [P, 3] shared by the shapes of latents [B, L] → [B, P];
    differentiable."""
    zz1, zz5 = latent_terms(params, latents, precision)
    return rows(params, points[None], zz1[:, None], zz5[:, None], precision)


@torch.no_grad()
def grid(params: Params, points: torch.Tensor, latents: torch.Tensor,
         precision: Precision = F32, block: int = 16384) -> torch.Tensor:
    """:func:`grid_block` in blocks of points, without gradients → [B, P]."""
    return torch.cat([grid_block(params, chunk, latents, precision)
                      for chunk in points.split(block)], dim=1)


def fold(params: Params, latent: torch.Tensor, precision: Precision = F32):
    """(zz1, zz5) [256] of one latent code [L], for :func:`rows`."""
    zz1, zz5 = latent_terms(params, latent[None], precision)
    return zz1[0], zz5[0]
