"""Fresh weights, drawn on the device in one call per network.

Every leaf is U(-1/sqrt(fan_in), 1/sqrt(fan_in)), PyTorch's default for
``nn.Linear`` and ``nn.Conv3d`` and the init of marian42/shapegan's
``SDFNet`` and critic. The leaves are named as the program's parameters
are (``SDFNet.param_dict()``, ``ProgressiveDiscriminator.named_parameters()``),
so both sides are handed the same tensors."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...], int]]


def sdf_net_spec(width: int, latent: int) -> Spec:
    """(key, shape, fan_in) of the DeepSDF MLP: 8 layers, the raw input
    (point and latent) concatenated again before layer 5, weights [in, out]
    with each fan-in layer's split by input (point, latent, hidden)."""
    first, skip = 3 + latent, width + 3 + latent
    spec: Spec = [("w1p", (3, width), first), ("w1z", (latent, width), first),
                  ("b1", (width,), first)]
    for i in (2, 3, 4):
        spec += [(f"w{i}", (width, width), width), (f"b{i}", (width,), width)]
    spec += [("w5h", (width, width), skip), ("w5p", (3, width), skip),
             ("w5z", (latent, width), skip), ("b5", (width,), skip)]
    for i in (6, 7):
        spec += [(f"w{i}", (width, width), width), (f"b{i}", (width,), width)]
    spec += [("w8", (width, 1), width), ("b8", (1,), width)]
    return spec


def critic_spec(feature_counts, final_features: int, head_features: int, kernel: int) -> Spec:
    """(name, shape, fan_in) of the progressive critic: one conv (k4, s2, p1)
    per resolution, layer i from ``feature_counts[i]`` channels to
    ``feature_counts[i - 1]`` (layer 0 to ``final_features``), then
    Linear(64 * final_features -> head_features -> 1)."""
    spec: Spec = []
    for i, c_in in enumerate(feature_counts):
        c_out = feature_counts[i - 1] if i > 0 else final_features
        fan = c_in * kernel ** 3
        spec += [(f"optional_layers.{i}.weight", (c_out, c_in, kernel, kernel, kernel), fan),
                 (f"optional_layers.{i}.bias", (c_out,), fan)]
    flat = 64 * final_features
    spec += [("head_dense1.weight", (head_features, flat), flat),
             ("head_dense1.bias", (head_features,), flat),
             ("head_dense2.weight", (1, head_features), head_features),
             ("head_dense2.bias", (1,), head_features)]
    return spec


def draw(spec: Spec, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The leaves of ``spec`` from one uniform draw on ``device``; each leaf
    is its own contiguous tensor."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    flat = torch.rand(sum(sizes), generator=generator, device=device)
    out = {}
    for (key, shape, fan_in), part in zip(spec, flat.split(sizes)):
        bound = 1.0 / math.sqrt(fan_in)
        out[key] = (part * (2.0 * bound) - bound).reshape(shape).contiguous()
    return out


def clone(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in params.items()}
