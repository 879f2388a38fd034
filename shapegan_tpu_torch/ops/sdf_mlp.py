"""The DeepSDF implicit-function MLP in plain PyTorch (counterpart of
:mod:`shapegan_tpu.ops.sdf_mlp`).

An 8x256 ReLU MLP over ``concat(xyz, z)`` with the raw input re-injected
after layer 4 and a final tanh. The parameter dict uses the JAX package's
keys and its ``[in, out]`` weight layout, with each fan-in layer's weight
pre-split along its input axis::

    concat(p, z) @ W  ==  p @ W[:3]  +  z @ W[3:]

so the latent term is computed once per shape and broadcast over its
points. This module is the float32 reference math; the bf16 inference path
is the CUDA kernels in :mod:`shapegan_tpu_torch.ops.sdf_mlp_kernels`.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch

from shapegan_tpu_torch import LATENT_CODE_SIZE

SDF_NET_BREADTH = 256

Params = Dict[str, torch.Tensor]

# (key, fan_in kind, shape kind) in the JAX package's layout.
_PARAM_SHAPES = (
    ("w1p", 1, (3, "b")), ("w1z", 1, ("l", "b")), ("b1", 1, ("b",)),
    ("w2", 0, ("b", "b")), ("b2", 0, ("b",)),
    ("w3", 0, ("b", "b")), ("b3", 0, ("b",)),
    ("w4", 0, ("b", "b")), ("b4", 0, ("b",)),
    ("w5h", 5, ("b", "b")), ("w5p", 5, (3, "b")), ("w5z", 5, ("l", "b")), ("b5", 5, ("b",)),
    ("w6", 0, ("b", "b")), ("b6", 0, ("b",)),
    ("w7", 0, ("b", "b")), ("b7", 0, ("b",)),
    ("w8", 0, ("b", 1)), ("b8", 0, (1,)),
)
PARAM_KEYS = tuple(key for key, _, _ in _PARAM_SHAPES)


def init(generator: torch.Generator, latent_size: int = LATENT_CODE_SIZE,
         breadth: int = SDF_NET_BREADTH, device="cpu") -> Params:
    """SDFNet parameters drawn from U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the
    PyTorch ``nn.Linear`` default, each tensor independently."""
    fan_ins = {0: breadth, 1: 3 + latent_size, 5: breadth + 3 + latent_size}
    dims = {"b": breadth, "l": latent_size}
    params = {}
    for key, fan_kind, shape in _PARAM_SHAPES:
        shape = tuple(dims.get(d, d) for d in shape)
        bound = 1.0 / math.sqrt(fan_ins[fan_kind])
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        params[key] = (u * (2 * bound) - bound).to(device)
    return params


def params_from_jax(arrays: Mapping[str, np.ndarray], device="cpu") -> Params:
    """The JAX package's SDF-MLP parameters (numpy arrays, same keys and
    layout) as float32 tensors on ``device``."""
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=device)
            for k, v in arrays.items()}


def _body(params: Params, p1: torch.Tensor, p5: torch.Tensor) -> torch.Tensor:
    """Trunk given the fan-in pre-activations of layers 1 and 5 (minus the
    layer-5 hidden-state term); shapes broadcast over [..., breadth]."""
    x = torch.relu(p1)
    x = torch.relu(x @ params["w2"] + params["b2"])
    x = torch.relu(x @ params["w3"] + params["b3"])
    x = torch.relu(x @ params["w4"] + params["b4"])
    x = torch.relu(x @ params["w5h"] + p5)
    x = torch.relu(x @ params["w6"] + params["b6"])
    x = torch.relu(x @ params["w7"] + params["b7"])
    return torch.tanh(x @ params["w8"] + params["b8"])[..., 0]


def apply(params: Params, points: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
    """SDF at ``points`` [N, 3] with per-point latents [N, L] → [N]."""
    p1 = points @ params["w1p"] + latents @ params["w1z"] + params["b1"]
    p5 = points @ params["w5p"] + latents @ params["w5z"] + params["b5"]
    return _body(params, p1, p5)


def apply_indexed(params: Params, points: torch.Tensor, latent_table: torch.Tensor,
                  shape_indices: torch.Tensor) -> torch.Tensor:
    """SDF at ``points`` [N, 3] whose latent is ``latent_table[shape_indices]``
    (the autodecoder's gathered rows) → [N]."""
    return apply(params, points, latent_table.index_select(0, shape_indices))


def apply_grid(params: Params, grid_points: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
    """Shared points [P, 3] x shape latents [B, L] → [B, P]; the latent
    projections are computed once per shape and broadcast."""
    zz1 = latents @ params["w1z"] + params["b1"]
    zz5 = latents @ params["w5z"] + params["b5"]
    p1 = (grid_points @ params["w1p"])[None, :, :] + zz1[:, None, :]
    p5 = (grid_points @ params["w5p"])[None, :, :] + zz5[:, None, :]
    return _body(params, p1, p5)


def fold_latent(params: Params, latent: torch.Tensor) -> Params:
    """Specialize the network to one fixed latent code: fold its fan-in
    terms into the layer-1/-5 biases and shrink ``w1z``/``w5z`` to zero rows,
    giving a latent-free (L=0) parameter set."""
    z = latent.reshape(-1).to(params["w1z"].dtype)
    folded = dict(params)
    folded["b1"] = params["b1"] + z @ params["w1z"]
    folded["b5"] = params["b5"] + z @ params["w5z"]
    folded["w1z"] = params["w1z"][:0]
    folded["w5z"] = params["w5z"][:0]
    return folded
