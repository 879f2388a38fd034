"""Progressive-growing critic of the hybrid WGAN-GP (counterpart of
:mod:`shapegan_tpu.models.progressive_gan`).

``RESOLUTIONS = [8, 16, 32, 64]``, ``FEATURE_COUNTS = [128, 64, 32, 1]``.
One optional conv (k4, s2, p1, LeakyReLU 0.2) per resolution; at iteration
``i`` the volume passes layers ``i, i-1, …, 0`` down to a 4^3 x 256 volume,
then the shared head Linear(64·256 → 128 → 1). All four optional layers
always exist, so one parameter set serves every iteration.

As in the JAX package: the grown iteration's entry conv runs with its kernel
sliced to the one real input channel (the same values as zero-padding the
input first); while ``fade_in_progress < 1`` its output is blended with the
stride-2 downsample of the raw input, ``alpha = clip(fade, 0, 1)``.

Layout: convs are NCDHW ``Conv3d``s (weights ``OIDHW``); the JAX package's
flax convs are NDHWC (kernels ``DHWIO``) and it flattens the 4^3 x 256
volume channels-last before the head. The port flattens channels-last too,
so the JAX head weights carry over unchanged (only transposed, as every
Dense kernel is).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from shapegan_tpu_torch.models import torch_uniform_init_

RESOLUTIONS = [8, 16, 32, 64]
FEATURE_COUNTS = [128, 64, 32, 1]
FINAL_LAYER_FEATURES = 256
HEAD_FEATURES = 128


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


def from_sdf(x: torch.Tensor, iteration: int) -> torch.Tensor:
    """SDF volumes [B, res, res, res] (or [B, 1, ...]) as [B, C, res, res,
    res] with the one real channel first and zeros up to
    ``FEATURE_COUNTS[iteration]`` channels."""
    resolution = RESOLUTIONS[iteration]
    x = x.reshape(-1, 1, resolution, resolution, resolution)
    return F.pad(x, (0, 0, 0, 0, 0, 0, 0, FEATURE_COUNTS[iteration] - 1))


class ProgressiveDiscriminator(nn.Module):
    """Growing critic for 8^3 → 64^3 SDF volumes."""

    def __init__(self, generator: Optional[torch.Generator] = None, device=None):
        """Weights and biases drawn from U(-1/sqrt(fan_in), 1/sqrt(fan_in))
        (the JAX package's ``torch_uniform_init`` / ``make_torch_bias_init``)
        with ``generator`` (seed 0 if none is given), then moved to
        ``device``."""
        super().__init__()
        self.optional_layers = nn.ModuleList(
            nn.Conv3d(FEATURE_COUNTS[i], FEATURE_COUNTS[i - 1] if i > 0 else FINAL_LAYER_FEATURES,
                      kernel_size=4, stride=2, padding=1)
            for i in range(len(FEATURE_COUNTS)))
        self.head_dense1 = nn.Linear(64 * FINAL_LAYER_FEATURES, HEAD_FEATURES)
        self.head_dense2 = nn.Linear(HEAD_FEATURES, 1)
        generator = generator or torch.Generator().manual_seed(0)
        for layer in (*self.optional_layers, self.head_dense1, self.head_dense2):
            torch_uniform_init_(layer, generator)  # fan-in: in x kernel volume
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor, iteration: int = 0, fade_in_progress=1.0) -> torch.Tensor:
        """SDF volumes [B, res, res, res] at ``RESOLUTIONS[iteration]`` →
        critic scores [B]."""
        resolution = RESOLUTIONS[iteration]
        x_in = x.reshape(-1, 1, resolution, resolution, resolution)
        entry = self.optional_layers[iteration]
        h = _lrelu(F.conv3d(x_in, entry.weight[:, :1], entry.bias, stride=2, padding=1))
        if iteration > 0:
            down = from_sdf(x_in[:, :, ::2, ::2, ::2], iteration - 1)
            alpha = torch.as_tensor(fade_in_progress, dtype=h.dtype, device=h.device).clamp(0.0, 1.0)
            h = alpha * h + (1.0 - alpha) * down
        for i in range(iteration - 1, -1, -1):
            h = _lrelu(self.optional_layers[i](h))
        h = h.permute(0, 2, 3, 4, 1).reshape(h.shape[0], -1)  # channels-last, as flax
        h = _lrelu(self.head_dense1(h))
        return self.head_dense2(h).reshape(-1)


def _jax_name(name: str) -> tuple:
    """'optional_layers.2.weight' → ('optional_layers_2', 'kernel')."""
    parts = name.split(".")
    layer = "_".join(parts[:-1])
    return layer, {"weight": "kernel", "bias": "bias"}[parts[-1]]


def _to_jax_layout(value: torch.Tensor) -> torch.Tensor:
    if value.ndim == 5:
        return value.permute(2, 3, 4, 1, 0)  # OIDHW → DHWIO
    if value.ndim == 2:
        return value.t()  # [out, in] → [in, out]
    return value


def _from_jax_layout(value: torch.Tensor) -> torch.Tensor:
    if value.ndim == 5:
        return value.permute(4, 3, 0, 1, 2)  # DHWIO → OIDHW
    if value.ndim == 2:
        return value.t()
    return value


def params_to_jax(tensors: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Tensors keyed by the module's parameter names (the parameters
    themselves, or optimizer state shaped like them) as the flax parameter
    tree: ``{'optional_layers_0': {'kernel': DHWIO, 'bias': ...}, ...,
    'head_dense1': {'kernel': [in, out], ...}}``, contiguous copies."""
    tree: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, value in tensors.items():
        layer, leaf = _jax_name(name)
        tree.setdefault(layer, {})[leaf] = _to_jax_layout(value.detach()).contiguous()
    return tree


def params_from_jax(tree: Mapping[str, Mapping[str, object]], device="cpu") -> Dict[str, torch.Tensor]:
    """The flax parameter tree (numpy arrays or tensors) as float32 tensors
    keyed by the module's parameter names, in the module's layout."""
    out = {}
    for layer, leaves in tree.items():
        prefix = layer.rsplit("_", 1)
        name = f"{prefix[0]}.{prefix[1]}" if layer.startswith("optional_layers_") else layer
        for leaf, value in leaves.items():
            if not isinstance(value, torch.Tensor):
                value = torch.tensor(np.asarray(value))
            key = f"{name}.{'weight' if leaf == 'kernel' else 'bias'}"
            out[key] = _from_jax_layout(value.to(device=device, dtype=torch.float32)).contiguous()
    return out
