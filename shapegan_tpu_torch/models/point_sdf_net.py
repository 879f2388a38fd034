"""Point-set SDF GAN networks (counterpart of
:mod:`shapegan_tpu.models.point_sdf_net`).

* :class:`PointNet` — the critic over (pos, sdf) point sets: a per-point MLP
  4→64→128→256→512, a max pool over the points (masked points excluded, or
  a segment max over a ragged ``batch`` vector), then 512→256→128→out.
* :class:`SDFGenerator` — the batched implicit generator ([B, N, 3] + z →
  [B, N, 1]): LayerNorm and relu after every hidden layer, the positions
  concatenated back in at layer n/2, the latent added through ``z_lin1`` at
  layer 0 and ``z_lin2`` at layer n/2, a raw head.

Both have a compute ``dtype``: parameters stay float32, each product takes
its inputs and weights cast to the dtype, and the outputs come back float32.
The rounding points are flax's (the JAX package runs these modules through
``flax.linen``): a Dense rounds its product to the dtype, then adds the
bias in the dtype; LayerNorm takes float32 statistics with flax's fast
variance E[x²] - E[x]² clipped at 0 and eps 1e-6 (torch's ``nn.LayerNorm``
uses 1e-5 and the two-pass variance, so it is written out here), and casts
its result back to the dtype.

Parameter names are the flax ones (``Dense_0`` … ``Dense_6``; ``z_lin1``,
``z_lin2``, ``lin0`` … ``lin7``, ``norm0`` … ``norm6`` with ``scale`` and
``bias``), so :func:`params_to_jax` / :func:`params_from_jax` only transpose
the Dense kernels (flax ``[in, out]``, torch ``[out, in]``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from shapegan_tpu_torch.models import torch_uniform_init_

LN_EPS = 1e-6  # flax.linen.LayerNorm's default


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: the product rounded to ``dtype``, then
    the bias added in ``dtype``."""
    return x.to(dtype) @ layer.weight.to(dtype).t() + layer.bias.to(dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: float32 statistics (fast
    variance, clipped at 0), ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias`` in float32, cast back to the input's dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + LN_EPS) * self.scale) + self.bias
        return y.to(x.dtype)


class PointNet(nn.Module):
    """(pos, sdf) point-set critic; ``out_channels=1`` for the WGAN critic."""

    HIDDEN = (64, 128, 256, 512, 256, 128)

    def __init__(self, out_channels: int = 1, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        """Weights and biases from U(±1/sqrt(fan_in)) drawn with ``generator``
        (seed 0 if none is given), then moved to ``device``."""
        super().__init__()
        self.dtype = dtype
        generator = generator or torch.Generator().manual_seed(0)
        widths = (4,) + self.HIDDEN + (out_channels,)
        for i in range(len(widths) - 1):
            layer = nn.Linear(widths[i], widths[i + 1])
            torch_uniform_init_(layer, generator)
            self.add_module(f"Dense_{i}", layer)
        if device is not None:
            self.to(device)

    def _dense(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return dense(x, getattr(self, f"Dense_{i}"), self.dtype)

    def forward(self, pos: torch.Tensor, dist: torch.Tensor, batch: Optional[torch.Tensor] = None,
                num_segments: Optional[int] = None, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """pos [..., N, 3], dist [..., N] or [..., N, 1] → float32 scores
        [..., out]. ``batch`` [N] with ``num_segments`` pools flat ragged
        point sets by a segment max (empty segments give -inf features, as
        ``jax.ops.segment_max``); ``mask`` [..., N] leaves points out of the
        max pool instead."""
        if dist.shape[-1] != 1:
            dist = dist[..., None]
        x = torch.cat([pos, dist], dim=-1)
        for i in range(3):
            x = torch.relu(self._dense(i, x))
        x = self._dense(3, x)
        if batch is None:
            if mask is not None:
                x = torch.where(mask[..., None], x, float("-inf"))
            x = x.amax(dim=-2)
        else:
            if num_segments is None:
                raise ValueError("num_segments must be given with a batch vector")
            pooled = x.new_full((num_segments, x.shape[-1]), float("-inf"))
            x = pooled.scatter_reduce(0, batch[:, None].expand_as(x), x, "amax", include_self=True)
        for i in (4, 5):
            x = torch.relu(self._dense(i, x))
        return self._dense(6, x).float()


class SDFGenerator(nn.Module):
    """Batched implicit SDF generator: (pos [B, N, 3], z [B, L]) → [B, N, 1]."""

    def __init__(self, latent_channels: int = 128, hidden_channels: int = 256, num_layers: int = 8,
                 norm: bool = True, dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        """Weights and biases from U(±1/sqrt(fan_in)) drawn with ``generator``
        (seed 0 if none is given; ``z_lin1``, ``z_lin2``, then ``lin0`` …),
        LayerNorm scales 1 and biases 0, then moved to ``device``."""
        super().__init__()
        if num_layers % 2:
            raise ValueError(f"num_layers must be even, got {num_layers}")
        self.latent_channels = latent_channels
        self.hidden_channels = hidden_channels
        self.num_layers = num_layers
        self.norm = norm
        self.dropout = dropout
        self.dtype = dtype
        generator = generator or torch.Generator().manual_seed(0)
        for name in ("z_lin1", "z_lin2"):
            layer = nn.Linear(latent_channels, hidden_channels)
            torch_uniform_init_(layer, generator)
            self.add_module(name, layer)
        half = num_layers // 2
        fan_in = 3
        for i in range(num_layers):
            if i == half:
                fan_in += 3
            out = 1 if i == num_layers - 1 else hidden_channels
            layer = nn.Linear(fan_in, out)
            torch_uniform_init_(layer, generator)
            self.add_module(f"lin{i}", layer)
            fan_in = out
            if norm and i < num_layers - 1:
                self.add_module(f"norm{i}", LayerNorm(hidden_channels))
        if device is not None:
            self.to(device)

    def forward(self, pos: torch.Tensor, z: torch.Tensor, *, dtype: Optional[torch.dtype] = None,
                train: bool = False, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """pos [B, N, 3] (or [N, 3]), z [B, L] (or [L]) → float32 [B, N, 1].
        ``dtype`` overrides the module's compute dtype for this call (the
        trainer's G step runs the same parameters in float32). With
        ``train`` and ``dropout > 0``, dropout after each hidden relu draws
        from ``generator``."""
        dtype = dtype or self.dtype
        if pos.ndim == 2:
            pos = pos[None]
        if z.ndim == 1:
            z = z[None]
        if pos.shape[-1] != 3 or z.shape[-1] != self.latent_channels or pos.shape[0] != z.shape[0]:
            raise ValueError(f"pos {tuple(pos.shape)} and z {tuple(z.shape)} do not fit the generator")
        half = self.num_layers // 2
        z1 = dense(z, self.z_lin1, dtype)
        z2 = dense(z, self.z_lin2, dtype)
        pos = pos.to(dtype)
        x = pos
        for i in range(self.num_layers):
            if i == half:
                x = torch.cat([x, pos], dim=-1)
            x = dense(x, getattr(self, f"lin{i}"), dtype)
            if i == 0:
                x = x + z1[:, None, :]
            if i == half:
                x = x + z2[:, None, :]
            if i < self.num_layers - 1:
                if self.norm:
                    x = getattr(self, f"norm{i}")(x)
                x = torch.relu(x)
                if self.dropout > 0.0 and train:
                    keep = torch.rand(x.shape, generator=generator, device=x.device) >= self.dropout
                    x = torch.where(keep, x / (1.0 - self.dropout), 0.0)
        return x.float()


def _to_jax_leaf(name: str, value: torch.Tensor):
    layer, leaf = name.rsplit(".", 1)
    if leaf == "weight":
        return layer, "kernel", value.t()
    return layer, leaf, value


def params_to_jax(tensors: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Tensors keyed by a :class:`PointNet`'s or :class:`SDFGenerator`'s
    parameter names (the parameters, or optimizer state shaped like them) as
    the flax parameter tree (``{'lin0': {'kernel': [in, out], 'bias': ...},
    'norm0': {'scale': ..., 'bias': ...}, ...}``), contiguous copies."""
    tree: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, value in tensors.items():
        layer, leaf, value = _to_jax_leaf(name, value.detach())
        tree.setdefault(layer, {})[leaf] = value.contiguous()
    return tree


def params_from_jax(tree: Mapping[str, Mapping[str, object]], device="cpu") -> Dict[str, torch.Tensor]:
    """The flax parameter tree (numpy arrays or tensors) of either module as
    float32 tensors keyed by the module's parameter names, in its layout
    (``load_state_dict`` takes them)."""
    out = {}
    for layer, leaves in tree.items():
        for leaf, value in leaves.items():
            if not isinstance(value, torch.Tensor):
                value = torch.tensor(np.asarray(value))
            value = value.to(device=device, dtype=torch.float32)
            if leaf == "kernel":
                leaf, value = "weight", value.t()
            out[f"{layer}.{leaf}"] = value.contiguous()
    return out
