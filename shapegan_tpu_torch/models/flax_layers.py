"""Flax's BatchNorm and flax's parameter layout for the port's conv networks
(the voxel GAN's ``Generator``, the (V)AE, the classifier).

:class:`BatchNorm` is ``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5,
use_fast_variance=False)``: in train mode it normalizes with the batch's
mean and biased variance and, where the caller keeps the update, moves its
running statistics by ``stat <- 0.9 stat + 0.1 batch_stat`` with the
**biased** variance (``torch.nn.BatchNorm*d`` stores the unbiased one); in
eval mode it normalizes with the stored statistics. Under a mesh of ranks
with a data axis (``with mesh:``) the batch statistics are the global
batch's, summed over the data group, as in the JAX package's sharded step.
Its tensors carry
flax's names: the parameters ``scale`` and ``bias``, the buffers ``mean``
and ``var`` (flax's ``batch_stats`` collection).

:func:`to_jax` / :func:`from_jax` convert tensors keyed by a module's own
names (its parameters and buffers, or optimizer state shaped like them) to
and from flax's tree ``{layer: {leaf: value}}``: a torch path ``enc_convs.0``
is flax's auto name ``enc_convs_0``, ``weight`` is ``kernel``; a ``Conv3d``
weight ``OIDHW`` is ``DHWIO``, a ``Linear`` weight ``[out, in]`` is
``[in, out]``, and a ``ConvTranspose3d`` weight ``(I, O, D, H, W)`` is flax's
``ConvTranspose`` kernel ``(D, H, W, I, O)`` **flipped on all three spatial
axes** (flax's ``transpose_kernel=False`` convolves the dilated input with
the kernel as stored, torch with it flipped; flax's ``SAME`` at stride 2 and
kernel 4 is torch's ``padding=1``, ``VALID`` at stride 1 its ``padding=0``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from shapegan_tpu_torch.models.progressive_gan import _from_jax_layout, _to_jax_layout
from shapegan_tpu_torch.parallel.mesh import ambient_mesh, sum_over_data

MOMENTUM = 0.9
EPSILON = 1e-5

Tree = Dict[str, Dict[str, torch.Tensor]]


class BatchNorm(nn.Module):
    """Flax's BatchNorm over the channel axis (dim 1) of ``[B, C, ...]``."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = True) -> torch.Tensor:
        """Batch statistics when ``train`` (stored into the running ones
        unless ``update_stats`` is False), the running statistics
        otherwise."""
        if not train:
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias, training=False,
                                eps=EPSILON)
        mesh = ambient_mesh()
        if mesh is not None and mesh.data_group is not None:
            return self._global_batch(x, mesh, update_stats)
        if update_stats:
            with torch.no_grad():
                dims = [0, *range(2, x.ndim)]
                var, mean = torch.var_mean(x, dim=dims, correction=0)
                self.mean.mul_(MOMENTUM).add_(mean, alpha=1.0 - MOMENTUM)
                self.var.mul_(MOMENTUM).add_(var, alpha=1.0 - MOMENTUM)
        return F.batch_norm(x, None, None, self.scale, self.bias, training=True, eps=EPSILON)

    def _global_batch(self, x: torch.Tensor, mesh, update_stats: bool) -> torch.Tensor:
        """Train mode over a data mesh: the statistics of the global batch
        (each rank holds its rows), as XLA's partitioning of the JAX step
        computes them; mean, then the biased variance about it, each summed
        over the data group by an all-reduce that carries gradients."""
        dims = [0, *range(2, x.ndim)]
        shape = [1, -1] + [1] * (x.ndim - 2)
        count = x.numel() // x.shape[1] * mesh.shape["data"]
        mean = sum_over_data(mesh, x.sum(dims)) / count
        centered = x - mean.reshape(shape)
        var = sum_over_data(mesh, (centered * centered).sum(dims)) / count
        if update_stats:
            with torch.no_grad():
                self.mean.mul_(MOMENTUM).add_(mean, alpha=1.0 - MOMENTUM)
                self.var.mul_(MOMENTUM).add_(var, alpha=1.0 - MOMENTUM)
        scale = torch.rsqrt(var + EPSILON) * self.scale
        return centered * scale.reshape(shape) + self.bias.reshape(shape)


def _layout_to_jax(layer: nn.Module, leaf: str, value: torch.Tensor) -> torch.Tensor:
    if leaf == "weight" and isinstance(layer, nn.ConvTranspose3d):
        return value.flip((2, 3, 4)).permute(2, 3, 4, 0, 1)  # (I,O,D,H,W) -> flipped DHWIO
    return _to_jax_layout(value)  # OIDHW -> DHWIO, [out, in] -> [in, out]


def _layout_from_jax(layer: nn.Module, leaf: str, value: torch.Tensor) -> torch.Tensor:
    if leaf == "weight" and isinstance(layer, nn.ConvTranspose3d):
        return value.permute(3, 4, 0, 1, 2).flip((2, 3, 4))
    return _from_jax_layout(value)


def to_jax(module: nn.Module, tensors: Mapping[str, torch.Tensor]) -> Tree:
    """Tensors keyed by ``module``'s parameter or buffer names as flax's
    tree, contiguous copies in flax's layouts."""
    tree: Tree = {}
    for name, value in tensors.items():
        path, leaf = name.rsplit(".", 1)
        value = _layout_to_jax(module.get_submodule(path), leaf, value.detach())
        tree.setdefault(path.replace(".", "_"), {})["kernel" if leaf == "weight" else leaf] = \
            value.contiguous()
    return tree


def from_jax(module: nn.Module, tree: Mapping[str, Mapping[str, object]], device=None
             ) -> Dict[str, torch.Tensor]:
    """Flax's tree (numpy arrays or tensors) as float32 tensors keyed by
    ``module``'s names, in its layouts, on ``device`` (the module's if none
    is given)."""
    paths = {name.rsplit(".", 1)[0].replace(".", "_"): name.rsplit(".", 1)[0]
             for name in module.state_dict()}
    if device is None:
        device = next(module.parameters()).device
    out = {}
    for layer, leaves in tree.items():
        path = paths[layer]
        for leaf, value in leaves.items():
            if not isinstance(value, torch.Tensor):
                value = torch.tensor(np.asarray(value))
            leaf = "weight" if leaf == "kernel" else leaf
            value = value.to(device=device, dtype=torch.float32)
            out[f"{path}.{leaf}"] = _layout_from_jax(module.get_submodule(path), leaf,
                                                     value).contiguous()
    return out


def variables_to_jax(module: nn.Module) -> Dict[str, Tree]:
    """``module``'s flax variables: ``{"params": ...}``, and
    ``"batch_stats"`` when it has BatchNorm layers."""
    variables = {"params": to_jax(module, dict(module.named_parameters()))}
    buffers = dict(module.named_buffers())
    if buffers:
        variables["batch_stats"] = to_jax(module, buffers)
    return variables


def load_variables(module: nn.Module, variables: Mapping[str, Mapping]) -> None:
    """Copy flax variables (``params`` and, if the module has any,
    ``batch_stats``) into ``module`` in place; every tensor of the module
    must be given."""
    state = {}
    for collection in ("params", "batch_stats"):
        if collection in variables:
            state.update(from_jax(module, variables[collection]))
    module.load_state_dict(state, strict=True)
