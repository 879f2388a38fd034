"""The operations and bytes of the voxel GAN's convolutions (marian42/shapegan
``model/gan.py``), counted from shapes by the rules of ``counts.py``: a
multiply-add is 2 operations; each input, weight and output is read or
written once, float32 (4 bytes). The counts are those of the operation,
not of the kernels that run it today.

A convolution's forward takes 2 x batch x C_out x out^3 x C_in x k^3
operations; a transposed one 2 x batch x C_in x in^3 x C_out x k^3 (each
input voxel spread over k^3 outputs of every channel). Its backward is two
products, each of the forward's operations: the data gradient (reads the
output's gradient and the weight, writes the input's gradient) and the
weight gradient (reads the input and the output's gradient, writes the
weight's and the bias's gradients). A network's first data gradient is
left out where its input needs none: the latents, the D step's volumes.
BatchNorm, the activations, the losses and Adam are not counted."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

Work = Dict[str, Tuple[int, int]]


@dataclass(frozen=True)
class Conv:
    name: str
    c_in: int
    c_out: int
    size_in: int
    size_out: int
    kernel: int
    transposed: bool

    def flops(self, batch: int) -> int:
        """One pass (the forward, or either product of the backward)."""
        voxels = self.size_in ** 3 if self.transposed else self.size_out ** 3
        return 2 * batch * voxels * self.c_in * self.c_out * self.kernel ** 3

    def inputs(self, batch: int) -> int:
        return batch * self.c_in * self.size_in ** 3

    def outputs(self, batch: int) -> int:
        return batch * self.c_out * self.size_out ** 3

    def weights(self) -> int:
        return self.c_in * self.c_out * self.kernel ** 3


def generator_layers(cfg: dict) -> List[Conv]:
    """The generator's transposed convolutions: 1^3 to k^3 at the first
    stride (no padding), then twice the size at each stride 2."""
    g = cfg["generator"]
    layers, size = [], 1
    for i, (c_in, c_out) in enumerate(zip(g["channels"], g["channels"][1:])):
        stride, padding = (g["first_stride"], g["first_padding"]) if i == 0 else (g["stride"],
                                                                                   g["padding"])
        out = (size - 1) * stride - 2 * padding + g["kernel"]
        layers.append(Conv(f"convt{i}", c_in, c_out, size, out, g["kernel"], True))
        size = out
    return layers


def discriminator_layers(cfg: dict) -> List[Conv]:
    """The discriminator's convolutions, from the volume's resolution down
    to one score."""
    d = cfg["discriminator"]
    layers, size, count = [], cfg["resolution"], len(d["channels"]) - 1
    for i, (c_in, c_out) in enumerate(zip(d["channels"], d["channels"][1:])):
        stride, padding = (d["last_stride"], d["last_padding"]) if i == count - 1 else (
            d["stride"], d["padding"])
        out = (size + 2 * padding - d["kernel"]) // stride + 1
        layers.append(Conv(f"conv{i}", c_in, c_out, size, out, d["kernel"], False))
        size = out
    return layers


def forward(conv: Conv, batch: int) -> Tuple[int, int]:
    nbytes = 4 * (conv.inputs(batch) + conv.weights() + conv.c_out + conv.outputs(batch))
    return conv.flops(batch), nbytes


def data_gradient(conv: Conv, batch: int) -> Tuple[int, int]:
    return conv.flops(batch), 4 * (conv.outputs(batch) + conv.weights() + conv.inputs(batch))


def weight_gradient(conv: Conv, batch: int) -> Tuple[int, int]:
    nbytes = 4 * (conv.inputs(batch) + conv.outputs(batch) + conv.weights() + conv.c_out)
    return conv.flops(batch), nbytes


def _passes(work: Work, step: str, net: str, layers: List[Conv], batch: int, *, data: bool,
            first_data: bool, weight: bool) -> None:
    """Adds (flops, bytes) of the passes over ``layers`` under
    ``<step>.<net>.<layer>.<pass>``; a repeated pass adds to its key."""
    for i, conv in enumerate(layers):
        passes = [("fwd", forward)]
        if data and (i > 0 or first_data):
            passes.append(("dgrad", data_gradient))
        if weight:
            passes.append(("wgrad", weight_gradient))
        for name, count in passes:
            key = f"{step}.{net}.{conv.name}.{name}"
            flops, nbytes = count(conv, batch)
            old = work.get(key, (0, 0))
            work[key] = (old[0] + flops, old[1] + nbytes)


def g_step(cfg: dict, batch: int) -> Work:
    """The G step: the generator forward, the discriminator forward and its
    data gradient down to the fakes, the generator's data gradient (not
    into the latents) and its weight gradient."""
    work: Work = {}
    _passes(work, "g_step", "G", generator_layers(cfg), batch, data=True, first_data=False,
            weight=True)
    _passes(work, "g_step", "D", discriminator_layers(cfg), batch, data=True, first_data=True,
            weight=False)
    return work


def d_step(cfg: dict, batch: int) -> Work:
    """The D step: the generator forward for the fakes, then twice (fakes,
    real volumes) the discriminator forward with its weight gradient and
    its data gradient down to its first layer's output."""
    work: Work = {}
    _passes(work, "d_step", "G", generator_layers(cfg), batch, data=False, first_data=False,
            weight=False)
    for _ in range(2):
        _passes(work, "d_step", "D", discriminator_layers(cfg), batch, data=True,
                first_data=False, weight=True)
    return work


def batch_work(cfg: dict, batch: int) -> Work:
    """A batch's convolution passes, a G step and a D step, by key."""
    return {**g_step(cfg, batch), **d_step(cfg, batch)}


def total_flops(work: Work) -> int:
    return sum(f for f, _ in work.values())
