"""Small host helpers of the port (counterpart of the parts of
:mod:`shapegan_tpu.util` that the port uses)."""

from __future__ import annotations

import os

import numpy as np

CHARACTERS = "      `.-:/+osyhdmm###############"


def ensure_directory(directory: str) -> None:
    os.makedirs(directory, exist_ok=True)


def create_text_slice(voxels) -> str:
    """ASCII-art density slice of a voxel SDF volume [res, res, res]: the
    x-slice at ``res // 4``, SDF in [-1, 1] mapped onto a density ramp, rows
    thinned by a factor of 2.2 (terminal aspect), drawn bottom-up."""
    voxels = np.asarray(voxels)
    resolution = voxels.shape[-1]
    center = voxels.shape[-1] // 4
    data = voxels[center, :, :]
    data = np.clip(data * -0.5 + 0.5, 0.0, 1.0) * (len(CHARACTERS) - 1)
    data = data.astype(np.int32)
    lines = ["|" + "".join(CHARACTERS[i] for i in line) + "|" for line in data]
    rows = []
    for i in range(resolution):
        if len(rows) < i / 2.2:
            rows.append(lines[i])
    frame = "+" + "—" * resolution + "+\n"
    return frame + "\n".join(reversed(rows)) + "\n" + frame
