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


def crop_image(image: np.ndarray, background=255) -> np.ndarray:
    """Crop an image to a square around its non-background content (only
    when that square is wider than 200 pixels), clamped to the image."""
    mask = image[:, :] != background
    if mask.ndim == 3:
        mask = mask.any(axis=-1)
    coords = np.array(np.nonzero(mask))

    if coords.size != 0:
        top_left = np.min(coords, axis=1)
        bottom_right = np.max(coords, axis=1)
    else:
        top_left = np.array((0, 0))
        bottom_right = np.array(image.shape[:2])
        print("Warning: Image contains only background pixels.")

    half_size = int(max(bottom_right[0] - top_left[0], bottom_right[1] - top_left[1]) / 2)
    center = ((top_left + bottom_right) / 2).astype(int)
    center = (
        min(max(half_size, center[0]), image.shape[0] - half_size),
        min(max(half_size, center[1]), image.shape[1] - half_size),
    )
    if half_size > 100:
        image = image[
            center[0] - half_size : center[0] + half_size,
            center[1] - half_size : center[1] + half_size,
        ]
    return image
