"""Small host helpers of the port (counterpart of the parts of
:mod:`shapegan_tpu.util` that the port uses), and the two image resizes
the JAX package takes from libraries the card's machine lacks:
:func:`resize_area`, OpenCV's ``INTER_AREA`` rule written out, and
:func:`resize_lanczos`, Pillow's ``Image.LANCZOS`` written out."""

from __future__ import annotations

import math
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


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of OpenCV's ``INTER_AREA`` along one axis.
    Shrinking: each output pixel averages the source pixels its footprint
    of ``n_in / n_out`` covers, each by the covered fraction. Enlarging:
    linear between two source pixels, with OpenCV's area coefficient ``fx =
    (i + 1) - (sx + 1) * n_out / n_in`` folded into [0, 1)."""
    scale = n_in / n_out
    weights = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        if scale >= 1.0:
            start, end = i * scale, (i + 1) * scale
            for j in range(int(math.floor(start)), min(int(math.ceil(end)), n_in)):
                weights[i, j] = (min(end, j + 1) - max(start, j)) / scale
        else:
            sx = int(math.floor(i * scale))
            fx = (i + 1) - (sx + 1) / scale
            fx = 0.0 if fx <= 0 else fx - math.floor(fx)
            if sx >= n_in - 1:
                sx, fx = n_in - 1, 0.0
            weights[i, sx] += 1.0 - fx
            if fx:
                weights[i, sx + 1] += fx
    return weights


def resize_area(image: np.ndarray, size: int) -> np.ndarray:
    """A uint8 image [H, W] or [H, W, C] resized to [size, size] with the
    weights of ``cv2.resize(..., interpolation=cv2.INTER_AREA)``, separable,
    summed in float64 and rounded to the nearest integer (halves up when
    both sides shrink by whole factors, as OpenCV's integer averages; to
    even otherwise)."""
    height, width = image.shape[:2]
    out = np.tensordot(_area_weights(height, size), image.astype(np.float64), axes=(1, 0))
    out = np.moveaxis(np.tensordot(_area_weights(width, size), out, axes=(1, 1)), 0, 1)
    whole = height % size == 0 and width % size == 0 and height >= size and width >= size
    out = np.floor(out + 0.5) if whole else np.rint(out)
    return np.clip(out, 0, 255).astype(np.uint8)


# Pillow's fixed point for 8-bit resampling: coefficients in units of 2^-22
# (``PRECISION_BITS`` of libImaging/Resample.c), sums rounded by adding half.
_PRECISION_BITS = 22


def _lanczos(x: np.ndarray) -> np.ndarray:
    """Pillow's ``lanczos_filter``: sinc(x) sinc(x / 3) on [-3, 3), with
    its sinc's order of operations (x * pi first)."""
    def sinc(v):
        v = v * math.pi
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(v == 0.0, 1.0, np.sin(v) / v)

    return np.where((x >= -3.0) & (x < 3.0), sinc(x) * sinc(x / 3.0), 0.0)


def _lanczos_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] integer weights of one axis, as float64: Pillow's
    ``precompute_coeffs`` for the Lanczos filter (window centre ``(i + 0.5)
    * scale``, support ``3 * max(scale, 1)``, weights normalised per output
    pixel), then ``normalize_coeffs_8bpc``'s rounding to units of 2^-22."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    inverse = 1.0 / filterscale
    weights = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)   # C casts truncate
        xmax = min(int(center + support + 0.5), n_in)
        row = _lanczos((np.arange(xmin, xmax) - center + 0.5) * inverse)
        total = row.sum()
        if total != 0.0:
            row = row / total
        weights[i, xmin:xmax] = row
    return np.trunc(weights * (1 << _PRECISION_BITS) + np.where(weights < 0, -0.5, 0.5))


def _lanczos_pass(image: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    """One separable pass of Pillow's 8-bit resampling along ``axis`` of a
    uint8 image: integer sums of the window's pixels times the integer
    weights, plus half, shifted down by 22 bits and clipped to uint8. The
    sums run as a float64 product, exact: every partial sum is an integer
    below 2^53."""
    n_in = image.shape[axis]
    if n_in == n_out:
        return image
    source = np.moveaxis(image, axis, 0)
    total = _lanczos_weights(n_in, n_out) @ source.reshape(n_in, -1).astype(np.float64)
    out = np.floor((total + (1 << (_PRECISION_BITS - 1))) / (1 << _PRECISION_BITS))
    out = np.clip(out, 0, 255).astype(np.uint8).reshape((n_out,) + source.shape[1:])
    return np.moveaxis(out, 0, axis)


def resize_lanczos(image: np.ndarray, size) -> np.ndarray:
    """A uint8 image [H, W] or [H, W, C] resized to ``size`` (an int for a
    square, or (height, width)) as ``PIL.Image.resize(..., Image.LANCZOS)``
    resizes it: Pillow's 8-bit algorithm (libImaging/Resample.c) written
    out, the horizontal pass first, then the vertical one, each rounded and
    clipped to uint8. One code serves shrinking and enlarging an axis."""
    height, width = (size, size) if isinstance(size, int) else size
    return _lanczos_pass(_lanczos_pass(image, width, axis=1), height, axis=0)
