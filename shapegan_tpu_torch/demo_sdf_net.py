#!/usr/bin/env python3
"""Latent-space traversal frames for a trained DeepSDF autodecoder
(counterpart of the repo's ``demo_sdf_net.py``).

Picks latent codes from the trained table, interpolates a closed
Catmull-Rom path through them, and renders one frame per step into
``screenshots/sdf_net_animation/``. Mode ``mesh``: the volume at
``voxel_resolution``^3 goes through the points kernel, marching tetrahedra
extracts the mesh on the device, and the shadow-mapped C++ rasterizer draws
the frame. Mode ``raymarch``: the sphere-traced frame of
:func:`shapegan_tpu_torch.render.raymarching.render_image` (ssaa 2, at
most 1000 iterations), frames in turn. PNGs are written with the standard
library (no Pillow).

    python -m shapegan_tpu_torch.demo_sdf_net [mode=mesh|raymarch] [samples=N]
        [frames_per_transition=N] [resolution=N] [voxel_resolution=N] [cpu]

Without the ``cpu`` token it runs on CUDA and fails if there is none.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

import numpy as np

from shapegan_tpu_torch import checkpoints
from shapegan_tpu_torch.core.config import parse_cli, resolve_device
from shapegan_tpu_torch.models import LATENT_CODES_FILENAME
from shapegan_tpu_torch.models.sdf_net import SDFNet
from shapegan_tpu_torch.render.camera import get_camera_transform
from shapegan_tpu_torch.render.png import write_png
from shapegan_tpu_torch.render.raymarching import render_image
from shapegan_tpu_torch.render.software import render_scene

OUT_DIR = os.path.join("screenshots", "sdf_net_animation")


def catmull_rom(points: np.ndarray, steps: int) -> np.ndarray:
    """Smooth closed spline through control points [N, D] with ``steps``
    samples per segment."""
    n = len(points)
    out = []
    for i in range(n):
        p0, p1, p2, p3 = (points[(i + k - 1) % n] for k in range(4))
        for s in range(steps):
            t = s / steps
            out.append(
                0.5
                * (
                    2 * p1
                    + (-p0 + p2) * t
                    + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t**2
                    + (-p0 + 3 * p1 - 3 * p2 + p3) * t**3
                )
            )
    return np.asarray(out)


def render_mesh(mesh, resolution: int) -> np.ndarray:
    """The rasterized RGB image of ``mesh`` (background only if None), with
    the reference viewer's fixed camera, light, and a floor just under the
    model."""
    if mesh is None:  # empty iso-surface: background-only frame
        return np.full((resolution, resolution, 3), 255, np.uint8)
    tri = mesh.triangles.reshape(-1, 3).astype(np.float32)
    normals = np.repeat(mesh.face_normals, 3, axis=0).astype(np.float32)
    return render_scene(
        tri, normals,
        get_camera_transform(2.2, 147, 20, project=True),
        get_camera_transform(6.0, 164, 50, project=True),
        size=resolution, ground_level=float(tri[:, 1].min()),
    )


def render_mesh_frame(net: SDFNet, code: np.ndarray, resolution: int,
                      voxel_resolution: int):
    """One frame: the mesh of ``code`` (None if its iso-surface is empty)
    and its rasterized RGB image."""
    mesh = net.get_mesh(code, voxel_resolution=voxel_resolution)
    return mesh, render_mesh(mesh, resolution)


def main(argv: Optional[List[str]] = None) -> List[int]:
    """Render the frames not yet on disk; returns, for each rendered frame,
    its triangle count (mode ``mesh``, 0 for an empty mesh) or its number
    of pixels that are not white background (mode ``raymarch``)."""
    config = parse_cli(argv)
    mode = str(config.extras.get("mode", "mesh"))
    if mode not in ("mesh", "raymarch"):
        raise SystemExit(f"demo_sdf_net: unknown mode={mode!r} (expected mesh or raymarch)")
    sample_count = int(config.extras.get("samples", 30))
    frames_per_transition = int(config.extras.get("frames_per_transition", 60))
    resolution = int(config.extras.get("resolution", 800))
    voxel_resolution = int(config.extras.get("voxel_resolution", 128))

    device = resolve_device(config)
    net = SDFNet(checkpoints.load("sdf_net", base=config.model_dir, device=device))
    codes = checkpoints.load_array(LATENT_CODES_FILENAME, base=config.model_dir)

    rng = np.random.default_rng(config.seed)
    keys = codes[rng.choice(len(codes), min(sample_count, len(codes)), replace=False)]
    path = catmull_rom(keys, frames_per_transition)

    os.makedirs(OUT_DIR, exist_ok=True)
    counts = []
    t_start = time.time()
    for i, code in enumerate(path):
        frame = os.path.join(OUT_DIR, f"frame-{i:05d}.png")
        if os.path.exists(frame):
            continue
        code = code.astype(np.float32)
        if mode == "mesh":
            mesh, image = render_mesh_frame(net, code, resolution, voxel_resolution)
            counts.append(0 if mesh is None else len(mesh.faces))
            what = "triangles"
        else:
            image = render_image(net, code, resolution=resolution)
            counts.append(int((image != 255).any(axis=2).sum()))
            what = "non-background pixels"
        write_png(frame, image)
        rate = len(counts) / max(time.time() - t_start, 1e-9)
        print(f"frame {i + 1}/{len(path)}: {counts[-1]} {what} ({rate:.2f} frames/s)")
    return counts


if __name__ == "__main__":
    main(sys.argv[1:])
