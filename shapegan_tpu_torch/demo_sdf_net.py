#!/usr/bin/env python3
"""Latent-space traversal frames for a trained DeepSDF autodecoder
(counterpart of the repo's ``demo_sdf_net.py``).

Picks latent codes from the trained table, interpolates a closed
Catmull-Rom path through them, and renders one frame per step into
``screenshots/sdf_net_animation/``. Mode ``mesh``: the volume at
``voxel_resolution``^3 goes through the points kernel, marching tetrahedra
extracts the mesh on the device, and the shadow-mapped C++ rasterizer draws
the frame. PNGs are written with the standard library (no Pillow).

    python -m shapegan_tpu_torch.demo_sdf_net [mode=mesh] [samples=N]
        [frames_per_transition=N] [resolution=N] [voxel_resolution=N] [cpu]

Without the ``cpu`` token it runs on CUDA and fails if there is none.
"""

from __future__ import annotations

import os
import struct
import sys
import time
import zlib
from typing import List, Optional

import numpy as np

from shapegan_tpu_torch import checkpoints
from shapegan_tpu_torch.core.config import parse_cli, resolve_device
from shapegan_tpu_torch.models import LATENT_CODES_FILENAME
from shapegan_tpu_torch.models.sdf_net import SDFNet
from shapegan_tpu_torch.render.camera import get_camera_transform
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


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an RGB uint8 image [H, W, 3] as an 8-bit truecolor PNG."""
    height, width, _ = rgb.shape
    rows = np.ascontiguousarray(rgb, dtype=np.uint8).reshape(height, width * 3)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


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
    """Render the frames not yet on disk; returns each rendered frame's
    triangle count (0 for an empty mesh)."""
    config = parse_cli(argv)
    mode = str(config.extras.get("mode", "mesh"))
    if mode == "raymarch":
        raise SystemExit("demo_sdf_net: mode=raymarch is not yet ported to "
                         "shapegan_tpu_torch (it waits for the raymarcher); use mode=mesh")
    if mode != "mesh":
        raise SystemExit(f"demo_sdf_net: unknown mode={mode!r} (expected mode=mesh)")
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
    triangle_counts = []
    t_start = time.time()
    for i, code in enumerate(path):
        frame = os.path.join(OUT_DIR, f"frame-{i:05d}.png")
        if os.path.exists(frame):
            continue
        mesh, image = render_mesh_frame(net, code.astype(np.float32), resolution,
                                        voxel_resolution)
        write_png(frame, image)
        triangle_counts.append(0 if mesh is None else len(mesh.faces))
        rate = len(triangle_counts) / max(time.time() - t_start, 1e-9)
        print(f"frame {i + 1}/{len(path)}: {triangle_counts[-1]} triangles "
              f"({rate:.2f} frames/s)")
    return triangle_counts


if __name__ == "__main__":
    main(sys.argv[1:])
