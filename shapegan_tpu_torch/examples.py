"""Networks with a real surface, for checks that need one (counterpart of
:mod:`shapegan_tpu.examples`).

The bundled ``shapegan_tpu/examples/sdf_net.npz`` is not a trained shape:
it is about -0.02 everywhere in the unit cube, so a frame of it shows no
surface (its meshes are the boundary of the radius-1.1 sphere mask). Two
fixtures stand in:

* :func:`octahedron_params`: a full-width network built by hand whose
  output is tanh((|x| + |y| + |z| - 0.45) / sqrt(3)), for any latent code
  (no training, so the CPU tests can use it);
* :func:`fit_chair`: a full-width network fitted on the device to the
  analytic chair of :func:`example_chair_sdf`, with the float32 reference
  math (:func:`shapegan_tpu_torch.ops.sdf_mlp.apply_grid`, TF32 off), so it
  does not depend on the kernels it is used to check.

The analytic chair also has a mesh (:func:`example_chair_mesh`), written
as ``chair.obj`` by :func:`example_chair_path` into the git-ignored
``shapegan_tpu_torch/example_meshes/``.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Tuple

import numpy as np
import torch

from shapegan_tpu_torch import LATENT_CODE_SIZE, SDF_CLIPPING, checkpoints
from shapegan_tpu_torch.data.mesh_io import TriangleMesh
from shapegan_tpu_torch.data.synthetic import box_sdf
from shapegan_tpu_torch.models import LATENT_CODES_FILENAME
from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.ops.coords import _voxel_coordinates_np
from shapegan_tpu_torch.ops.mesh_extract import extract_mesh

# The chair's legs reach |p| = 1.045 in example_chair_sdf's frame; scaled by
# 0.9 the whole chair lies inside the unit bounding sphere of the raymarcher.
CHAIR_SCALE = 0.9
EXAMPLE_MESH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "example_meshes")


def example_chair_sdf(points: np.ndarray) -> np.ndarray:
    """Analytic SDF of a simple chair (seat + backrest + 4 legs) in [-1, 1]^3."""
    parts = [
        box_sdf(points, half_extents=(0.45, 0.05, 0.45), center=(0.0, -0.1, 0.0)),   # seat
        box_sdf(points, half_extents=(0.45, 0.45, 0.06), center=(0.0, 0.3, -0.39)),  # back
    ]
    for sx in (-0.38, 0.38):
        for sz in (-0.38, 0.38):
            parts.append(
                box_sdf(points, half_extents=(0.05, 0.35, 0.05), center=(sx, -0.5, sz))
            )
    return np.minimum.reduce(parts)


def example_chair_mesh(resolution: int = 64, device="cuda") -> TriangleMesh:
    """The analytic chair meshed by marching tetrahedra on ``device`` (the
    card unless the caller asks for the CPU) over [-1, 1]^3 at
    ``resolution``^3, then welded (the JAX package's ``example_chair_mesh``)."""
    points = _voxel_coordinates_np(int(resolution), 1.0, (0.0, 0.0, 0.0))
    sdf = example_chair_sdf(points).astype(np.float32).reshape((resolution,) * 3)
    vertices, faces = extract_mesh(torch.tensor(sdf, device=device),
                                   spacing=2.0 / (resolution - 1), origin=(-1.0, -1.0, -1.0))
    return TriangleMesh(vertices, faces).weld()


def example_chair_path(resolution: int = 64, device="cuda") -> str:
    """Path of ``example_meshes/chair.obj``, written by
    :func:`example_chair_mesh` on first use."""
    path = os.path.join(EXAMPLE_MESH_DIR, "chair.obj")
    if not os.path.exists(path):
        os.makedirs(EXAMPLE_MESH_DIR, exist_ok=True)
        example_chair_mesh(resolution, device).save(path)
    return path


def octahedron_params(latent_size: int = LATENT_CODE_SIZE,
                      breadth: int = sdf_mlp.SDF_NET_BREADTH) -> Dict[str, np.ndarray]:
    """Float32 parameters (the JAX package's keys and layout) of a network
    whose output is tanh((|x| + |y| + |z| - 0.45) / sqrt(3)): layer 1 splits
    x, y, z into relu(±x) ..., the trunk passes units 0-5 through, and the
    head sums them. Every latent weight is 0, so any code gives this shape."""
    params = {key: np.zeros(shape, np.float32) for key, shape in (
        ("w1p", (3, breadth)), ("w1z", (latent_size, breadth)), ("b1", (breadth,)),
        ("w5p", (3, breadth)), ("w5z", (latent_size, breadth)), ("b5", (breadth,)),
        ("w8", (breadth, 1)), ("b8", (1,)),
    )}
    for axis in range(3):
        params["w1p"][axis, 2 * axis] = 1.0
        params["w1p"][axis, 2 * axis + 1] = -1.0
    identity = np.zeros((breadth, breadth), np.float32)
    identity[np.arange(6), np.arange(6)] = 1.0
    for key in ("w2", "w3", "w4", "w5h", "w6", "w7"):
        params[key] = identity.copy()
    for key in ("b2", "b3", "b4", "b6", "b7"):
        params[key] = np.zeros(breadth, np.float32)
    params["w8"][:6, 0] = 1.0 / math.sqrt(3.0)
    params["b8"][0] = -0.45 / math.sqrt(3.0)
    return params


def chair_samples(count: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """``count`` points with their clipped (±0.1) SDF of the scaled chair:
    half uniform in the unit ball, half within 0.05 of the surface (by
    rejection from the ball), all from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)

    def ball(n):
        direction = rng.normal(size=(n, 3))
        direction /= np.linalg.norm(direction, axis=1, keepdims=True)
        return direction * rng.random((n, 1)) ** (1.0 / 3.0)

    def sdf(p):
        return example_chair_sdf(p / CHAIR_SCALE) * CHAIR_SCALE

    uniform = ball(count // 2)
    near = []
    found = 0
    while found < count - count // 2:
        candidates = ball(1 << 20)
        keep = candidates[np.abs(sdf(candidates)) < 0.05]
        near.append(keep)
        found += len(keep)
    points = np.concatenate([uniform] + near)[:count].astype(np.float32)
    target = np.clip(sdf(points), -SDF_CLIPPING, SDF_CLIPPING).astype(np.float32)
    return points, target


def fit_chair(device, steps: int = 800, batch_size: int = 16384, learning_rate: float = 1e-4,
              samples: int = 200000, seed: int = 0):
    """Fit a full-width network (8 x 256, L = 128, seeded init) to the
    scaled chair with the first bundled latent code as its fixed input:
    ``steps`` Adam steps of mean |SDF - target| over ``batch_size`` points
    drawn from :func:`chair_samples`, in float32 with TF32 off. Returns
    (params, code): float32 tensors on ``device`` and the code [L]."""
    device = torch.device(device)
    code = torch.tensor(checkpoints.load_array(
        LATENT_CODES_FILENAME, base=checkpoints.EXAMPLES_PATH)[0], device=device)
    points, target = chair_samples(samples, seed)
    points = torch.tensor(points, device=device)
    target = torch.tensor(target, device=device)
    params = {k: v.requires_grad_(True) for k, v in
              sdf_mlp.init(torch.Generator().manual_seed(seed), device=device).items()}
    optimizer = torch.optim.Adam(params.values(), lr=learning_rate)
    picks = torch.Generator(device=device).manual_seed(seed)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for _ in range(steps):
            idx = torch.randint(samples, (batch_size,), generator=picks, device=device)
            out = sdf_mlp.apply_grid(params, points[idx], code[None])[0]
            loss = (out - target[idx]).abs().mean()
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {k: v.detach() for k, v in params.items()}, code
