#!/usr/bin/env python3
"""Single-shape DeepSDF overfit (counterpart of the repo's
``demo_training.py``).

Samples the SDF of the example chair mesh near its surface (the C++ mesh
SDF engine; 200,000 points, clipped to +-0.1), then trains a latent-free
``SDFNet`` on it: ``torch.optim.Adam`` at 1e-4, batches of 16,384 points,
the loss ``mean |SDF - target|`` of the float32 network
(``sdf_mlp.apply_grid``, as the JAX demo's ``net.apply_grid``; no Pallas
kernel lies on its path). The batches' indices come from
``np.random.default_rng(0).integers`` in the JAX demo's calls and shapes:
headless, one ``(k, 16384)`` draw per chunk of up to 100 steps, the loss
read once a chunk; with ``show_slice`` or ``gui``, one draw a step, and
every 100th step the loss, the live viewer's mesh of the 48^3 volume
(``train.common.make_viewer``) and the ASCII slice of the 32^3 volume (the
points kernel).

    python -m shapegan_tpu_torch.demo_training [show_slice] [gui] [steps=N] [cpu]

The chair's samples are drawn from ``default_rng(seed)`` (the JAX demo's
are unseeded). Without the ``cpu`` token it runs on CUDA and fails if there
is none.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Iterator, List, Optional

import numpy as np
import torch

from shapegan_tpu_torch.core.config import parse_cli, resolve_device
from shapegan_tpu_torch.data.mesh_io import load_mesh
from shapegan_tpu_torch.data.mesh_to_sdf import sample_sdf_near_surface
from shapegan_tpu_torch.examples import example_chair_path
from shapegan_tpu_torch.models.sdf_net import SDFNet
from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.train.common import make_viewer, maybe_print_slice

SAMPLES = 200000
BATCH_SIZE = 16384
SDF_CUTOFF = 0.1
CHUNK = 100
LEARNING_RATE = 1e-4


def chair_samples(count: int, seed: int, device) -> tuple:
    """(points [count, 3], clipped SDF [count]) of the example chair, scaled
    into the unit sphere (its mesh written on ``device`` on first use)."""
    mesh = load_mesh(example_chair_path(device=device)).scaled_to_unit_sphere()
    points, sdf = sample_sdf_near_surface(mesh, count, rng=np.random.default_rng(seed))
    return points, np.clip(sdf, -SDF_CUTOFF, SDF_CUTOFF)


def index_batches(count: int, steps: int, per_step: bool) -> Iterator[np.ndarray]:
    """The index draws of the JAX demo: ``(k, 16384)`` per chunk of up to
    100 steps, or ``(16384,)`` per step."""
    rng = np.random.default_rng(0)
    if per_step:
        for _ in range(steps):
            yield rng.integers(0, count, BATCH_SIZE)
    else:
        for i in range(0, steps, CHUNK):
            yield rng.integers(0, count, (min(CHUNK, steps - i), BATCH_SIZE))


def make_step(net: SDFNet, optimizer: torch.optim.Optimizer, points: torch.Tensor,
              sdf: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """``step(idx)``: one Adam step on the points ``idx``; returns the loss
    (on the device, not synchronized)."""
    code = torch.zeros((1, 0), device=points.device)

    def step(idx: torch.Tensor) -> torch.Tensor:
        out = net.apply_grid(points[idx], code)[0]
        loss = (out - sdf[idx]).abs().mean()
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def main(argv: Optional[List[str]] = None) -> dict:
    """Sample and train; returns the losses printed, the sampling's and
    the steps' seconds (host clock, the device synchronized)."""
    config = parse_cli(argv)
    steps = int(config.extras.get("steps", 2000))
    device = resolve_device(config)

    t0 = time.perf_counter()
    points, sdf = chair_samples(SAMPLES, config.seed, device)
    points_d, sdf_d = torch.tensor(points, device=device), torch.tensor(sdf, device=device)
    sample_s = time.perf_counter() - t0

    net = SDFNet(sdf_mlp.init(torch.Generator().manual_seed(config.seed), latent_size=0,
                              device=device))
    optimizer = torch.optim.Adam(net.parameters(), lr=LEARNING_RATE)
    step = make_step(net, optimizer, points_d, sdf_d)
    code = torch.zeros(0, device=device)
    losses = []
    viewer = make_viewer(config.nogui)
    t0 = time.perf_counter()
    if viewer is None and not config.show_slice:
        done = 0
        for chunk in index_batches(len(points), steps, per_step=False):
            chunk = torch.as_tensor(chunk, device=device)
            for idx in chunk:
                loss = step(idx)
            done += len(chunk)
            losses.append(float(loss))
            print(f"step {done - 1}: loss {losses[-1]:.5f}")
    else:
        for i, idx in enumerate(index_batches(len(points), steps, per_step=True)):
            loss = step(torch.as_tensor(idx, device=device))
            if i % CHUNK == 0:
                losses.append(float(loss))
                print(f"step {i}: loss {losses[-1]:.5f}")
                if viewer is not None:
                    mesh = net.get_mesh(code, voxel_resolution=48)
                    if mesh is not None:
                        viewer.set_mesh(mesh)
                if config.show_slice:
                    maybe_print_slice(net.get_voxels(code, voxel_resolution=32), True,
                                      scale=SDF_CUTOFF)
        if viewer is not None:
            viewer.stop()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"losses": losses, "sample_s": sample_s, "train_s": time.perf_counter() - t0,
            "net": net, "viewer": viewer}


if __name__ == "__main__":
    main(sys.argv[1:])
