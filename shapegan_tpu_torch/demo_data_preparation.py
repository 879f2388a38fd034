#!/usr/bin/env python3
"""Visual walkthrough of the data-preparation pipeline on the example chair
(counterpart of the repo's ``demo_data_preparation.py``).

Voxelizes the chair at 8^3, 16^3 and 32^3 with the C++ mesh→SDF engine
(each resolution's ASCII slice printed), draws the occupied voxels as three
3-D scatter panels, samples 4000 uniform and 4000 near-surface SDF points
(``default_rng(0)``; blue inside, red outside) as two more, and writes
``voxels.png`` and ``points.png`` under ``screenshots/data_preparation/``,
drawn by the port's figure rasterizer (matplotlib's default 3-D view, no
panes or grid).

    python -m shapegan_tpu_torch.demo_data_preparation [cpu]

Without the ``cpu`` token it runs on CUDA (the chair's mesh is extracted
there) and fails if there is none.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

import numpy as np

from shapegan_tpu_torch.core.config import parse_cli, resolve_device
from shapegan_tpu_torch.data.mesh_io import load_mesh
from shapegan_tpu_torch.data.mesh_to_sdf import (MeshSDF, mesh_to_voxels, sample_surface_sdf,
                                                 sample_uniform_sdf)
from shapegan_tpu_torch.examples import example_chair_path
from shapegan_tpu_torch.render.figure import Figure
from shapegan_tpu_torch.util import create_text_slice, ensure_directory

OUT_DIR = os.path.join("screenshots", "data_preparation")
RESOLUTIONS = (8, 16, 32)
SAMPLES = 4000


def scatter_sdf(ax, data, title):
    """SDF samples [N, 4] as points (x, z, y), blue inside, red outside."""
    points, sdf = data[:, :3], data[:, 3]
    colors = np.where(sdf[:, None] < 0, [[0.1, 0.1, 0.9]], [[0.9, 0.1, 0.1]])
    ax.scatter(points[:, 0], points[:, 2], points[:, 1], c=colors, s=1)
    ax.set_title(title)


def main(argv: Optional[List[str]] = None) -> dict:
    """Write both figures; returns them, the voxel volumes and the two
    sample sets."""
    config = parse_cli(argv)
    device = resolve_device(config)
    ensure_directory(OUT_DIR)

    mesh = load_mesh(example_chair_path(device=device))
    print(f"example mesh: {mesh}")

    voxels_figure = Figure((12, 4), 100)
    volumes = []
    for i, res in enumerate(RESOLUTIONS):
        voxels = mesh_to_voxels(mesh, voxel_resolution=res)
        volumes.append(voxels)
        print(f"\nvoxels at {res}^3:")
        print(create_text_slice(np.clip(voxels / 0.1, -1, 1)))
        ax = voxels_figure.add_subplot_3d(1, 3, i + 1)
        occupied = np.argwhere(voxels < 0)
        ax.scatter(occupied[:, 0], occupied[:, 2], occupied[:, 1], s=2)
        ax.set_title(f"occupied voxels {res}^3")
    voxels_figure.savefig(os.path.join(OUT_DIR, "voxels.png"), tight=False)

    unit = mesh.scaled_to_unit_sphere()
    oracle = MeshSDF(unit)
    uniform = sample_uniform_sdf(unit, SAMPLES, rng=np.random.default_rng(0), oracle=oracle)
    surface = sample_surface_sdf(unit, SAMPLES, rng=np.random.default_rng(0), oracle=oracle, seed=0)
    points_figure = Figure((10, 5), 100)
    scatter_sdf(points_figure.add_subplot_3d(1, 2, 1), uniform, "uniform samples")
    scatter_sdf(points_figure.add_subplot_3d(1, 2, 2), surface, "near-surface samples")
    points_figure.savefig(os.path.join(OUT_DIR, "points.png"), tight=False)
    print(f"figures saved under {OUT_DIR}/")
    return {"voxels_figure": voxels_figure, "points_figure": points_figure, "volumes": volumes,
            "uniform": uniform, "surface": surface}


if __name__ == "__main__":
    main(sys.argv[1:])
