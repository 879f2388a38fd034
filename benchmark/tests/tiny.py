"""Cells of BENCHMARK.json at sizes a CPU test can hold: the same files,
drivers and references, with the scale cut (resolution, batch, frame size,
the fit) and every width kept."""

from __future__ import annotations

import copy

from benchmark import harness

SIZES = {
    "hpgan64.train": ({"iteration": 0, "resolution": 8, "batch_size": 4, "dataset_shapes": 8}, {}),
    "deepsdf_chair.raymarch": (
        {"fit": {"steps": 60, "batch_size": 1024, "learning_rate": 0.001, "samples": 8192,
                 "code_std": 0.1}},
        # Frames of at most 2048 rays run unstaged: render_image's budget is
        # then the reference's primary_iterations.
        {"frame": {"resolution": 16, "iterations": 220}, "warm_frames": 1}),
    "hpgan64.generate": ({"resolution": 8}, {"batch": 2, "latent_pool": 8, "warm_requests": 1,
                                             "checked_requests": 2}),
}


def cell(name: str) -> harness.Cell:
    c = copy.deepcopy(harness.cell(name))
    config, traffic = SIZES[name]
    c.config.update(copy.deepcopy(config))
    for key, value in traffic.items():
        if isinstance(value, dict):
            c.traffic[key].update(value)
        else:
            c.traffic[key] = value
    return c
