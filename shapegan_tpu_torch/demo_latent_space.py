#!/usr/bin/env python3
"""Latent-space tour of a trained DeepSDF autodecoder (counterpart of the
repo's ``demo_latent_space.py``).

Embeds the latent table in 2-D by exact t-SNE (perplexity ``min(30,
max(2, (N - 1) / 3))``) and clusters it by k-means
(:mod:`shapegan_tpu_torch.embedding`, in torch on the device), orders the
cluster centres into a greedy nearest-neighbour tour, splines a closed
Catmull-Rom path through them, and writes one frame per path step into
``screenshots/latent_space_tour/``: the raymarched render of the step's
code (ssaa 1, at most 400 iterations) on the left, the embedding's scatter
panel (:class:`shapegan_tpu_torch.render.panel.ScatterPanel`, no text) with
a cross at the table's nearest code on the right. Frames already on disk
are skipped.

    python -m shapegan_tpu_torch.demo_latent_space [clusters=N] [frames_per_transition=N]
        [resolution=N] [cpu]

Without the ``cpu`` token it runs on CUDA and fails if there is none.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

import numpy as np

from shapegan_tpu_torch import checkpoints
from shapegan_tpu_torch.core.config import parse_cli, resolve_device
from shapegan_tpu_torch.demo_sdf_net import catmull_rom
from shapegan_tpu_torch.embedding import kmeans, tsne
from shapegan_tpu_torch.models import LATENT_CODES_FILENAME
from shapegan_tpu_torch.models.sdf_net import SDFNet
from shapegan_tpu_torch.render.panel import ScatterPanel
from shapegan_tpu_torch.render.png import write_png
from shapegan_tpu_torch.render.raymarching import render_image

OUT_DIR = os.path.join("screenshots", "latent_space_tour")


def greedy_tour(centres: np.ndarray) -> List[int]:
    """Visit order of the centres: from centre 0, always the nearest one not
    yet visited (ties to the lowest index)."""
    order = [0]
    remaining = set(range(1, len(centres)))
    while remaining:
        last = centres[order[-1]]
        nearest = min(sorted(remaining), key=lambda i: np.linalg.norm(centres[i] - last))
        order.append(nearest)
        remaining.discard(nearest)
    return order


def cursor(codes: np.ndarray, embedded: np.ndarray, code: np.ndarray) -> np.ndarray:
    """The 2-D position of the table's code nearest to ``code``."""
    return embedded[np.argmin(np.linalg.norm(codes - code, axis=1))]


def main(argv: Optional[List[str]] = None) -> dict:
    """Write the frames not yet on disk; returns the path [F, L], the
    embedding, the cluster labels and, for each frame written, its share
    of render pixels that are not background."""
    config = parse_cli(argv)
    clusters = int(config.extras.get("clusters", 10))
    frames_per_transition = int(config.extras.get("frames_per_transition", 30))
    resolution = int(config.extras.get("resolution", 400))

    device = resolve_device(config)
    net = SDFNet(checkpoints.load("sdf_net", base=config.model_dir, device=device))
    codes = checkpoints.load_array(LATENT_CODES_FILENAME, base=config.model_dir)

    print("computing t-SNE embedding...")
    perplexity = min(30.0, max(2.0, (len(codes) - 1) / 3))
    embedded, _ = tsne(codes, perplexity, device=device)
    centres, labels, _ = kmeans(codes, min(clusters, len(codes)), seed=config.seed, device=device)
    path = catmull_rom(centres[greedy_tour(centres)], frames_per_transition)
    panel = ScatterPanel(embedded, labels, resolution)

    os.makedirs(OUT_DIR, exist_ok=True)
    coverage = []
    for i, code in enumerate(path):
        filename = os.path.join(OUT_DIR, f"frame-{i:05d}.png")
        if os.path.exists(filename):
            continue
        code = code.astype(np.float32)
        image = render_image(net, code, resolution=resolution, ssaa=1, iterations=400)
        write_png(filename, np.concatenate([image, panel.with_cursor(cursor(codes, embedded, code))],
                                           axis=1))
        coverage.append(float((image != 255).any(axis=2).mean()))
        print(f"frame {i + 1}/{len(path)}")
    return {"path": path, "embedded": embedded, "labels": labels, "coverage": coverage}


if __name__ == "__main__":
    main(sys.argv[1:])
