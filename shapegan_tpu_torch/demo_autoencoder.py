#!/usr/bin/env python3
"""Autoencoder latent interpolation (counterpart of the repo's
``demo_autoencoder.py``).

Loads a trained (V)AE (``models/autoencoder-128.npz`` with ``classic``,
else ``variational-autoencoder-128``; the bundled example when the file is
missing), encodes the dataset's volumes in the order
``np.random.default_rng(0).permutation`` gives, and morphs from each code
to the next over 30 decoded frames, in eval mode. With ``gui`` the live
viewer (``train.common.make_viewer``) shows every frame, 1/30 s apart, and
the tour runs every transition; headless runs take ``epochs=N``
transitions (all of them without it). ``show_slice`` prints the last frame
of each.

    python -m shapegan_tpu_torch.demo_autoencoder [classic] [synthetic=N] [epochs=N]
        [show_slice] [gui] [cpu]

Without the ``cpu`` token it runs on CUDA and fails if there is none.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

import numpy as np
import torch

from shapegan_tpu_torch.core.config import parse_cli, resolve_device
from shapegan_tpu_torch.models.autoencoder import Autoencoder
from shapegan_tpu_torch.train.autoencoder import create_state
from shapegan_tpu_torch.train.common import (
    load_module,
    make_viewer,
    maybe_print_slice,
    resolve_voxel_dataset,
)

TRANSITION_FRAMES = 30


def tour_order(count: int) -> np.ndarray:
    """The order the dataset's volumes are visited in."""
    return np.random.default_rng(0).permutation(count)


def load_model(classic: bool, base: str, device) -> Autoencoder:
    """The model of ``create_state`` with its checkpoint's variables."""
    model = create_state(not classic, 0, device)[0]
    load_module(model, model.checkpoint_name, base)
    return model


@torch.no_grad()
def encode(model: Autoencoder, volume) -> torch.Tensor:
    """One SDF volume [32, 32, 32] → its code [128] in eval mode."""
    x = torch.as_tensor(np.asarray(volume), dtype=torch.float32,
                        device=next(model.parameters()).device)
    return model.encode(x[None], train=False)[0]


@torch.no_grad()
def decode(model: Autoencoder, code: torch.Tensor) -> torch.Tensor:
    """One code [128] → its SDF volume [32, 32, 32] in eval mode."""
    return model.decode(code[None], train=False)[0]


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the tour; returns the order, the codes of the visited volumes
    [T + 1, 128] and the last frame of each transition [T, 32, 32, 32]."""
    config = parse_cli(argv)
    device = resolve_device(config)
    model = load_model(config.classic, config.model_dir, device)
    dataset = resolve_voxel_dataset(config, resolution=32)
    viewer = make_viewer(config.nogui)
    order = tour_order(len(dataset))
    codes = [encode(model, dataset[int(order[0])])]
    transitions = order[1:]
    if viewer is None and config.epochs:
        transitions = transitions[:config.epochs]
    last_frames = []
    for index in transitions:
        previous, target = codes[-1], encode(model, dataset[int(index)])
        for frame in range(TRANSITION_FRAMES):
            t = frame / TRANSITION_FRAMES
            voxels = decode(model, previous * (1 - t) + target * t)
            if viewer is not None:
                viewer.set_voxels(voxels)
                time.sleep(1 / 30)
        maybe_print_slice(voxels, config.show_slice)
        codes.append(target)
        last_frames.append(voxels)
    if viewer is not None:
        viewer.stop()
    return {"order": order, "codes": torch.stack(codes),
            "last_frames": torch.stack(last_frames) if last_frames else None}


if __name__ == "__main__":
    main(sys.argv[1:])
