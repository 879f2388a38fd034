#!/usr/bin/env python3
"""Voxel GAN latent-space interpolation (counterpart of the repo's
``demo_gan.py``).

Loads a trained voxel-GAN generator (``models/generator.npz``, or
``wgan-generator`` with ``wgan``; the bundled example when the file is
missing), walks a straight line between random latent codes (a new target
every 40 frames, the codes drawn from ``np.random.default_rng(0)`` exactly
as the JAX demo draws them) and decodes each frame's code with the
generator in eval mode (flax's running statistics). With ``gui`` the live
viewer (``train.common.make_viewer``) shows every frame, 1/30 s apart;
headless, ``show_slice`` prints a frame's ASCII slice every 40 frames.

    python -m shapegan_tpu_torch.demo_gan [wgan] [frames=N] [show_slice] [gui] [cpu]

Without the ``cpu`` token it runs on CUDA and fails if there is none.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

import numpy as np
import torch

from shapegan_tpu_torch import LATENT_CODE_SIZE
from shapegan_tpu_torch.core.config import parse_cli, resolve_device
from shapegan_tpu_torch.models.gan import Generator
from shapegan_tpu_torch.train.common import load_module, make_viewer, maybe_print_slice
from shapegan_tpu_torch.train.gan import create_states

TRANSITION_FRAMES = 40


def code_sequence(frames: int) -> np.ndarray:
    """The demo's latent codes [frames, 128] float32: a straight line from
    the previous code to the target, a new target every 40 frames."""
    rng = np.random.default_rng(0)
    previous = rng.normal(size=LATENT_CODE_SIZE).astype(np.float32)
    target = rng.normal(size=LATENT_CODE_SIZE).astype(np.float32)
    codes = np.zeros((frames, LATENT_CODE_SIZE), np.float32)
    for frame in range(frames):
        t = (frame % TRANSITION_FRAMES) / TRANSITION_FRAMES
        if frame > 0 and frame % TRANSITION_FRAMES == 0:
            previous, target = target, rng.normal(size=LATENT_CODE_SIZE).astype(np.float32)
        codes[frame] = previous * np.float32(1 - t) + target * np.float32(t)
    return codes


def load_generator(name: str, base: str, device) -> Generator:
    """The generator of ``create_states`` with the checkpoint ``name``'s
    variables."""
    generator = create_states(0, device)[0]
    load_module(generator, name, base)
    return generator


@torch.no_grad()
def decode(generator: Generator, code) -> torch.Tensor:
    """One code [128] → its SDF volume [32, 32, 32] in eval mode."""
    z = torch.as_tensor(code, dtype=torch.float32, device=next(generator.parameters()).device)
    return generator(z[None, :], train=False)[0]


def main(argv: Optional[List[str]] = None) -> dict:
    """Decode every frame; returns the codes [frames, 128] and the volumes
    [frames, 32, 32, 32] on the device."""
    config = parse_cli(argv)
    name = "wgan-generator" if config.extras.get("wgan") else "generator"
    frames = int(config.extras.get("frames", 200))
    device = resolve_device(config)
    generator = load_generator(name, config.model_dir, device)
    codes = code_sequence(frames)
    viewer = make_viewer(config.nogui)
    volumes = []
    for frame, code in enumerate(codes):
        volumes.append(decode(generator, code))
        if viewer is not None:
            viewer.set_voxels(volumes[-1])
            time.sleep(1 / 30)
        elif frame % TRANSITION_FRAMES == 0:
            maybe_print_slice(volumes[-1], config.show_slice)
    if viewer is not None:
        viewer.stop()
    return {"codes": codes, "volumes": torch.stack(volumes) if volumes else None}


if __name__ == "__main__":
    main(sys.argv[1:])
