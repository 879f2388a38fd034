#!/usr/bin/env python3
"""Bootstrap the demos' checkpoints with no dataset (counterpart of the
repo's ``make_examples.py``).

Trains small checkpoints on synthetic analytic SDF shapes, in the layouts
the demos load, with the JAX script's five stages and settings
(``quick``: a quarter of the epochs, with the same floors):

  models/generator.npz + discriminator.npz      voxel GAN (demo_gan)
  models/wgan-generator.npz + wgan-critic.npz   voxel WGAN (demo_gan wgan)
  models/sdf_net.npz + sdf_net_latent_codes.npz DeepSDF autodecoder
                                                (demo_sdf_net, demo_latent_space)
  models/autoencoder-128.npz                    classic AE (demo_autoencoder classic)
  models/classifier.npz                         classifier

then bundles the demo networks (:func:`bundle_examples`) into
``bundle_dir`` (default ``models/examples``), never into the JAX package's
``shapegan_tpu/examples/``. Every path is relative to the working
directory.

    python -m shapegan_tpu_torch.make_examples [quick] [bundle_dir=DIR] [cpu]

Without the ``cpu`` token the trainers run on CUDA and fail if there is
none.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from shapegan_tpu_torch.core.config import TrainConfig, parse_cli, resolve_device

BUNDLE_DIR = os.path.join("models", "examples")
ARTIFACTS = ("generator", "wgan-generator", "sdf_net", "sdf_net_latent_codes", "autoencoder-128")


def stage_configs(quick: bool, cpu: bool = False) -> Dict[str, TrainConfig]:
    """Each training stage's configuration, in the order they run."""
    scale = 4 if quick else 1
    return {
        "voxel GAN": TrainConfig(synthetic=32, epochs=max(2, 24 // scale), nogui=True, cpu=cpu),
        "voxel WGAN": TrainConfig(synthetic=32, epochs=max(2, 24 // scale), nogui=True, cpu=cpu),
        "SDF autodecoder": TrainConfig(synthetic=8, epochs=max(10, 120 // scale), nogui=True,
                                       cpu=cpu, extras={"pointcloud_size": 20000}),
        "autoencoder": TrainConfig(synthetic=32, classic=True, epochs=max(2, 16 // scale),
                                   nogui=True, cpu=cpu),
        "classifier": TrainConfig(synthetic=64, epochs=max(2, 12 // scale), nogui=True, cpu=cpu),
    }


def _trainers() -> dict:
    from shapegan_tpu_torch.train import autoencoder, classifier, gan, sdf_autodecoder, wgan

    return {"voxel GAN": gan, "voxel WGAN": wgan, "SDF autodecoder": sdf_autodecoder,
            "autoencoder": autoencoder, "classifier": classifier}


def bundle_examples(model_dir: str = "models", out_dir: str = BUNDLE_DIR) -> List[str]:
    """Repackage the demos' checkpoints from ``model_dir`` into ``out_dir``:
    without the optimizer's state (``opt_state/*``) and the epoch, float32
    stored as float16 except the latent-code table, compressed. Returns the
    files written."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for name in ARTIFACTS:
        out = {}
        with np.load(os.path.join(model_dir, f"{name}.npz")) as data:
            for key in data.files:
                if key.startswith("opt_state/") or key == "epoch":
                    continue
                value = data[key]
                if value.dtype == np.float32 and name != "sdf_net_latent_codes":
                    value = value.astype(np.float16)
                out[key] = value
        dst = os.path.join(out_dir, f"{name}.npz")
        np.savez_compressed(dst, **out)
        print(f"[make_examples] bundled {dst} ({os.path.getsize(dst) / 1e6:.1f} MB)")
        written.append(dst)
    return written


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Run the five stages and the bundle; returns each stage's seconds
    (host clock)."""
    config = parse_cli(argv)
    resolve_device(config)  # no card and no 'cpu': fail before any stage
    out_dir = str(config.extras.get("bundle_dir", BUNDLE_DIR))
    trainers = _trainers()
    seconds = {}
    t_all = time.perf_counter()
    for name, stage_config in stage_configs(bool(config.extras.get("quick")), config.cpu).items():
        t0 = time.perf_counter()
        trainers[name].train(stage_config)
        seconds[name] = time.perf_counter() - t0
        print(f"[make_examples] {name} done in {seconds[name]:.1f}s", flush=True)
    t0 = time.perf_counter()
    bundle_examples("models", out_dir)
    seconds["bundle examples"] = time.perf_counter() - t0
    print(f"[make_examples] all demo checkpoints ready in {time.perf_counter() - t_all:.1f}s")
    return seconds


if __name__ == "__main__":
    main(sys.argv[1:])
