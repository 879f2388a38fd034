"""Voxel classifier trainer (counterpart of :mod:`shapegan_tpu.train.classifier`).

    python -m shapegan_tpu_torch.train.classifier [epochs=E] [synthetic=N] \\
        [batch_size=B] [continue] [cpu]

Semantics of the JAX trainer: labelled synthetic volumes, N a class (64 by
default), the class being the primitive (sphere, box, capsule, torus);
cross entropy on the logits with Adam (optax's rule, lr 1e-4), batch 32,
the batches in the dataset's order, the remainder dropped. Every epoch
saves the flax parameters as ``classifier`` and the Adam's state as
``classifier_optimizer`` (``0/count``, ``0/mu/Conv_0/kernel`` ...) and writes
a line ``epoch time loss accuracy`` of ``plots/classifier_training.csv``.
``continue`` restores both files and appends to the CSV; the epochs count
from 0 again (the JAX trainer's rule). The convolutions are cuDNN's (no
hand kernel runs).
"""

from __future__ import annotations

import functools
import itertools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from shapegan_tpu_torch import checkpoints
from shapegan_tpu_torch.core.config import TrainConfig, parse_cli, resolve_device
from shapegan_tpu_torch.data.synthetic import box_sdf, capsule_sdf, sphere_sdf, torus_sdf
from shapegan_tpu_torch.models import flax_layers
from shapegan_tpu_torch.models.classifier import Classifier
from shapegan_tpu_torch.ops.coords import voxel_coordinate_grid
from shapegan_tpu_torch.optim import Adam, load_optimizer_tree, optimizer_tree
from shapegan_tpu_torch.train.common import CSVLogger, EpochTimer, StepProfiler, effective_batch_size

BATCH_SIZE = 32
LEARNING_RATE = 1e-4
NAME = "classifier"


def make_synthetic_class_dataset(count_per_class: int, resolution: int = 32, seed: int = 0):
    """``(volumes [4 N, res, res, res] float32, labels [4 N] int32, 4)``:
    per class N primitives at uniform offsets in ±0.2, SDF clipped to ±0.1
    and rescaled to ±1, shuffled; equal to the JAX package's arrays for the
    same arguments."""
    primitives = [sphere_sdf, box_sdf, capsule_sdf, torus_sdf]
    grid = voxel_coordinate_grid(resolution).numpy()
    rng = np.random.default_rng(seed)
    volumes, labels = [], []
    for label, fn in enumerate(primitives):
        for _ in range(count_per_class):
            offset = rng.uniform(-0.2, 0.2, 3).astype(np.float32)
            volumes.append(np.clip(fn(grid - offset), -0.1, 0.1) / 0.1)
            labels.append(label)
    order = rng.permutation(len(volumes))
    return (np.asarray(volumes, dtype=np.float32)[order],
            np.asarray(labels, dtype=np.int32)[order], len(primitives))


def make_step(model: Classifier, opt: Adam):
    """``train_step(batch, labels)``: one update; returns the loss and the
    accuracy."""
    params = dict(model.named_parameters())

    def train_step(batch: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        logits = model(batch, return_logits=True)
        loss = F.cross_entropy(logits, labels.long())
        opt.step(dict(zip(params, torch.autograd.grad(loss, list(params.values())))))
        accuracy = (logits.detach().argmax(dim=1) == labels).float().mean()
        return {"loss": loss.detach(), "accuracy": accuracy}

    return train_step


def restore(model: Classifier, opt: Adam, base: str) -> None:
    """The parameters and the optimizer's state from their files, where
    they exist."""
    to_jax = functools.partial(flax_layers.to_jax, model)
    if checkpoints.exists(NAME, base=base):
        restored = checkpoints.load_tree(to_jax(dict(model.named_parameters())), NAME, base=base)
        flax_layers.load_variables(model, {"params": restored})
    if checkpoints.exists(NAME + "_optimizer", base=base):
        restored = checkpoints.load_tree(optimizer_tree(opt, to_jax), NAME + "_optimizer", base=base)
        load_optimizer_tree(opt, restored, functools.partial(flax_layers.from_jax, model))


def train(config: Optional[TrainConfig] = None) -> dict:
    """Train for ``epochs``; returns the model, its optimizer, the number of
    steps and their times."""
    config = config or parse_cli()
    if not config.nogui:
        raise SystemExit("the GL viewer is not ported: run without 'gui' (nogui is the default)")
    device = resolve_device(config)
    base = config.model_dir
    volumes, labels, label_count = make_synthetic_class_dataset(config.synthetic or 64,
                                                                seed=config.seed)
    batch_size = effective_batch_size(config.batch_size or BATCH_SIZE, len(volumes))
    model = Classifier(label_count, torch.Generator().manual_seed(config.seed), device)
    opt = Adam(dict(model.named_parameters()), LEARNING_RATE)
    if config.resume:
        restore(model, opt, base)
    to_jax = functools.partial(flax_layers.to_jax, model)
    volumes = torch.tensor(volumes, device=device)
    labels = torch.tensor(labels, device=device)
    train_step = make_step(model, opt)

    logger = CSVLogger(f"{config.plot_dir}/classifier_training.csv", resume=config.resume)
    profiler = StepProfiler(device)
    steps = 0
    try:
        for epoch in range(config.epochs) if config.epochs else itertools.count():
            losses, accuracies = [], []
            with EpochTimer() as timer:
                for start in range(0, len(volumes) - batch_size + 1, batch_size):
                    with profiler:
                        metrics = train_step(volumes[start:start + batch_size],
                                             labels[start:start + batch_size])
                    steps += 1
                    losses.append(float(metrics["loss"]))
                    accuracies.append(float(metrics["accuracy"]))
            print(f"Epoch {epoch} ({timer.duration:.1f}s): loss {np.mean(losses):.4f}, "
                  f"accuracy {np.mean(accuracies):.3f}", flush=True)
            checkpoints.save(to_jax(dict(model.named_parameters())), NAME, base=base)
            checkpoints.save(optimizer_tree(opt, to_jax), NAME + "_optimizer", base=base)
            logger.write(epoch, timer.duration, float(np.mean(losses)), float(np.mean(accuracies)))
    except KeyboardInterrupt:
        pass
    finally:
        logger.close()
    return {"model": model, "opt": opt, "steps": steps, "step_s": list(profiler.times)}


if __name__ == "__main__":
    train()
