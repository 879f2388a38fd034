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
hand kernel runs). There is no viewer: ``gui`` and ``nogui`` change
nothing, as in the JAX trainer.

Data-parallel under ``python -m torch.distributed.run --nproc_per_node=N``,
as the JAX trainer's mesh: ``gcd(N, B)`` ranks each take their rows of
every batch (the batches in the dataset's order, as without ranks; the
network has no BatchNorm, so no statistic crosses the ranks in the
forward); the gradients, the loss and the accuracy are averaged over the
data group before they are logged; rank 0 writes the files.
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
from shapegan_tpu_torch.parallel.mesh import (
    Mesh,
    get_mesh,
    init_from_env,
    shard_batch,
    tears_down_launch,
)
from shapegan_tpu_torch.train.common import (
    CSVLogger,
    EpochTimer,
    StepProfiler,
    average_over_data,
    effective_batch_size,
    idle_result,
)

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


def make_step(model: Classifier, opt: Adam, mesh: Optional[Mesh] = None):
    """``train_step(batch, labels)``: one update; returns the loss and the
    accuracy. Under a ``mesh`` (entered by the caller) ``batch`` and
    ``labels`` are this rank's rows; the gradients, the loss and the
    accuracy are averaged over the data group."""
    params = dict(model.named_parameters())

    def train_step(batch: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        logits = model(batch, return_logits=True)
        loss = F.cross_entropy(logits, labels.long())
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.step(average_over_data(mesh, dict(zip(params, grads))))
        accuracy = (logits.detach().argmax(dim=1) == labels).float().mean()
        return average_over_data(mesh, {"loss": loss.detach(), "accuracy": accuracy})

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


@tears_down_launch
def train(config: Optional[TrainConfig] = None) -> dict:
    """Train for ``epochs``; returns the model, its optimizer, the number of
    steps and their times."""
    config = config or parse_cli()
    device = init_from_env(resolve_device(config))
    base = config.model_dir
    volumes, labels, label_count = make_synthetic_class_dataset(config.synthetic or 64,
                                                                seed=config.seed)
    batch_size = effective_batch_size(config.batch_size or BATCH_SIZE, len(volumes))
    mesh = get_mesh(batch_size=batch_size)
    if not mesh.member:
        return idle_result(mesh)
    model = Classifier(label_count, torch.Generator().manual_seed(config.seed), device)
    opt = Adam(dict(model.named_parameters()), LEARNING_RATE)
    if config.resume:
        restore(model, opt, base)
    to_jax = functools.partial(flax_layers.to_jax, model)
    volumes = torch.tensor(volumes, device=device)
    labels = torch.tensor(labels, device=device)
    train_step = make_step(model, opt, mesh)

    logger = CSVLogger(f"{config.plot_dir}/classifier_training.csv", resume=config.resume)
    profiler = StepProfiler(device)
    steps = 0
    try:
        with mesh:
            for epoch in range(config.epochs) if config.epochs else itertools.count():
                losses, accuracies = [], []
                with EpochTimer() as timer:
                    for start in range(0, len(volumes) - batch_size + 1, batch_size):
                        rows = slice(start, start + batch_size)
                        with profiler:
                            metrics = train_step(shard_batch(mesh, volumes[rows]),
                                                 shard_batch(mesh, labels[rows]))
                        steps += 1
                        losses.append(float(metrics["loss"]))
                        accuracies.append(float(metrics["accuracy"]))
                print(f"Epoch {epoch} ({timer.duration:.1f}s): loss {np.mean(losses):.4f}, "
                      f"accuracy {np.mean(accuracies):.3f}", flush=True)
                checkpoints.save(to_jax(dict(model.named_parameters())), NAME, base=base)
                checkpoints.save(optimizer_tree(opt, to_jax), NAME + "_optimizer", base=base)
                logger.write(epoch, timer.duration, float(np.mean(losses)),
                             float(np.mean(accuracies)))
    except KeyboardInterrupt:
        pass
    finally:
        logger.close()
    return {"model": model, "opt": opt, "steps": steps, "step_s": list(profiler.times)}


if __name__ == "__main__":
    train()
