"""Point-set SDF GAN trainer (counterpart of :mod:`shapegan_tpu.train.point_gan`).

    python -m shapegan_tpu_torch.train.point_gan [cpu] [synthetic=N] [epochs=E] \\
        [category=C] [continue]

Semantics of the JAX trainer: G is the batched implicit
:class:`~shapegan_tpu_torch.models.point_sdf_net.SDFGenerator`, D the
:class:`~shapegan_tpu_torch.models.point_sdf_net.PointNet` critic over (pos,
sdf) pairs; WGAN-GP on the SDF values at the batch's uniform positions, the
gradient penalty (weight 10) interpolating the distance channel only; RMSprop
(optax's rule, ``optim.py``) at 1e-4 for both; the critic updated every
step, the generator every 5th global step; the point-count curriculum
(1024, b32) → (2048, b32) → (4096, b32) → (8192, b24) → (16384, b12) →
(32768, b6), ``epochs`` capping each stage. Every epoch writes the
checkpoints ``point_gan_generator`` / ``point_gan_discriminator`` (flax
trees) and the RMSprop sidecar ``point_gan_optimizer`` (optax's paths
``g/0/nu/...``, ``d/0/nu/...``), files that load both ways with the JAX
package, and a line ``num_points epoch seconds mean|d_loss|`` of
``plots/point_gan_training.csv``. ``continue`` fast-forwards the epochs the
CSV records and restores the moments; every draw is keyed by the global
epoch or step (the shuffle and subsample by ``(seed, epoch)``, the step's
noise by a ``torch.Generator`` seeded from the step count), so a resumed run
reproduces the uninterrupted one.

Precision, as in the JAX trainer (its COMPUTE_DTYPE note): the critic runs
in bf16 everywhere; the D step's fake cloud comes from the bf16 generator
under ``no_grad`` through :func:`~shapegan_tpu_torch.ops.point_gen_kernels.generate_best`
(on the GPU the hand-written generator kernel; with ``cpu`` the bf16
module, the JAX package's choice off a TPU); the G step differentiates the generator in float32 through the
bf16 critic. The steps take their noise as arguments, so a test can hand
both packages the same. Batches come from the host (:class:`BatchLoader`,
threads) and go to the card from pinned memory.

With several ranks (``python -m torch.distributed.run``) each curriculum
stage gets the JAX trainer's per-stage mesh, ``get_mesh(batch_size=B)``:
``gcd(ranks, B)`` data ranks for the batches of 32, 24, 12 and 6. Each
takes its rows of every global batch and of the step's noise (drawn alike
on every rank), makes its D step's fakes (the generator kernel on its card)
and averages the gradients and the loss over the data group; ranks outside
a stage's mesh wait through it, keeping the step count. At every stage
change, and at the end, rank 0's state is broadcast to all ranks, so none
drifts. Rank 0 writes the files.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from shapegan_tpu_torch import checkpoints
from shapegan_tpu_torch.core.config import TrainConfig, parse_cli, resolve_device
from shapegan_tpu_torch.data.datasets import BatchLoader, PointDataset
from shapegan_tpu_torch.models import point_sdf_net
from shapegan_tpu_torch.models.point_sdf_net import PointNet, SDFGenerator
from shapegan_tpu_torch.ops.losses import gradient_penalty
from shapegan_tpu_torch.ops.point_gen_kernels import generate_best
from shapegan_tpu_torch.optim import RMSprop
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
)

LATENT_SIZE = 128
GRADIENT_PENALTY = 10.0
HIDDEN_SIZE = 256
NUM_LAYERS = 8
LEARN_RATE = 1e-4
GENERATOR_UPDATE_EVERY = 5
COMPUTE_DTYPE = torch.bfloat16

# (num_points, batch_size, epochs)
CURRICULUM = [
    (1024, 32, 300),
    (2048, 32, 300),
    (4096, 32, 300),
    (8192, 24, 300),
    (16384, 12, 300),
    (32768, 6, 900),
]

G_NAME = "point_gan_generator"
D_NAME = "point_gan_discriminator"
OPT_NAME = "point_gan_optimizer"

Grads = Dict[str, torch.Tensor]


def create_models(seed: int = 0, device="cpu", dtype=COMPUTE_DTYPE) -> Tuple[SDFGenerator, PointNet]:
    """Generator and critic with compute dtype ``dtype`` and fresh weights
    drawn from one ``torch.Generator`` seeded with ``seed``."""
    generator = torch.Generator().manual_seed(seed)
    g = SDFGenerator(latent_channels=LATENT_SIZE, hidden_channels=HIDDEN_SIZE,
                     num_layers=NUM_LAYERS, norm=True, dtype=dtype, generator=generator,
                     device=device)
    return g, PointNet(out_channels=1, dtype=dtype, generator=generator, device=device)


def critic_grads(discriminator: PointNet, u_pos: torch.Tensor, u_dist: torch.Tensor,
                 fake: torch.Tensor, alpha: torch.Tensor) -> Tuple[Grads, Dict[str, torch.Tensor]]:
    """Gradients of ``mean(D(fake)) - mean(D(real)) + GP`` for the critic's
    parameters, the penalty on ``alpha`` [B, 1, 1] interpolates of the
    distance channel; and the metrics (``d_loss`` without the penalty,
    ``gradient_penalty``)."""
    params = dict(discriminator.named_parameters())

    def critic(dist):
        return discriminator(u_pos, dist)[..., 0]

    d_loss = critic(fake).mean() - critic(u_dist).mean()
    gp = gradient_penalty(critic, alpha, u_dist, fake, weight=GRADIENT_PENALTY)
    grads = torch.autograd.grad(d_loss + gp, list(params.values()))
    return dict(zip(params, grads)), {"d_loss": d_loss.detach(), "gradient_penalty": gp.detach()}


def generator_grads(generator: SDFGenerator, discriminator: PointNet, u_pos: torch.Tensor,
                    z: torch.Tensor) -> Tuple[Grads, torch.Tensor]:
    """Gradients of ``-mean(D(G(z)))`` for the generator's parameters, the
    generator run in float32, and the loss."""
    params = dict(generator.named_parameters())
    fake = generator(u_pos, z, dtype=torch.float32)
    loss = -discriminator(u_pos, fake)[..., 0].mean()
    grads = torch.autograd.grad(loss, list(params.values()))
    return dict(zip(params, grads)), loss.detach()


def make_steps(generator: SDFGenerator, discriminator: PointNet, g_opt: RMSprop, d_opt: RMSprop,
               mesh: Optional[Mesh] = None):
    """The two steps:

    * ``d_step(u_pos, u_dist, z, alpha)`` — one critic update on the real
      SDF values ``u_dist`` [B, N, 1] at ``u_pos`` [B, N, 3], the fake cloud
      generated (forward only, bf16) from latents ``z`` [B, L], penalty
      coefficients ``alpha`` [B, 1, 1]; returns the metrics;
    * ``g_step(u_pos, z)`` — one generator update; returns its loss.

    Under a ``mesh`` the clouds are this rank's rows and ``z`` and ``alpha``
    the global batch's; the gradients and the metrics are averaged over the
    data group.
    """
    g_params = dict(generator.named_parameters())

    def d_step(u_pos, u_dist, z, alpha):
        z, alpha = shard_batch(mesh, (z, alpha))
        with torch.no_grad():
            fake = generate_best(generator, g_params, u_pos, z)
        grads, metrics = critic_grads(discriminator, u_pos, u_dist, fake, alpha)
        d_opt.step(average_over_data(mesh, grads))
        return average_over_data(mesh, metrics)

    def g_step(u_pos, z):
        grads, loss = generator_grads(generator, discriminator, u_pos, shard_batch(mesh, z))
        g_opt.step(average_over_data(mesh, grads))
        return average_over_data(mesh, {"loss": loss})["loss"]

    return d_step, g_step


def resolve_point_dataset(config: TrainConfig):
    """``synthetic=N`` analytic shapes, else ``data_dir/category``'s train
    split."""
    if config.synthetic:
        from shapegan_tpu_torch.data.synthetic import SyntheticPointDataset

        return SyntheticPointDataset(config.synthetic, seed=config.seed)
    return PointDataset.from_split(os.path.join(config.data_dir, config.category), "train",
                                   seed=config.seed)


def _optimizer_tree(g_opt: RMSprop, d_opt: RMSprop) -> dict:
    return {"g": ({"nu": point_sdf_net.params_to_jax(g_opt.nu)},),
            "d": ({"nu": point_sdf_net.params_to_jax(d_opt.nu)},)}


def _load_module(module: torch.nn.Module, name: str, base: str) -> None:
    params = dict(module.named_parameters())
    restored = checkpoints.load_tree(point_sdf_net.params_to_jax(params), name, base=base,
                                     strict=True)
    restored = point_sdf_net.params_from_jax(restored, device=next(iter(params.values())).device)
    with torch.no_grad():
        for key, param in params.items():
            param.copy_(restored[key])


def _load_optimizers(g_opt: RMSprop, d_opt: RMSprop, base: str, name: str = OPT_NAME) -> None:
    restored = checkpoints.load_tree(_optimizer_tree(g_opt, d_opt), name, base=base, strict=True)
    device = next(iter(g_opt.nu.values())).device
    g_opt.nu = point_sdf_net.params_from_jax(restored["g"][0]["nu"], device=device)
    d_opt.nu = point_sdf_net.params_from_jax(restored["d"][0]["nu"], device=device)


def to_device(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch on ``device``: through pinned memory, without waiting,
    for the GPU."""
    tensor = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.float32))
    if device.type == "cuda":
        return tensor.pin_memory().to(device, non_blocking=True)
    return tensor.to(device)


def step_noise(noise: torch.Generator, seed: int, step: int, batch: int, device):
    """The noise of global step ``step`` (1-based): the D step's latents
    [B, L] and penalty coefficients [B, 1, 1], the G step's latents."""
    noise.manual_seed((seed + 1) * 1_000_003 + step)
    z_d = torch.randn((batch, LATENT_SIZE), generator=noise, device=device)
    alpha = torch.rand((batch, 1, 1), generator=noise, device=device)
    z_g = torch.randn((batch, LATENT_SIZE), generator=noise, device=device)
    return z_d, alpha, z_g


def _replicate(mesh: Mesh, generator, discriminator, g_opt: RMSprop, d_opt: RMSprop) -> None:
    """Rank 0's networks and moments to every rank (``mesh`` spans them
    all)."""
    mesh.replicate([*generator.parameters(), *discriminator.parameters(),
                    *g_opt.nu.values(), *d_opt.nu.values()])


@tears_down_launch
def train(config: Optional[TrainConfig] = None, curriculum=None) -> dict:
    """Run the curriculum; returns the models, the number of steps this call
    ran (``steps``; a resume skips the completed epochs' steps) and the D
    and G step times."""
    config = config or parse_cli()
    device = init_from_env(resolve_device(config))
    base = config.model_dir
    generator, discriminator = create_models(config.seed, device)
    if config.resume:
        if checkpoints.exists(G_NAME, base=base):
            _load_module(generator, G_NAME, base)
        if checkpoints.exists(D_NAME, base=base):
            _load_module(discriminator, D_NAME, base)
    g_opt = RMSprop(dict(generator.named_parameters()), LEARN_RATE)
    d_opt = RMSprop(dict(discriminator.named_parameters()), LEARN_RATE)
    if config.resume and checkpoints.exists(OPT_NAME, base=base):
        _load_optimizers(g_opt, d_opt, base)

    dataset = resolve_point_dataset(config)
    everyone = get_mesh(points=1)
    logger = CSVLogger(f"{config.plot_dir}/point_gan_training.csv", resume=config.resume)
    d_profiler, g_profiler = StepProfiler(device), StepProfiler(device)
    noise = torch.Generator(device=device)
    num_steps = steps_run = 0
    completed_epochs = logger.first_epoch
    epoch_index = 0
    try:
        for num_points, batch_size, stage_epochs in curriculum or CURRICULUM:
            if config.epochs:
                stage_epochs = min(stage_epochs, config.epochs)
            dataset.num_points = num_points
            loader = BatchLoader(dataset, batch_size, shuffle=True, drop_remainder=True,
                                 seed=config.seed)
            if len(loader) == 0:
                print(f"skipping curriculum stage ({num_points} pts, batch {batch_size}): "
                      f"dataset has only {len(dataset)} shapes")
                continue
            # The stage's mesh: the batch decides how many ranks train it.
            _replicate(everyone, generator, discriminator, g_opt, d_opt)
            mesh = get_mesh(batch_size=batch_size)
            d_step, g_step = make_steps(generator, discriminator, g_opt, d_opt, mesh)
            for epoch in range(1, stage_epochs + 1):
                epoch_index += 1
                if epoch_index <= completed_epochs or not mesh.member:
                    num_steps += len(loader)
                    continue
                loader.set_epoch(epoch_index)
                losses = []
                with EpochTimer() as timer:
                    for uniform, _surface in loader:
                        num_steps += 1
                        steps_run += 1
                        batch = to_device(shard_batch(mesh, uniform), device)
                        u_pos, u_dist = batch[..., :3], batch[..., 3:]
                        z_d, alpha, z_g = step_noise(noise, config.seed, num_steps, batch_size,
                                                     device)
                        with d_profiler:
                            metrics = d_step(u_pos, u_dist, z_d, alpha)
                        if num_steps % GENERATOR_UPDATE_EVERY == 0:
                            with g_profiler:
                                g_step(u_pos, z_g)
                        losses.append(metrics["d_loss"])
                    mean_loss = float(torch.stack(losses).abs().mean())
                print(f"Num points: {num_points}, Epoch: {epoch:03d}, Loss: {mean_loss:.6f} "
                      f"(D {d_profiler.mean_step_time * 1000:.1f} ms/step, "
                      f"G {g_profiler.mean_step_time * 1000:.1f} ms/step)", flush=True)
                logger.write(num_points, epoch, timer.duration, mean_loss)
                checkpoints.save(point_sdf_net.params_to_jax(dict(generator.named_parameters())),
                                 G_NAME, base=base)
                checkpoints.save(point_sdf_net.params_to_jax(dict(discriminator.named_parameters())),
                                 D_NAME, base=base)
                checkpoints.save(_optimizer_tree(g_opt, d_opt), OPT_NAME, base=base)
        _replicate(everyone, generator, discriminator, g_opt, d_opt)
    finally:
        logger.close()
    return {"generator": generator, "discriminator": discriminator, "steps": steps_run,
            "d_step_s": list(d_profiler.times), "g_step_s": list(g_profiler.times)}


if __name__ == "__main__":
    train()
