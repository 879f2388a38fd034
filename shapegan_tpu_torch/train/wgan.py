"""Voxel WGAN trainer with weight clipping (counterpart of
:mod:`shapegan_tpu.train.wgan`).

    python -m shapegan_tpu_torch.train.wgan [epochs=E] [synthetic=S] \\
        [batch_size=B] [continue] [show_slice] [verbose] [cpu]

Semantics of the JAX trainer: the critic (the voxel discriminator without
its sigmoid) takes a step every batch on ``mean(critic(fake)) -
mean(critic(real))``, its fakes from the generator in train mode (batch
statistics, the BatchNorm update thrown away), then its parameters are
clipped to ±0.01; the generator takes a step every fifth batch
(``batch_index % 5 == 0``) on ``-mean(critic(G(z)))``, keeping its
BatchNorm update, and only then are the rolling histories of the G step's
critic score and the critic step's real score appended; RMSprop (optax's
rule) at 5e-5 on both; batch 64. Every epoch saves ``wgan-generator`` and
``wgan-critic`` (flax ``params``, the generator's ``batch_stats``, the
RMSprop's ``opt_state/0/nu/...`` and ``epoch`` in each file), snapshots
every 20th epoch, and writes a line ``epoch time fake real`` of
``plots/wgan_training.csv``; ``continue`` restores both files and resumes at
the CSV's epoch count.

The noise, the convolutions, the viewer (``gui``: the G step's first fake
after every G step) and the data-parallel branch are as in
:mod:`shapegan_tpu_torch.train.gan`; under ranks the critic's clip follows
the data-averaged step on every rank, so the replicas stay equal.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from shapegan_tpu_torch import LATENT_CODE_SIZE
from shapegan_tpu_torch.core.config import TrainConfig, parse_cli, resolve_device
from shapegan_tpu_torch.models.gan import Discriminator, Generator, clip_parameters
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
    RollingHistory,
    StepProfiler,
    average_over_data,
    effective_batch_size,
    idle_result,
    make_viewer,
    make_voxel_batches,
    resolve_voxel_dataset,
)
from shapegan_tpu_torch.train.gan import print_sample, restore, save
from shapegan_tpu_torch.train.hybrid_gan import epoch_range
from shapegan_tpu_torch.train.hybrid_wgan import critic_grads

LEARN_RATE = 5e-5
BATCH_SIZE = 64
CRITIC_UPDATES_PER_GENERATOR_UPDATE = 5
CRITIC_WEIGHT_LIMIT = 0.01
SNAPSHOT_EVERY = 20

G_NAME = "wgan-generator"
D_NAME = "wgan-critic"


def create_states(seed: int = 0, device="cpu") -> Tuple[Generator, Discriminator, RMSprop, RMSprop]:
    """Generator and critic (no sigmoid) with fresh weights from ``seed``,
    and an RMSprop for each."""
    generator = torch.Generator().manual_seed(seed)
    g_net = Generator(generator, device)
    critic = Discriminator(False, generator, device)
    return (g_net, critic, RMSprop(dict(g_net.named_parameters()), LEARN_RATE),
            RMSprop(dict(critic.named_parameters()), LEARN_RATE))


def make_steps(g_net: Generator, critic: Discriminator, g_opt: RMSprop, d_opt: RMSprop,
               mesh: Optional[Mesh] = None):
    """The trainer's steps:

    * ``critic_step(batch, z)`` — one critic update on fakes from ``z`` and
      the real ``batch``, then the clip; returns the mean scores;
    * ``generator_step(z)`` — one generator update; returns (mean critic
      score of the fakes, the fakes).

    Under a ``mesh`` (entered by the caller) ``z`` is the global batch's and
    ``batch`` this rank's rows; the gradients and the scores are averaged
    over the data group, and the clip follows the averaged step.
    """
    g_params = dict(g_net.named_parameters())
    d_params = dict(critic.named_parameters())

    def critic_step(batch: torch.Tensor, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            fake = g_net(shard_batch(mesh, z), train=True, update_stats=False)
        grads, metrics = critic_grads(critic, fake, batch)
        d_opt.step(average_over_data(mesh, grads))
        with torch.no_grad():
            for key, value in clip_parameters(d_params, CRITIC_WEIGHT_LIMIT).items():
                d_params[key].copy_(value)
        return average_over_data(mesh, metrics)

    def generator_step(z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        fake = g_net(shard_batch(mesh, z), train=True)
        pred_fake = critic(fake).mean()
        grads = torch.autograd.grad(-pred_fake, list(g_params.values()))
        g_opt.step(average_over_data(mesh, dict(zip(g_params, grads))))
        return average_over_data(mesh, {"pred": pred_fake.detach()})["pred"], fake.detach()

    return critic_step, generator_step


@tears_down_launch
def train(config: Optional[TrainConfig] = None) -> dict:
    """Train until ``epochs``; returns the networks, their optimizers, the
    numbers of critic and generator steps, and the step times (a critic
    step, with the generator step of its batch if there is one)."""
    config = config or parse_cli()
    device = init_from_env(resolve_device(config))
    base = config.model_dir
    g_net, critic, g_opt, d_opt = create_states(config.seed, device)
    if config.resume:
        restore(g_net, critic, g_opt, d_opt, G_NAME, D_NAME, base)

    dataset = resolve_voxel_dataset(config, resolution=32)
    batch_size = effective_batch_size(config.batch_size or BATCH_SIZE, len(dataset))
    mesh = get_mesh(batch_size=batch_size)
    if not mesh.member:
        return idle_result(mesh)
    batches = make_voxel_batches(dataset, batch_size, config.seed, config.extras, device, mesh)
    critic_step, generator_step = make_steps(g_net, critic, g_opt, d_opt, mesh)

    logger = CSVLogger(f"{config.plot_dir}/wgan_training.csv", resume=config.resume)
    viewer = make_viewer(config.nogui)
    history_fake, history_real = RollingHistory(), RollingHistory()
    profiler = StepProfiler(device)
    noise = torch.Generator(device=device)
    steps = g_steps = 0
    try:
        with mesh:
            for epoch in epoch_range(config, logger.first_epoch):
                # Epoch-deterministic noise, so a resumed run replays its epochs.
                noise.manual_seed((config.seed + 1) * 1_000_003 + epoch)
                batches.set_epoch(epoch)
                with EpochTimer() as timer:
                    for batch_index, batch in enumerate(batches):
                        g_turn = batch_index % CRITIC_UPDATES_PER_GENERATOR_UPDATE == 0
                        z_d = torch.randn((batch_size, LATENT_CODE_SIZE), generator=noise,
                                          device=device)
                        with profiler:
                            metrics = critic_step(batch, z_d)
                            steps += 1
                            if g_turn:
                                z_g = torch.randn((batch_size, LATENT_CODE_SIZE), generator=noise,
                                                  device=device)
                                pred_fake, fake = generator_step(z_g)
                                g_steps += 1
                        if g_turn:
                            history_fake.append(pred_fake)
                            history_real.append(metrics["pred_real"])
                            if viewer is not None:
                                viewer.set_voxels(fake[0])
                            if config.verbose:
                                print(f"epoch {epoch}, batch {batch_index}: fake value: "
                                      f"{history_fake.mean:.1f}, valid value: "
                                      f"{history_real.mean:.1f}")

                save(g_net, critic, g_opt, d_opt, G_NAME, D_NAME, base, epoch,
                     epoch % SNAPSHOT_EVERY == 0)
                if config.show_slice:
                    print_sample(g_net, noise, device)
                print(f"Epoch {epoch} ({timer.duration:.1f}s, "
                      f"{profiler.mean_step_time * 1000:.1f} ms/step), critic values: "
                      f"{history_fake.mean:.2f}, {history_real.mean:.2f}", flush=True)
                logger.write(epoch, timer.duration, history_fake.mean, history_real.mean)
    except KeyboardInterrupt:
        pass
    finally:
        logger.close()
        if viewer is not None:
            viewer.stop()
    return {"generator": g_net, "critic": critic, "g_opt": g_opt, "d_opt": d_opt,
            "steps": steps, "g_steps": g_steps, "step_s": list(profiler.times), "viewer": viewer}


if __name__ == "__main__":
    train()
