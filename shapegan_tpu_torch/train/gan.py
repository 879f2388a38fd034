"""Voxel GAN trainer (counterpart of :mod:`shapegan_tpu.train.gan`).

    python -m shapegan_tpu_torch.train.gan [epochs=E] [synthetic=S] \\
        [batch_size=B] [save_every=N] [continue] [show_slice] [verbose] [cpu]

Semantics of the JAX trainer: per batch, one generator step on
``-mean(log(clip(D(G(z)), 1e-7, 1)))`` (Adam, optax's rule, lr 1e-3; the
generator's BatchNorm keeps this forward's statistics); then, with the
updated generator, fresh fakes (train-mode BatchNorm on batch statistics,
the update thrown away; no gradient) and one discriminator step on their
BCE toward 0; then a separate discriminator step on the real batch toward
1 (Adam, lr 1e-5); batch 64; SDF volumes clamped to ±0.1 and rescaled to
±1. An epoch saves ``generator`` and ``discriminator`` to their latest
slots when ``(epoch + 1) % save_every == 0`` (``save_every`` 1 by
default), in every 20th epoch (also a snapshot) and in the last one; each
file holds the network's flax ``params`` (and the generator's
``batch_stats``), its optimizer's ``opt_state`` (``opt_state/0/count``,
``opt_state/0/mu/<layer>/<kernel|bias|scale>`` ...) and ``epoch``. Then a
line ``epoch time fake real`` of ``plots/gan_training.csv``. ``continue``
restores both files and resumes at the epoch count the CSV records; without
``epochs`` the run goes on until interrupted.

The latents are drawn on the device from a ``torch.Generator`` seeded per
epoch (not the JAX trainer's noise); the steps take them as arguments, so a
test can hand both packages the same. The convolutions are cuDNN's (no hand
kernel runs). With ``gui`` the live viewer (``train.common.make_viewer``)
shows the G step's first fake volume after every batch.

Data-parallel under ``python -m torch.distributed.run --nproc_per_node=N``,
as the JAX trainer's mesh: ``gcd(N, B)`` ranks each draw the global batch's
latents from the same seeded generator and take their rows of them and of
every voxel batch; the generator's BatchNorm takes the global batch's
statistics (summed over the data group); the gradients and the predictions
are averaged over the data group; rank 0 writes the files.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from shapegan_tpu_torch import LATENT_CODE_SIZE, checkpoints, tracing
from shapegan_tpu_torch.core.config import TrainConfig, parse_cli, resolve_device
from shapegan_tpu_torch.models.gan import Discriminator, Generator
from shapegan_tpu_torch.optim import Adam
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
    load_network,
    make_viewer,
    make_voxel_batches,
    maybe_print_slice,
    network_payload,
    resolve_voxel_dataset,
)
from shapegan_tpu_torch.train.hybrid_gan import bce_grads, epoch_range

BATCH_SIZE = 64
GENERATOR_LR = 1e-3
DISCRIMINATOR_LR = 1e-5
SNAPSHOT_EVERY = 20

G_NAME = "generator"
D_NAME = "discriminator"


def create_states(seed: int = 0, device="cpu") -> Tuple[Generator, Discriminator, Adam, Adam]:
    """Generator and discriminator with fresh weights from ``seed``, and an
    Adam for each."""
    generator = torch.Generator().manual_seed(seed)
    g_net = Generator(generator, device)
    d_net = Discriminator(True, generator, device)
    return (g_net, d_net, Adam(dict(g_net.named_parameters()), GENERATOR_LR),
            Adam(dict(d_net.named_parameters()), DISCRIMINATOR_LR))


def make_steps(g_net: Generator, d_net: Discriminator, g_opt: Adam, d_opt: Adam,
               mesh: Optional[Mesh] = None):
    """The trainer's steps, one of each a batch, in this order:

    * ``g_step(z)`` — one generator update from latents ``z`` [B, 128];
      returns the fakes;
    * ``d_step(batch, z)`` — two discriminator updates, on fakes from ``z``
      (the updated generator, its BatchNorm update thrown away), then on the
      real ``batch``; returns the mean predictions.

    Under a ``mesh`` (entered by the caller, so BatchNorm takes the global
    batch's statistics) ``z`` is the global batch's and ``batch`` this
    rank's rows; the fakes are this rank's rows, and the gradients and the
    predictions are averaged over the data group.

    Each step is the span ``sg.g_step`` / ``sg.d_step`` (the progressive
    trainer's names): the G step's ``.generate``, ``.critic``, ``.backward``
    and ``.optimizer``; the D step's ``.fakes``, then for each of its two
    updates ``.critic`` (the discriminator's forward and backward) and
    ``.optimizer``.
    """
    g_params = dict(g_net.named_parameters())

    def g_step(z: torch.Tensor) -> torch.Tensor:
        with tracing.span("sg.g_step"):
            with tracing.span("sg.g_step.generate"):
                fake = g_net(shard_batch(mesh, z), train=True)
            with tracing.span("sg.g_step.critic"):
                loss = -torch.log(d_net(fake).clamp(1e-7, 1.0)).mean()
            with tracing.span("sg.g_step.backward"):
                grads = torch.autograd.grad(loss, list(g_params.values()))
                grads = average_over_data(mesh, dict(zip(g_params, grads)))
            with tracing.span("sg.g_step.optimizer"):
                g_opt.step(grads)
            return fake.detach()

    def d_update(volumes: torch.Tensor, target: float) -> torch.Tensor:
        with tracing.span("sg.d_step.critic"):
            grads, pred = bce_grads(d_net, volumes, target)
            grads = average_over_data(mesh, grads)
        with tracing.span("sg.d_step.optimizer"):
            d_opt.step(grads)
        return pred

    def d_step(batch: torch.Tensor, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        with tracing.span("sg.d_step"):
            with tracing.span("sg.d_step.fakes"), torch.no_grad():
                fake = g_net(shard_batch(mesh, z), train=True, update_stats=False)
            pred_fake = d_update(fake, 0.0)
            pred_real = d_update(batch, 1.0)
            return average_over_data(mesh, {"pred_fake": pred_fake.mean(),
                                            "pred_real": pred_real.mean()})

    return g_step, d_step


def save(g_net, d_net, g_opt, d_opt, g_name: str, d_name: str, base: str, epoch: int,
         snapshot: bool) -> None:
    """Both networks with their optimizers and ``epoch`` to the latest
    slots, and to the epoch's snapshots when ``snapshot``."""
    for module, opt, name in ((g_net, g_opt, g_name), (d_net, d_opt, d_name)):
        payload = network_payload(module, opt, epoch)
        checkpoints.save(payload, name, base=base)
        if snapshot:
            checkpoints.save(payload, name, epoch=epoch, base=base)


def restore(g_net, d_net, g_opt, d_opt, g_name: str, d_name: str, base: str) -> None:
    """Each network and its optimizer from its file, where there is one."""
    for module, opt, name in ((g_net, g_opt, g_name), (d_net, d_opt, d_name)):
        if checkpoints.exists(name, base=base):
            load_network(module, opt, name, base)


def print_sample(g_net: Generator, noise: torch.Generator, device) -> None:
    """``show_slice``: one eval-mode volume from fresh noise."""
    with torch.no_grad():
        z = torch.randn((1, LATENT_CODE_SIZE), generator=noise, device=device)
        maybe_print_slice(g_net(z, train=False)[0], True)


@tears_down_launch
def train(config: Optional[TrainConfig] = None) -> dict:
    """Train until ``epochs``; returns the networks, their optimizers, the
    number of steps and their times."""
    config = config or parse_cli()
    device = init_from_env(resolve_device(config))
    base = config.model_dir
    g_net, d_net, g_opt, d_opt = create_states(config.seed, device)
    if config.resume:
        restore(g_net, d_net, g_opt, d_opt, G_NAME, D_NAME, base)

    dataset = resolve_voxel_dataset(config, resolution=32)
    batch_size = effective_batch_size(config.batch_size or BATCH_SIZE, len(dataset))
    mesh = get_mesh(batch_size=batch_size)
    if not mesh.member:
        return idle_result(mesh)
    batches = make_voxel_batches(dataset, batch_size, config.seed, config.extras, device, mesh)
    g_step, d_step = make_steps(g_net, d_net, g_opt, d_opt, mesh)
    save_every = int(config.extras.get("save_every", 1))

    logger = CSVLogger(f"{config.plot_dir}/gan_training.csv", resume=config.resume)
    viewer = make_viewer(config.nogui)
    history_fake, history_real = RollingHistory(), RollingHistory()
    profiler = StepProfiler(device)
    noise = torch.Generator(device=device)
    steps = 0
    try:
        with mesh:
            for epoch in epoch_range(config, logger.first_epoch):
                # Epoch-deterministic noise, so a resumed run replays its epochs.
                noise.manual_seed((config.seed + 1) * 1_000_003 + epoch)
                batches.set_epoch(epoch)
                with EpochTimer() as timer:
                    for batch_index, batch in enumerate(batches):
                        z_g = torch.randn((batch_size, LATENT_CODE_SIZE), generator=noise,
                                          device=device)
                        z_d = torch.randn((batch_size, LATENT_CODE_SIZE), generator=noise,
                                          device=device)
                        with profiler:
                            fake = g_step(z_g)
                            metrics = d_step(batch, z_d)
                        steps += 1
                        history_fake.append(metrics["pred_fake"])
                        history_real.append(metrics["pred_real"])
                        if viewer is not None:
                            viewer.set_voxels(fake[0])
                        if config.verbose:
                            print(f"Epoch {epoch}, batch {batch_index}: prediction on fake "
                                  f"samples: {history_fake.mean:.4f}, prediction on valid "
                                  f"samples: {history_real.mean:.4f}")

                snapshot = epoch % SNAPSHOT_EVERY == 0
                if (epoch + 1) % save_every == 0 or snapshot or epoch == (config.epochs or 0) - 1:
                    save(g_net, d_net, g_opt, d_opt, G_NAME, D_NAME, base, epoch, snapshot)
                if config.show_slice:
                    print_sample(g_net, noise, device)
                print(f"Epoch {epoch} ({timer.duration:.1f}s, "
                      f"{profiler.mean_step_time * 1000:.1f} ms/step), prediction on fake: "
                      f"{history_fake.mean:.4f}, on real: {history_real.mean:.4f}", flush=True)
                logger.write(epoch, timer.duration, history_fake.mean, history_real.mean)
    except KeyboardInterrupt:
        pass
    finally:
        logger.close()
        if viewer is not None:
            viewer.stop()
    return {"generator": g_net, "discriminator": d_net, "g_opt": g_opt, "d_opt": d_opt,
            "steps": steps, "step_s": list(profiler.times), "viewer": viewer}


if __name__ == "__main__":
    train()
