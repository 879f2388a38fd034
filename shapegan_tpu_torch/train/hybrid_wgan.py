"""Hybrid WGAN: DeepSDF implicit generator + voxel critic with weight
clipping (counterpart of :mod:`shapegan_tpu.train.hybrid_wgan`).

    python -m shapegan_tpu_torch.train.hybrid_wgan [epochs=E] [synthetic=S] \\
        [batch_size=B] [continue] [show_slice] [verbose] [cpu]

Semantics of the JAX trainer: the critic (the voxel discriminator without
its sigmoid) takes a step every batch on ``mean(critic(fake)) -
mean(critic(real))`` with optax's RMSprop at 1e-5, then its parameters are
clipped to ±0.01; the generator takes a step every fifth batch (``batch_index
% 5 == 0``) on ``-mean(critic(G(z)))`` with Adam at 1e-5, and only then are
the rolling histories of D(fake) (the G step's) and D(real) (the critic
step's) appended; batch 8; raw SDF volumes clamped to ±0.1; every epoch
saves ``hybrid_wgan_generator``, ``hybrid_wgan_critic``, the sidecar
``hybrid_wgan_optimizer`` (``g/0/count``, ``g/0/mu/<key>``, ...,
``d/0/nu/<layer>/<kernel|bias>``), per-epoch snapshots and a line ``epoch
time fake real`` of ``plots/hybrid_wgan_training.csv``; ``continue``
restores the networks (the generator's Adam starts after them, as in JAX)
and the moments, and resumes at the CSV's epoch count.

The generation paths and the noise are those of
:mod:`shapegan_tpu_torch.train.hybrid_gan` (its :data:`_GRID_STASH` switch
picks the G step's gradient path here too). With ``gui`` the live viewer
(``train.common.make_viewer``) shows the G step's first fake volume every
20th batch.

Data-parallel under ``python -m torch.distributed.run --nproc_per_node=N``,
as the hybrid GAN: ``gcd(N, B)`` ranks each draw the global batch's latents
from the same seeded generator, evaluate their rows of the volumes through
:func:`~shapegan_tpu_torch.ops.sdf_mlp_kernels.apply_grid_sharded` (the
grid kernel forward, and the grid backward kernel in the G step) and
average the gradients and the scores over the data group; the critic's
clip follows the averaged step on every rank; rank 0 writes the files.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from shapegan_tpu_torch import LATENT_CODE_SIZE, SDF_CLIPPING, checkpoints
from shapegan_tpu_torch.core.config import TrainConfig, parse_cli, resolve_device
from shapegan_tpu_torch.models import gan
from shapegan_tpu_torch.models.gan import Discriminator, clip_parameters
from shapegan_tpu_torch.models.sdf_net import SDFNet
from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.ops.coords import voxel_coordinates
from shapegan_tpu_torch.optim import Adam, RMSprop, load_optimizer_tree, optimizer_tree
from shapegan_tpu_torch.parallel.mesh import Mesh, get_mesh, init_from_env, tears_down_launch
from shapegan_tpu_torch.train.common import (
    CSVLogger,
    EpochTimer,
    RollingHistory,
    StepProfiler,
    average_over_data,
    effective_batch_size,
    idle_result,
    load_critic,
    load_generator,
    make_viewer,
    make_voxel_batches,
    maybe_print_slice,
    resolve_voxel_dataset,
)
from shapegan_tpu_torch.train.hybrid_gan import (
    SLICE_EVERY,
    VOXEL_RESOLUTION,
    epoch_range,
    generate_volumes,
    generate_volumes_inference,
    save_networks,
)

BATCH_SIZE = 8
LEARN_RATE = 1e-5
CRITIC_UPDATES_PER_GENERATOR_UPDATE = 5
CRITIC_WEIGHT_LIMIT = 0.01

G_NAME = "hybrid_wgan_generator"
D_NAME = "hybrid_wgan_critic"
OPT_NAME = "hybrid_wgan_optimizer"

Grads = Dict[str, torch.Tensor]


def create_models(seed: int = 0, device="cpu") -> Tuple[SDFNet, Discriminator]:
    """Generator and critic (no sigmoid) with fresh weights from ``seed``."""
    generator = torch.Generator().manual_seed(seed)
    net = SDFNet(sdf_mlp.init(generator, device=device))
    return net, Discriminator(use_sigmoid=False, generator=generator, device=device)


def critic_grads(critic: Discriminator, fake: torch.Tensor,
                 batch: torch.Tensor) -> Tuple[Grads, Dict[str, torch.Tensor]]:
    """Gradients of the Wasserstein loss ``mean(critic(fake)) -
    mean(critic(real))`` for the critic's parameters, and the mean scores."""
    params = dict(critic.named_parameters())
    pred_fake = critic(fake).mean()
    pred_real = critic(batch).mean()
    grads = torch.autograd.grad(pred_fake - pred_real, list(params.values()))
    return dict(zip(params, grads)), {"pred_fake": pred_fake.detach(),
                                      "pred_real": pred_real.detach()}


def generator_grads(net: SDFNet, critic: Discriminator, grid: torch.Tensor, z: torch.Tensor,
                    resolution: int) -> Tuple[Grads, torch.Tensor, torch.Tensor]:
    """Gradients of ``-mean(critic(G(z)))`` for the generator's parameters,
    the fake volumes and ``mean(critic(G(z)))``."""
    params = net.param_dict()
    fake = generate_volumes(net, grid, z, resolution)
    pred_fake = critic(fake).mean()
    grads = torch.autograd.grad(-pred_fake, list(params.values()))
    return dict(zip(params, grads)), fake.detach(), pred_fake.detach()


def make_steps(net: SDFNet, critic: Discriminator, g_opt: Adam, d_opt: RMSprop,
               resolution: int = VOXEL_RESOLUTION, mesh: Optional[Mesh] = None):
    """The trainer's steps:

    * ``critic_step(batch, z)`` — one critic update on fakes generated
      (forward only) from ``z`` and the real ``batch``, then the clip;
      returns the mean scores;
    * ``generator_step(z)`` — one generator update; returns
      (mean critic score of the fakes, the fake volumes).

    Under a ``mesh`` (entered by the caller) ``z`` is the global batch's,
    ``batch`` and the fakes this rank's rows; the gradients and the scores
    are averaged over the data group, and the clip follows the averaged
    step.
    """
    grid = voxel_coordinates(resolution, device=net.device)

    def critic_step(batch: torch.Tensor, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        fake = generate_volumes_inference(net, grid, z, resolution)
        grads, metrics = critic_grads(critic, fake, batch)
        d_opt.step(average_over_data(mesh, grads))
        params = dict(critic.named_parameters())
        with torch.no_grad():
            for key, value in clip_parameters(params, CRITIC_WEIGHT_LIMIT).items():
                params[key].copy_(value)
        return average_over_data(mesh, metrics)

    def generator_step(z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        grads, fake, pred_fake = generator_grads(net, critic, grid, z, resolution)
        g_opt.step(average_over_data(mesh, grads))
        return average_over_data(mesh, {"pred": pred_fake})["pred"], fake

    return critic_step, generator_step


def _optimizer_tree(g_opt: Adam, d_opt: RMSprop) -> dict:
    return {"g": optimizer_tree(g_opt), "d": optimizer_tree(d_opt, gan.params_to_jax)}


@tears_down_launch
def train(config: Optional[TrainConfig] = None) -> dict:
    """Train until ``epochs``; returns the models, the numbers of critic
    and generator steps, and the step times (a critic step, with the
    generator step of its batch if there is one)."""
    config = config or parse_cli()
    device = init_from_env(resolve_device(config))
    base = config.model_dir
    net, critic = create_models(config.seed, device)
    if config.resume:
        if checkpoints.exists(G_NAME, base=base):
            load_generator(net, G_NAME, base)
        if checkpoints.exists(D_NAME, base=base):
            load_critic(critic, D_NAME, base)
    g_opt = Adam(net.param_dict(), LEARN_RATE)
    d_opt = RMSprop(dict(critic.named_parameters()), LEARN_RATE)
    if config.resume and checkpoints.exists(OPT_NAME, base=base):
        restored = checkpoints.load_tree(_optimizer_tree(g_opt, d_opt), OPT_NAME, base=base)
        load_optimizer_tree(g_opt, restored["g"])
        load_optimizer_tree(d_opt, restored["d"], lambda tree: gan.params_from_jax(tree, device=device))

    dataset = resolve_voxel_dataset(config, resolution=VOXEL_RESOLUTION, rescale_sdf=False)
    batch_size = effective_batch_size(config.batch_size or BATCH_SIZE, len(dataset))
    mesh = get_mesh(batch_size=batch_size)
    if not mesh.member:
        return idle_result(mesh)
    batches = make_voxel_batches(dataset, batch_size, config.seed, config.extras, device, mesh)
    critic_step, generator_step = make_steps(net, critic, g_opt, d_opt, mesh=mesh)

    logger = CSVLogger(f"{config.plot_dir}/hybrid_wgan_training.csv", resume=config.resume)
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
                            if batch_index % SLICE_EVERY == 0:
                                if viewer is not None:
                                    viewer.set_voxels(fake[0])
                                maybe_print_slice(fake[0], config.show_slice, scale=SDF_CLIPPING)
                        if config.verbose and batch_index % SLICE_EVERY == 0:
                            print(f"Epoch {epoch}, batch {batch_index}: prediction on fake "
                                  f"samples: {history_fake.mean:.4f}, prediction on valid "
                                  f"samples: {history_real.mean:.4f}")

                save_networks(net, critic, G_NAME, D_NAME, base)
                checkpoints.save(_optimizer_tree(g_opt, d_opt), OPT_NAME, base=base)
                save_networks(net, critic, G_NAME, D_NAME, base, epoch=epoch)
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
    return {"net": net, "critic": critic, "steps": steps, "g_steps": g_steps,
            "step_s": list(profiler.times), "viewer": viewer}


if __name__ == "__main__":
    train()
