"""Hybrid GAN: DeepSDF implicit generator + voxel discriminator (counterpart
of :mod:`shapegan_tpu.train.hybrid_gan`).

    python -m shapegan_tpu_torch.train.hybrid_gan [epochs=E] [synthetic=S] \\
        [batch_size=B] [continue] [show_slice] [verbose] [cpu]

Semantics of the JAX trainer: the generator is evaluated densely on the
32^3 grid and the volumes go to the voxel discriminator; G (Adam, optax's
rule, lr 1e-3) takes a step every batch on ``-mean(log(clip(D(G(z)), 1e-7,
1)))``; D (Adam, lr 1e-5) takes two separate BCE steps, fakes → 0, then
reals → 1 on the updated discriminator; batch 8; raw SDF volumes clamped to
±0.1 (``rescale_sdf=False``); after each epoch the divergence guard stops
the run when the rolling means of D(fake) and D(real) lie more than 0.1
apart, before anything of that epoch is saved; otherwise the epoch saves
``hybrid_gan_generator``, ``hybrid_gan_discriminator``, the optimizer
sidecar ``hybrid_gan_optimizer`` (optax's paths ``g/0/count``,
``g/0/mu/<key>``, ``d/0/nu/<layer>/<kernel|bias>`` ...), per-epoch
snapshots of both networks, and a line ``epoch time fake real`` of
``plots/hybrid_gan_training.csv``. ``continue`` restores the networks and
the moments and resumes at the epoch count the CSV records; without
``epochs`` the run goes on until interrupted.

On the GPU the generator's volumes go through the hand-written kernels:
the grid kernel forward for the D step's fakes, and for the G step the
grid kernel and the grid backward kernel (the recompute VJP, the default)
or the stash forward and stash backward kernels (:data:`_GRID_STASH`). With
``cpu`` their plain versions run on the CPU. The latents are drawn on the
device from a ``torch.Generator`` seeded per epoch (not the JAX trainer's
noise); the steps take them as arguments, so a test can hand both packages
the same.

Under ``python -m torch.distributed.run --nproc_per_node=N`` (or ranks of
:func:`shapegan_tpu_torch.parallel.mesh.spawn`) the run is data-parallel,
as the JAX trainer's mesh: ``get_mesh(batch_size=B)`` takes ``gcd(N, B)``
ranks, each draws the global batch's latents from the same seeded
generator, evaluates its rows of the batch through
:func:`~shapegan_tpu_torch.ops.sdf_mlp_kernels.apply_grid_sharded` and
averages the gradients over the data group; rank 0 writes the files. With
``gui`` the live viewer (``train.common.make_viewer``, rank 0's) shows the
G step's first fake volume every 20th batch.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Tuple

import torch

from shapegan_tpu_torch import LATENT_CODE_SIZE, SDF_CLIPPING, checkpoints, tracing
from shapegan_tpu_torch.core.config import TrainConfig, parse_cli, resolve_device
from shapegan_tpu_torch.models import gan
from shapegan_tpu_torch.models.gan import Discriminator
from shapegan_tpu_torch.models.sdf_net import SDFNet
from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.ops.coords import voxel_coordinates
from shapegan_tpu_torch.ops.losses import bce_loss
from shapegan_tpu_torch.ops.sdf_mlp_kernels import (
    apply_grid_best,
    apply_grid_sharded,
    apply_grid_trainable,
    apply_grid_trainable_stash,
)
from shapegan_tpu_torch.optim import Adam, load_optimizer_tree, optimizer_tree
from shapegan_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    POINTS_AXIS,
    Mesh,
    ambient_mesh,
    get_mesh,
    init_from_env,
    tears_down_launch,
)
from shapegan_tpu_torch.train.common import (
    CSVLogger,
    EpochTimer,
    average_over_data,
    RollingHistory,
    StepProfiler,
    effective_batch_size,
    idle_result,
    load_critic,
    load_generator,
    make_viewer,
    make_voxel_batches,
    maybe_print_slice,
    resolve_voxel_dataset,
)

VOXEL_RESOLUTION = 32
BATCH_SIZE = 8
GENERATOR_LR = 1e-3
DISCRIMINATOR_LR = 1e-5
DIVERGENCE_LIMIT = 0.1
SLICE_EVERY = 20

G_NAME = "hybrid_gan_generator"
D_NAME = "hybrid_gan_discriminator"
OPT_NAME = "hybrid_gan_optimizer"

# The generator's gradient path in every trainer that differentiates the
# grid evaluation (this one, hybrid_wgan, hybrid_progressive_gan): None takes
# the recompute VJP (grid kernel forward, grid backward kernel); a stash set
# (h-chain positions, 0-indexed into h1..h7, e.g. (2, 4, 6)) takes
# apply_grid_trainable_stash, whose backward reads those activations from
# the forward's planes (2.15 GB each at 16 x 64^3) instead of rebuilding
# them. Default: the recompute, the fastest setting of chip_smoke.py's A/B
# on an NVIDIA H100 80GB HBM3 at 700 W: the progressive trainer's G step at
# 64^3, batch 16, took 80.315 ms (range 79.847-80.550 over 5 in turns)
# against 98.409 (97.740-99.222) with (1..6), 103.207 with (1, 2, 4, 6) and
# 105.468 with (2, 4, 6), at a peak device memory of 3.431 GB against
# 15.510 GB with (1..6); the hybrid GAN's G step at 32^3, batch 8, 6.690 ms
# against 7.784 (PERF.md, section 6). The stash saves the backward's six
# rebuilt products (3.3 TFLOP at 16 x 64^3) at the price of reading its
# 12.9 GB of planes back, which the recompute never does. This is the one
# place that sets the trainers' stash set; the JAX package keeps the
# recompute on its TPU too.
_GRID_STASH = None

Grads = Dict[str, torch.Tensor]


def _shardable_mesh(grid_points: torch.Tensor, latent_codes: torch.Tensor) -> Optional[Mesh]:
    """The ambient mesh when it has more than one rank and both axes divide
    the workload (the JAX package's ``_shardable_mesh``), else None."""
    mesh = ambient_mesh()
    if (mesh is not None and mesh.size > 1
            and grid_points.shape[0] % mesh.shape[POINTS_AXIS] == 0
            and latent_codes.shape[0] % mesh.shape[DATA_AXIS] == 0):
        return mesh
    return None


def generate_volumes(net: SDFNet, grid_points: torch.Tensor, latent_codes: torch.Tensor,
                     resolution: int) -> torch.Tensor:
    """Latents [B, L] over grid points [res^3, 3] → SDF volumes
    [B, res, res, res] with gradients for the network's parameters (and the
    points and latents), through the VJP that :data:`_GRID_STASH` picks: the
    kernels on CUDA, their plain versions on the CPU. Under a mesh of ranks
    (:func:`_shardable_mesh`) ``latent_codes`` is the global batch and the
    result this rank's rows of it, through :func:`apply_grid_sharded`."""
    params = net.param_dict()
    mesh = _shardable_mesh(grid_points, latent_codes)
    if mesh is not None:
        flat = apply_grid_sharded(params, grid_points, latent_codes, mesh, trainable=True)
    elif _GRID_STASH is None:
        flat = apply_grid_trainable(params, grid_points, latent_codes)
    else:
        flat = apply_grid_trainable_stash(params, grid_points, latent_codes, _GRID_STASH)
    return flat.reshape(-1, resolution, resolution, resolution)


@torch.no_grad()
def generate_volumes_inference(net: SDFNet, grid_points: torch.Tensor,
                               latent_codes: torch.Tensor, resolution: int) -> torch.Tensor:
    """Latents [B, L] over grid points [res^3, 3] → SDF volumes
    [B, res, res, res], forward only: the grid kernel on CUDA (the points
    kernel when B == 1). Under a mesh of ranks, this rank's rows of the
    global batch, as :func:`generate_volumes`. The span ``sg.generate``."""
    with tracing.span("sg.generate"):
        mesh = _shardable_mesh(grid_points, latent_codes)
        if mesh is not None:
            flat = apply_grid_sharded(net.param_dict(), grid_points, latent_codes, mesh)
        else:
            flat = apply_grid_best(net.param_dict(), grid_points, latent_codes)
        return flat.reshape(-1, resolution, resolution, resolution)


def create_states(seed: int = 0, device="cpu", g_lr: float = GENERATOR_LR,
                  d_lr: float = DISCRIMINATOR_LR, use_sigmoid: bool = True
                  ) -> Tuple[SDFNet, Discriminator, Adam, Adam]:
    """Generator and discriminator with fresh weights from ``seed``, and an
    Adam for each."""
    generator = torch.Generator().manual_seed(seed)
    net = SDFNet(sdf_mlp.init(generator, device=device))
    discriminator = Discriminator(use_sigmoid, generator=generator, device=device)
    return (net, discriminator, Adam(net.param_dict(), g_lr),
            Adam(dict(discriminator.named_parameters()), d_lr))


def generator_grads(net: SDFNet, discriminator: Discriminator, grid: torch.Tensor, z: torch.Tensor,
                    resolution: int) -> Tuple[Grads, torch.Tensor]:
    """Gradients of ``-mean(log(clip(D(G(z)), 1e-7, 1)))`` for the
    generator's parameters, and the fake volumes."""
    params = net.param_dict()
    fake = generate_volumes(net, grid, z, resolution)
    loss = -torch.log(discriminator(fake).clamp(1e-7, 1.0)).mean()
    grads = torch.autograd.grad(loss, list(params.values()))
    return dict(zip(params, grads)), fake.detach()


def bce_grads(discriminator: Discriminator, volumes: torch.Tensor,
              target: float) -> Tuple[Grads, torch.Tensor]:
    """Gradients of the BCE of D(volumes) against ``target`` (0 for fakes, 1
    for reals) for the discriminator's parameters, and D(volumes)."""
    params = dict(discriminator.named_parameters())
    out = discriminator(volumes)
    loss = bce_loss(out, torch.full_like(out, target))
    grads = torch.autograd.grad(loss, list(params.values()))
    return dict(zip(params, grads)), out.detach()


def make_steps(net: SDFNet, discriminator: Discriminator, g_opt: Adam, d_opt: Adam,
               resolution: int = VOXEL_RESOLUTION, mesh: Optional[Mesh] = None):
    """The trainer's steps:

    * ``g_step(z)`` — one generator update from latents ``z`` [B, L];
      returns the fake volumes;
    * ``d_step(batch, z)`` — two discriminator updates, on fakes generated
      (forward only) from ``z``, then on the real ``batch``; returns the
      mean predictions.

    Under a ``mesh`` (entered by the caller) ``z`` is the global batch's,
    ``batch`` this rank's rows; the gradients and the predictions are
    averaged over the data group.
    """
    grid = voxel_coordinates(resolution, device=net.device)

    def g_step(z: torch.Tensor) -> torch.Tensor:
        grads, fake = generator_grads(net, discriminator, grid, z, resolution)
        g_opt.step(average_over_data(mesh, grads))
        return fake

    def d_step(batch: torch.Tensor, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        fake = generate_volumes_inference(net, grid, z, resolution)
        grads, pred_fake = bce_grads(discriminator, fake, 0.0)
        d_opt.step(average_over_data(mesh, grads))
        grads, pred_real = bce_grads(discriminator, batch, 1.0)
        d_opt.step(average_over_data(mesh, grads))
        return average_over_data(mesh, {"pred_fake": pred_fake.mean(),
                                        "pred_real": pred_real.mean()})

    return g_step, d_step


def _optimizer_tree(g_opt: Adam, d_opt: Adam) -> dict:
    return {"g": optimizer_tree(g_opt), "d": optimizer_tree(d_opt, gan.params_to_jax)}


def _load_optimizers(g_opt: Adam, d_opt: Adam, base: str) -> None:
    restored = checkpoints.load_tree(_optimizer_tree(g_opt, d_opt), OPT_NAME, base=base)
    load_optimizer_tree(g_opt, restored["g"])
    device = d_opt.count.device
    load_optimizer_tree(d_opt, restored["d"], lambda tree: gan.params_from_jax(tree, device=device))


def save_networks(net: SDFNet, discriminator: Discriminator, g_name: str, d_name: str, base: str,
                  epoch: Optional[int] = None) -> None:
    """The generator and the discriminator (as flax trees) to the latest
    slots, or to the snapshots of ``epoch``."""
    checkpoints.save(net.param_dict(), g_name, epoch=epoch, base=base)
    checkpoints.save(gan.params_to_jax(dict(discriminator.named_parameters())), d_name,
                     epoch=epoch, base=base)


def epoch_range(config: TrainConfig, first_epoch: int):
    """Epochs ``first_epoch`` .. ``epochs`` - 1, or on without end when no
    ``epochs`` is given (the JAX trainers' rule)."""
    return range(first_epoch, config.epochs) if config.epochs else itertools.count(first_epoch)


@tears_down_launch
def train(config: Optional[TrainConfig] = None) -> dict:
    """Train until ``epochs`` (or the divergence guard); returns the models,
    the number of steps (each a G step and a D step) and their times."""
    config = config or parse_cli()
    device = init_from_env(resolve_device(config))
    base = config.model_dir
    net, discriminator, g_opt, d_opt = create_states(config.seed, device)
    if config.resume:
        if checkpoints.exists(G_NAME, base=base):
            load_generator(net, G_NAME, base)
        if checkpoints.exists(D_NAME, base=base):
            load_critic(discriminator, D_NAME, base)
        # The moments live in a sidecar, so the parameter files keep the
        # reference's layout.
        if checkpoints.exists(OPT_NAME, base=base):
            _load_optimizers(g_opt, d_opt, base)

    dataset = resolve_voxel_dataset(config, resolution=VOXEL_RESOLUTION, rescale_sdf=False)
    batch_size = effective_batch_size(config.batch_size or BATCH_SIZE, len(dataset))
    mesh = get_mesh(batch_size=batch_size)
    if not mesh.member:
        return idle_result(mesh)
    batches = make_voxel_batches(dataset, batch_size, config.seed, config.extras, device, mesh)
    g_step, d_step = make_steps(net, discriminator, g_opt, d_opt, mesh=mesh)

    logger = CSVLogger(f"{config.plot_dir}/hybrid_gan_training.csv", resume=config.resume)
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
                        if batch_index % SLICE_EVERY == 0:
                            if viewer is not None:
                                viewer.set_voxels(fake[0])
                            maybe_print_slice(fake[0], config.show_slice, scale=SDF_CLIPPING)
                        if config.verbose:
                            print(f"Epoch {epoch}, batch {batch_index}: prediction on fake "
                                  f"samples: {history_fake.mean:.4f}, prediction on valid "
                                  f"samples: {history_real.mean:.4f}")

                print(f"Epoch {epoch} ({timer.duration:.1f}s, {profiler.mean_step_time * 1000:.1f} "
                      f"ms/step), prediction on fake: {history_fake.mean:.4f}, on real: "
                      f"{history_real.mean:.4f}", flush=True)
                if abs(history_fake.mean - history_real.mean) > DIVERGENCE_LIMIT:
                    print("Network diverged.")
                    break
                save_networks(net, discriminator, G_NAME, D_NAME, base)
                checkpoints.save(_optimizer_tree(g_opt, d_opt), OPT_NAME, base=base)
                save_networks(net, discriminator, G_NAME, D_NAME, base, epoch=epoch)
                logger.write(epoch, timer.duration, history_fake.mean, history_real.mean)
    except KeyboardInterrupt:
        pass
    finally:
        logger.close()
        if viewer is not None:
            viewer.stop()
    return {"net": net, "discriminator": discriminator, "steps": steps,
            "step_s": list(profiler.times), "viewer": viewer}


if __name__ == "__main__":
    train()
