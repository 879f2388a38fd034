"""Point-GAN refinement trainer, the surface-aware second stage (counterpart
of :mod:`shapegan_tpu.train.point_gan_ref`).

    python -m shapegan_tpu_torch.train.point_gan_ref [cpu] [synthetic=N] [epochs=E] \\
        [category=C] [continue]

Semantics of the JAX trainer: the generator is refined (:func:`refine`):
the uniform positions are evaluated, moved along the generator's own
spatial gradient to its zero set (``s_pos = u_pos - u_dist * grad``, the
gradient not normalized), jittered by 0.0025 and evaluated again. The
critic sees mixed batches (:func:`mixed_batch`): the uniform points with
``|u_dist| < 0.1`` or a 15 % random keep, and the surface points beside
uniform ones with ``|u_dist| < 0.1``, as static [B, 2N] shapes with a mask
the PointNet's max pool honours. WGAN-GP on the mixed batches, the penalty on the unmasked uniform
positions interpolating the real and the fake uniform distances; RMSprop at
1e-4 for both; the critic every step, the generator every 5th global step;
the curriculum (8192, b16) → (16384, b8), 60 epochs each, ``epochs``
capping each stage, a stage skipped when the dataset fills no batch. The
run warm-starts from the stage-1 files ``point_gan_generator`` /
``point_gan_discriminator`` when they exist; every epoch writes
``point_gan_ref_generator`` / ``point_gan_ref_discriminator`` (flax trees)
and the RMSprop sidecar ``point_gan_ref_optimizer`` (optax's paths
``g/0/nu/...``, ``d/0/nu/...``), files that load both ways with the JAX
package, and a line ``num_points epoch seconds mean|d_loss|`` of
``plots/point_gan_ref_training.csv``. ``continue`` restores the three files,
fast-forwards the epochs the CSV records, and every draw is keyed by the
global epoch or step, so a resumed run reproduces the uninterrupted one.

Precision, as in the JAX trainer: the D step refines with the bf16
generator and stops the gradient at its result; the spatial gradient comes
from one autograd pass of the bf16 module, and the second evaluation goes
through :func:`~shapegan_tpu_torch.ops.point_gen_kernels.generate_best`
(on the GPU the hand-written generator kernel; with ``cpu`` the bf16
module). The G step differentiates :func:`refine` itself in float32: the
loss's gradient flows through the spatial gradient, a double backward
through the module (no kernel). The steps take their noise as arguments,
so a test can hand both packages the same.

Data-parallel under ``python -m torch.distributed.run --nproc_per_node=N``,
as the JAX trainer's per-stage mesh and the point GAN's
(:mod:`shapegan_tpu_torch.train.point_gan`): each curriculum stage trains
on ``gcd(N, stage batch)`` ranks, each on its rows of every batch and of
the step's noise (drawn for the global batch from the same seeded
generator); the D step's second evaluation runs the generator kernel on a
rank's rows, the G step's double backward too, and the gradients and the
metrics are averaged over the data group. Ranks outside a stage's mesh
wait through it and keep the step count; rank 0's networks and moments go
to every rank at each stage change and at the end; rank 0 writes the
files.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from shapegan_tpu_torch import checkpoints
from shapegan_tpu_torch.core.config import TrainConfig, parse_cli, resolve_device
from shapegan_tpu_torch.data.datasets import BatchLoader
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
from shapegan_tpu_torch.train.point_gan import D_NAME as STAGE1_D_NAME
from shapegan_tpu_torch.train.point_gan import G_NAME as STAGE1_G_NAME
from shapegan_tpu_torch.train.point_gan import (
    GRADIENT_PENALTY,
    LATENT_SIZE,
    LEARN_RATE,
    _load_module,
    _load_optimizers,
    _optimizer_tree,
    _replicate,
    create_models,
    resolve_point_dataset,
    to_device,
)

THRESHOLD = 0.1
RANDOM_KEEP = 0.15
JITTER = 0.0025
GENERATOR_UPDATE_EVERY = 5

# (num_points, batch_size, epochs)
CURRICULUM = [
    (8192, 16, 60),
    (16384, 8, 60),
]

G_NAME = "point_gan_ref_generator"
D_NAME = "point_gan_ref_discriminator"
OPT_NAME = "point_gan_ref_optimizer"

Grads = Dict[str, torch.Tensor]
Cloud = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def refine(generator: SDFGenerator, u_pos: torch.Tensor, z: torch.Tensor, jitter: torch.Tensor,
           dtype: Optional[torch.dtype] = None, create_graph: bool = False,
           evaluate: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> Cloud:
    """The refinement forward: ``u_dist = G(u_pos, z)``, its gradient with
    respect to the positions (of ``sum(G)``), ``s_pos = u_pos - u_dist *
    grad + JITTER * jitter`` and ``s_dist = G(s_pos, z)``; returns (u_pos,
    u_dist, s_pos, s_dist). ``jitter`` [B, N, 3] is N(0, 1) noise. The
    generator runs in ``dtype`` (its own if None); ``create_graph`` keeps
    the spatial gradient differentiable (the G step's double backward);
    ``evaluate`` makes the second evaluation instead of the module."""
    with torch.enable_grad():
        pos = u_pos.detach().requires_grad_(True)
        u_dist = generator(pos, z, dtype=dtype)
        (grad,) = torch.autograd.grad(u_dist.sum(), pos, create_graph=create_graph)
    s_pos = u_pos - u_dist * grad + JITTER * jitter
    s_dist = generator(s_pos, z, dtype=dtype) if evaluate is None else evaluate(s_pos)
    return u_pos, u_dist, s_pos, s_dist


def mixed_batch(u_pos: torch.Tensor, u_dist: torch.Tensor, s_pos: torch.Tensor,
                s_dist: torch.Tensor, keep_uniform: torch.Tensor):
    """The masked union of the uniform points near the surface or kept
    (``keep_uniform`` [B, N] U(0, 1) < 15 %) and the surface points whose
    uniform point was near it (``|u_dist| < 0.1`` on both halves, as the
    JAX trainer): positions [B, 2N, 3], distances [B, 2N, 1] and the mask
    [B, 2N]."""
    near = u_dist[..., 0].abs() < THRESHOLD
    pos = torch.cat([u_pos, s_pos], dim=1)
    dist = torch.cat([u_dist, s_dist], dim=1)
    mask = torch.cat([near | (keep_uniform < RANDOM_KEEP), near], dim=1)
    return pos, dist, mask


def critic_grads(discriminator: PointNet, real: Cloud, fake: Cloud, keep_real: torch.Tensor,
                 keep_fake: torch.Tensor, alpha: torch.Tensor) -> Tuple[Grads, Dict[str, torch.Tensor]]:
    """Gradients of ``mean(D(fake mixed)) - mean(D(real mixed)) + GP`` for
    the critic's parameters. ``real`` and ``fake`` are (u_pos, u_dist,
    s_pos, s_dist) clouds, the fake one without a graph; the penalty acts on
    the unmasked uniform positions and interpolates the real and the fake
    uniform distances by ``alpha`` [B, 1, 1]. Also returns the metrics
    (``d_loss`` without the penalty, ``gradient_penalty``)."""
    params = dict(discriminator.named_parameters())
    fake_pos, fake_dist, fake_mask = mixed_batch(*fake, keep_fake)
    real_pos, real_dist, real_mask = mixed_batch(*real, keep_real)
    out_real = discriminator(real_pos, real_dist, mask=real_mask)[..., 0]
    out_fake = discriminator(fake_pos, fake_dist, mask=fake_mask)[..., 0]
    d_loss = out_fake.mean() - out_real.mean()
    u_pos = real[0]

    def critic(dist):
        return discriminator(u_pos, dist)[..., 0]

    gp = gradient_penalty(critic, alpha, real[1], fake[1], weight=GRADIENT_PENALTY)
    grads = torch.autograd.grad(d_loss + gp, list(params.values()))
    return dict(zip(params, grads)), {"d_loss": d_loss.detach(), "gradient_penalty": gp.detach()}


def generator_grads(generator: SDFGenerator, discriminator: PointNet, u_pos: torch.Tensor,
                    z: torch.Tensor, jitter: torch.Tensor,
                    keep: torch.Tensor) -> Tuple[Grads, torch.Tensor]:
    """Gradients of ``-mean(D(mixed refine(G)))`` for the generator's
    parameters, the generator run in float32 and differentiated through its
    own spatial gradient; and the loss."""
    params = dict(generator.named_parameters())
    fake = refine(generator, u_pos, z, jitter, dtype=torch.float32, create_graph=True)
    pos, dist, mask = mixed_batch(*fake, keep)
    loss = -discriminator(pos, dist, mask=mask)[..., 0].mean()
    grads = torch.autograd.grad(loss, list(params.values()))
    return dict(zip(params, grads)), loss.detach()


def make_steps(generator: SDFGenerator, discriminator: PointNet, g_opt: RMSprop, d_opt: RMSprop,
               mesh: Optional[Mesh] = None):
    """The two steps:

    * ``d_step(real, noise)`` — one critic update on the real cloud (u_pos,
      u_dist, s_pos, s_dist) and the bf16 generator's refined fake from
      ``noise`` (a :func:`step_noise` dict: ``z``, ``jitter``,
      ``keep_real``, ``keep_fake``, ``alpha``); returns the metrics;
    * ``g_step(u_pos, noise)`` — one generator update (``noise``: ``z``,
      ``jitter``, ``keep``); returns its loss.

    Under a ``mesh`` the clouds are this rank's rows and the noise the
    global batch's; the gradients and the metrics are averaged over the
    data group.
    """
    g_params = dict(generator.named_parameters())

    def d_step(real: Cloud, noise: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        noise = {k: shard_batch(mesh, v) for k, v in noise.items()}
        z = noise["z"]
        with torch.no_grad():  # refine's spatial gradient turns autograd on for itself
            fake = refine(generator, real[0], z, noise["jitter"],
                          evaluate=lambda s_pos: generate_best(generator, g_params, s_pos, z))
        fake = tuple(t.detach() for t in fake)
        grads, metrics = critic_grads(discriminator, real, fake, noise["keep_real"],
                                      noise["keep_fake"], noise["alpha"])
        d_opt.step(average_over_data(mesh, grads))
        return average_over_data(mesh, metrics)

    def g_step(u_pos: torch.Tensor, noise: Dict[str, torch.Tensor]) -> torch.Tensor:
        noise = {k: shard_batch(mesh, v) for k, v in noise.items()}
        grads, loss = generator_grads(generator, discriminator, u_pos, noise["z"], noise["jitter"],
                                      noise["keep"])
        g_opt.step(average_over_data(mesh, grads))
        return average_over_data(mesh, {"loss": loss})["loss"]

    return d_step, g_step


def step_noise(noise: torch.Generator, seed: int, step: int, batch: int, points: int, device):
    """The noise of global step ``step`` (1-based): the D step's (latents
    [B, L], jitter [B, N, 3], the real and the fake batch's keep uniforms
    [B, N], penalty coefficients [B, 1, 1]) and the G step's (latents,
    jitter, keep uniforms)."""
    noise.manual_seed((seed + 1) * 1_000_003 + step)

    def draw(*keeps):
        return {"z": torch.randn((batch, LATENT_SIZE), generator=noise, device=device),
                "jitter": torch.randn((batch, points, 3), generator=noise, device=device),
                **{k: torch.rand((batch, points), generator=noise, device=device) for k in keeps}}

    d = draw("keep_real", "keep_fake")
    d["alpha"] = torch.rand((batch, 1, 1), generator=noise, device=device)
    return d, draw("keep")


def restore_models(generator: SDFGenerator, discriminator: PointNet, base: str,
                   resume: bool) -> List[str]:
    """The warm start from the stage-1 files, then with ``resume`` this
    trainer's own, each where it exists; returns the names loaded."""
    pairs = [(generator, STAGE1_G_NAME), (discriminator, STAGE1_D_NAME)]
    if resume:
        pairs += [(generator, G_NAME), (discriminator, D_NAME)]
    loaded = []
    for module, name in pairs:
        if checkpoints.exists(name, base=base):
            _load_module(module, name, base)
            loaded.append(name)
    return loaded


@tears_down_launch
def train(config: Optional[TrainConfig] = None, curriculum=None) -> dict:
    """Run the curriculum; returns the models, the files the run started
    from (``loaded``), the number of steps this call ran (``steps``; a
    resume skips the completed epochs' steps) and the D and G step times."""
    config = config or parse_cli()
    device = init_from_env(resolve_device(config))
    base = config.model_dir
    generator, discriminator = create_models(config.seed, device)
    loaded = restore_models(generator, discriminator, base, config.resume)
    g_opt = RMSprop(dict(generator.named_parameters()), LEARN_RATE)
    d_opt = RMSprop(dict(discriminator.named_parameters()), LEARN_RATE)
    if config.resume and checkpoints.exists(OPT_NAME, base=base):
        _load_optimizers(g_opt, d_opt, base, OPT_NAME)
        loaded.append(OPT_NAME)

    dataset = resolve_point_dataset(config)
    everyone = get_mesh(points=1)
    logger = CSVLogger(f"{config.plot_dir}/point_gan_ref_training.csv", resume=config.resume)
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
                    for uniform, surface in loader:
                        num_steps += 1
                        steps_run += 1
                        u = to_device(shard_batch(mesh, uniform), device)
                        s = to_device(shard_batch(mesh, surface), device)
                        real = (u[..., :3], u[..., 3:], s[..., :3], s[..., 3:])
                        d_noise, g_noise = step_noise(noise, config.seed, num_steps, batch_size,
                                                      num_points, device)
                        with d_profiler:
                            metrics = d_step(real, d_noise)
                        if num_steps % GENERATOR_UPDATE_EVERY == 0:
                            with g_profiler:
                                g_step(real[0], g_noise)
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
    return {"generator": generator, "discriminator": discriminator, "loaded": loaded,
            "steps": steps_run, "d_step_s": list(d_profiler.times),
            "g_step_s": list(g_profiler.times)}


if __name__ == "__main__":
    train()
