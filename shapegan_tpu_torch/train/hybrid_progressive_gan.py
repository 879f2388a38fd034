"""Progressive hybrid WGAN-GP — the paper's headline model (counterpart of
:mod:`shapegan_tpu.train.hybrid_progressive_gan`).

    python -m shapegan_tpu_torch.train.hybrid_progressive_gan iteration=N \\
        [epochs=E] [synthetic=S] [batch_size=B] [continue] [show_slice] [cpu]

Semantics of the JAX trainer: four growth iterations (``iteration=0..3``)
at 8^3/16^3/32^3/64^3, each warm-started from the previous iteration's
checkpoints unless ``continue`` resumes the same one (then the RMSprop
sidecar is restored too); the critic updated every batch with a gradient
penalty of weight 10, the generator every ``g_every`` batches (default 5);
RMSprop (optax's rule, ``optim.py``) at 1e-4 for both; batch 16; fade-in
over the first 10 epochs of a grown iteration; saves every ``save_every``
epochs (default 1; the last epoch always) and a snapshot every 10; the CSV
``epoch time fake real gp`` in ``plots/hybrid_gan_training_<iteration>.csv``.

On the GPU the generator's volumes go through the hand-written kernels: the
grid kernel forward for the critic's fakes and the generator's loss, the
grid backward kernel for its gradients. With ``cpu`` their plain versions
run on the CPU; without it the trainer needs CUDA. The noise (latents and
the penalty's interpolation coefficients) is drawn on the device from a
``torch.Generator`` seeded per epoch, so it is not the JAX trainer's noise;
the steps take it as arguments, so a test can hand both the same. The GL
viewer is not ported: ``nogui`` is the only mode.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from shapegan_tpu_torch import LATENT_CODE_SIZE, SDF_CLIPPING, checkpoints
from shapegan_tpu_torch.core.config import TrainConfig, parse_cli, resolve_device
from shapegan_tpu_torch.models import progressive_gan
from shapegan_tpu_torch.models.progressive_gan import RESOLUTIONS, ProgressiveDiscriminator
from shapegan_tpu_torch.models.sdf_net import SDFNet
from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.ops.coords import voxel_coordinates
from shapegan_tpu_torch.ops.losses import gradient_penalty
from shapegan_tpu_torch.optim import RMSprop
from shapegan_tpu_torch.train.common import (
    CSVLogger,
    EpochTimer,
    ResidentBatches,
    RollingHistory,
    StepProfiler,
    effective_batch_size,
    maybe_print_slice,
    resolve_voxel_dataset,
)
from shapegan_tpu_torch.train.hybrid_gan import generate_volumes, generate_volumes_inference

FADE_IN_EPOCHS = 10
BATCH_SIZE = 16
GRADIENT_PENALTY_WEIGHT = 10.0
DEFAULT_EPOCHS = 250
LEARN_RATE = 1e-4
GENERATOR_UPDATE_EVERY = 5
SNAPSHOT_EVERY = 10

G_NAME = "hybrid_progressive_gan_generator_{:d}"
D_NAME = "hybrid_progressive_gan_discriminator_{:d}"
OPT_NAME = "hybrid_progressive_gan_optimizer_{:d}"

Grads = Dict[str, torch.Tensor]


def create_models(seed: int = 0, device="cpu") -> Tuple[SDFNet, ProgressiveDiscriminator]:
    """Generator and critic with fresh weights from ``seed``; the critic
    holds all four optional layers, so one parameter set serves every
    growth iteration."""
    generator = torch.Generator().manual_seed(seed)
    net = SDFNet(sdf_mlp.init(generator, device=device))
    return net, ProgressiveDiscriminator(generator=generator, device=device)


def generator_grads(net: SDFNet, discriminator: ProgressiveDiscriminator, grid: torch.Tensor,
                    z: torch.Tensor, iteration: int, fade) -> Tuple[Grads, torch.Tensor]:
    """Gradients of the generator loss ``-mean(D(G(z)))`` for the generator's
    parameters, and the fake volumes."""
    params = net.param_dict()
    fake = generate_volumes(net, grid, z, RESOLUTIONS[iteration])
    loss = -discriminator(fake, iteration, fade).mean()
    grads = torch.autograd.grad(loss, list(params.values()))
    return dict(zip(params, grads)), fake.detach()


def critic_grads(discriminator: ProgressiveDiscriminator, fake: torch.Tensor, batch: torch.Tensor,
                 alpha: torch.Tensor, iteration: int, fade) -> Tuple[Grads, Dict[str, torch.Tensor]]:
    """Gradients of the critic loss ``mean(D(fake)) - mean(D(real)) + GP`` for
    the critic's parameters (zero for the layers this iteration does not
    use), and the metrics (mean scores and the penalty)."""
    params = dict(discriminator.named_parameters())

    def critic(x):
        return discriminator(x, iteration, fade)

    pred_fake = critic(fake).mean()
    pred_real = critic(batch).mean()
    gp = gradient_penalty(critic, alpha, batch, fake, weight=GRADIENT_PENALTY_WEIGHT)
    loss = pred_fake - pred_real + gp
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    return grads, {"pred_fake": pred_fake.detach(), "pred_real": pred_real.detach(),
                   "gradient_penalty": gp.detach()}


def make_steps(net: SDFNet, discriminator: ProgressiveDiscriminator, g_opt: RMSprop,
               d_opt: RMSprop, iteration: int):
    """The G and D steps of one growth iteration:

    * ``g_step(z, fade)`` — one generator update from latents ``z`` [B, L];
      returns the fake volumes;
    * ``d_step(batch, z, alpha, fade)`` — one critic update on real volumes
      ``batch``, fakes generated (forward only) from ``z``, and penalty
      coefficients ``alpha`` [B, 1, 1, 1]; returns the metrics.
    """
    resolution = RESOLUTIONS[iteration]
    grid = voxel_coordinates(resolution, device=net.device)

    def g_step(z: torch.Tensor, fade) -> torch.Tensor:
        grads, fake = generator_grads(net, discriminator, grid, z, iteration, fade)
        g_opt.step(grads)
        return fake

    def d_step(batch: torch.Tensor, z: torch.Tensor, alpha: torch.Tensor, fade):
        fake = generate_volumes_inference(net, grid, z, resolution)
        grads, metrics = critic_grads(discriminator, fake, batch, alpha, iteration, fade)
        d_opt.step(grads)
        return metrics

    return g_step, d_step


def _optimizer_tree(g_opt: RMSprop, d_opt: RMSprop) -> dict:
    """Both optimizers' state under optax's paths (``g/0/nu/<key>``,
    ``d/0/nu/<layer>/<kernel|bias>``), in the JAX package's layouts."""
    return {"g": ({"nu": g_opt.nu},), "d": ({"nu": progressive_gan.params_to_jax(d_opt.nu)},)}


def _load_generator(net: SDFNet, name: str, base: str) -> None:
    restored = checkpoints.load_tree(net.param_dict(), name, base=base)
    with torch.no_grad():
        for key, param in net.param_dict().items():
            param.copy_(restored[key])


def _load_discriminator(discriminator: ProgressiveDiscriminator, name: str, base: str) -> None:
    params = dict(discriminator.named_parameters())
    restored = checkpoints.load_tree(progressive_gan.params_to_jax(params), name, base=base)
    restored = progressive_gan.params_from_jax(restored, device=next(iter(params.values())).device)
    with torch.no_grad():
        for key, param in params.items():
            param.copy_(restored[key])


def train(config: Optional[TrainConfig] = None) -> dict:
    """Train one growth iteration; returns the models and the step times."""
    config = config or parse_cli()
    if not config.nogui:
        raise SystemExit("the GL viewer is not ported: run without 'gui' (nogui is the default)")
    device = resolve_device(config)
    iteration = config.iteration
    resolution = RESOLUTIONS[iteration]
    epochs_total = config.epochs or DEFAULT_EPOCHS
    base = config.model_dir

    net, discriminator = create_models(config.seed, device)
    # Warm start from the previous iteration, or resume this one.
    source = iteration if config.resume else iteration - 1
    if source >= 0:
        if checkpoints.exists(G_NAME.format(source), base=base):
            _load_generator(net, G_NAME.format(source), base)
        if checkpoints.exists(D_NAME.format(source), base=base):
            _load_discriminator(discriminator, D_NAME.format(source), base)

    g_every = int(config.extras.get("g_every", GENERATOR_UPDATE_EVERY))
    learn_rate = float(config.extras.get("learn_rate", LEARN_RATE))
    d_learn_rate = float(config.extras.get("d_learn_rate", learn_rate))
    save_every = int(config.extras.get("save_every", 1))
    g_opt = RMSprop(net.param_dict(), learn_rate)
    d_opt = RMSprop(dict(discriminator.named_parameters()), d_learn_rate)
    # Same-iteration resume restores the RMSprop moments; a new growth
    # iteration starts with fresh ones.
    if config.resume and checkpoints.exists(OPT_NAME.format(iteration), base=base):
        restored = checkpoints.load_tree(_optimizer_tree(g_opt, d_opt), OPT_NAME.format(iteration),
                                         base=base)
        g_opt.nu = restored["g"][0]["nu"]
        d_opt.nu = progressive_gan.params_from_jax(restored["d"][0]["nu"], device=device)

    dataset = resolve_voxel_dataset(config, resolution=resolution, rescale_sdf=False)
    batch_size = effective_batch_size(config.batch_size or BATCH_SIZE, len(dataset))
    batches = ResidentBatches(dataset, batch_size, config.seed, device)
    batches_per_epoch = max(1, len(batches))
    g_step, d_step = make_steps(net, discriminator, g_opt, d_opt, iteration)

    logger = CSVLogger(f"{config.plot_dir}/hybrid_gan_training_{iteration}.csv",
                       resume=config.resume)
    history_fake, history_real, history_gp = RollingHistory(), RollingHistory(), RollingHistory()
    g_profiler, d_profiler = StepProfiler(device), StepProfiler(device)
    noise = torch.Generator(device=device)
    fading = (not config.resume) and iteration > 0

    try:
        for epoch in range(logger.first_epoch, epochs_total):
            # Epoch-deterministic noise, so a resumed run replays its epochs.
            noise.manual_seed((config.seed + 1) * 1_000_003 + epoch)
            batches.set_epoch(epoch)
            with EpochTimer() as timer:
                for batch_index, batch in enumerate(batches):
                    fade = ((epoch + batch_index / batches_per_epoch) / FADE_IN_EPOCHS
                            if fading else 1.0)
                    if batch_index % g_every == 0:
                        z = torch.randn((batch_size, LATENT_CODE_SIZE), generator=noise,
                                        device=device)
                        with g_profiler:
                            fake = g_step(z, fade)
                        if batch_index % 50 == 0:
                            maybe_print_slice(fake[0], config.show_slice, scale=SDF_CLIPPING)
                    z = torch.randn((batch_size, LATENT_CODE_SIZE), generator=noise, device=device)
                    alpha = torch.rand((batch_size, 1, 1, 1), generator=noise, device=device)
                    with d_profiler:
                        metrics = d_step(batch, z, alpha, fade)
                    history_fake.append(metrics["pred_fake"])
                    history_real.append(metrics["pred_real"])
                    history_gp.append(metrics["gradient_penalty"])
                    if config.verbose and batch_index % 50 == 0:
                        print(f"Epoch {epoch}, batch {batch_index}: "
                              f"D(x'): {history_fake.mean:.4f}, D(x): {history_real.mean:.4f}, "
                              f"loss: {history_real.mean - history_fake.mean:.4f}, "
                              f"gradient penalty: {history_gp.mean:.4f}")

            print(f"Epoch {epoch} ({timer.duration:.1f}s, G {g_profiler.mean_step_time * 1000:.1f} "
                  f"ms/step, D {d_profiler.mean_step_time * 1000:.1f} ms/step) [{resolution}^3], "
                  f"D(x'): {history_fake.mean:.4f}, D(x): {history_real.mean:.4f}, "
                  f"loss: {history_real.mean - history_fake.mean:.4f}, "
                  f"gradient penalty: {history_gp.mean:.4f}", flush=True)

            if (epoch + 1) % save_every == 0 or epoch == epochs_total - 1:
                checkpoints.save(net.param_dict(), G_NAME.format(iteration), base=base)
                checkpoints.save(progressive_gan.params_to_jax(dict(discriminator.named_parameters())),
                                 D_NAME.format(iteration), base=base)
                checkpoints.save(_optimizer_tree(g_opt, d_opt), OPT_NAME.format(iteration), base=base)
            if epoch % SNAPSHOT_EVERY == 0:
                checkpoints.save(net.param_dict(), G_NAME.format(iteration), epoch=epoch, base=base)
                checkpoints.save(progressive_gan.params_to_jax(dict(discriminator.named_parameters())),
                                 D_NAME.format(iteration), epoch=epoch, base=base)
            logger.write(epoch, timer.duration, history_fake.mean, history_real.mean,
                         history_gp.mean)
    except KeyboardInterrupt:
        pass
    finally:
        logger.close()
    return {"net": net, "discriminator": discriminator,
            "g_step_s": list(g_profiler.times), "d_step_s": list(d_profiler.times)}


if __name__ == "__main__":
    train()
