"""(Variational) autoencoder trainer (counterpart of
:mod:`shapegan_tpu.train.autoencoder`).

    python -m shapegan_tpu_torch.train.autoencoder [classic] [epochs=E] \\
        [synthetic=S] [batch_size=B] [continue] [show_slice] [verbose] [cpu]

Semantics of the JAX trainer: the VAE, or the classic autoencoder with
``classic``; one Adam step (optax's rule, lr 5e-5) a batch on the
sign-weighted L1 reconstruction loss plus, for the VAE, the KL divergence;
BatchNorm keeps each step's batch statistics; batch 32; SDF volumes clamped
to ±0.1 and rescaled to ±1. Every epoch saves ``autoencoder-128`` (or
``variational-autoencoder-128``) with flax's ``params`` and ``batch_stats``,
the Adam's ``opt_state`` (``opt_state/0/count``, ``opt_state/0/mu/...``) and
``epoch``, a snapshot every 20th epoch, and a line ``epoch time
reconstruction_loss kld_loss voxel_diff`` of
``plots/[variational_]autoencoder_training.csv`` (rolling means over the
last ``batch_size`` steps, the last step's sign difference). ``continue``
restores the file and resumes at its ``epoch`` + 1.

The VAE's reparameterization noise is drawn on the device from a
``torch.Generator`` seeded per epoch (not the JAX trainer's); the step takes
it as an argument, so a test can hand both packages the same. The
convolutions are cuDNN's (no hand kernel runs). With ``gui`` the live
viewer (``train.common.make_viewer``, rank 0's) shows the first
reconstruction of an epoch's first batch, and with ``verbose`` also every
20th batch's.

Data-parallel under ``python -m torch.distributed.run --nproc_per_node=N``,
as the JAX trainer's mesh: ``gcd(N, B)`` ranks each take their rows of
every global batch and of the VAE's noise; BatchNorm takes the global
batch's statistics (summed over the data group, its running statistics
alike on every rank); the gradients and the metrics are averaged over the
data group; rank 0 writes the files.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from shapegan_tpu_torch import checkpoints
from shapegan_tpu_torch.core.config import TrainConfig, parse_cli, resolve_device
from shapegan_tpu_torch.models.autoencoder import Autoencoder
from shapegan_tpu_torch.ops.losses import kld_loss, sdf_reconstruction_loss, voxel_sign_difference
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
    average_over_data,
    RollingHistory,
    StepProfiler,
    effective_batch_size,
    idle_result,
    load_network,
    make_viewer,
    make_voxel_batches,
    maybe_print_slice,
    network_payload,
    resolve_voxel_dataset,
)
from shapegan_tpu_torch.train.hybrid_gan import epoch_range

BATCH_SIZE = 32
LEARNING_RATE = 5e-5
SNAPSHOT_EVERY = 20
VIEWER_UPDATE_STEP = 20


def create_state(is_variational: bool, seed: int = 0, device="cpu") -> Tuple[Autoencoder, Adam]:
    """The model with fresh weights from ``seed``, and its Adam."""
    model = Autoencoder(is_variational, generator=torch.Generator().manual_seed(seed), device=device)
    return model, Adam(dict(model.named_parameters()), LEARNING_RATE)


def make_step(model: Autoencoder, opt: Adam, mesh: Optional[Mesh] = None):
    """``train_step(batch, eps)``: one update on ``batch`` (``eps`` [B, 128],
    the VAE's noise; ignored by the classic model); returns the metrics and
    the reconstruction. Under a ``mesh`` (entered by the caller) ``batch``
    is this rank's rows and ``eps`` the global batch's; the gradients and
    the metrics are averaged over the data group."""
    params = dict(model.named_parameters())

    def train_step(batch: torch.Tensor, eps: Optional[torch.Tensor]
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        eps = shard_batch(mesh, eps)
        if model.is_variational:
            output, mean, log_variance = model(batch, train=True, eps=eps)
            kld = kld_loss(mean, log_variance)
        else:
            output = model(batch, train=True)
            kld = torch.zeros((), device=batch.device)
        recon = sdf_reconstruction_loss(output, batch)
        grads = torch.autograd.grad(recon + kld, list(params.values()))
        opt.step(average_over_data(mesh, dict(zip(params, grads))))
        output = output.detach()
        return average_over_data(mesh, {
            "reconstruction_loss": recon.detach(), "kld_loss": kld.detach(),
            "voxel_diff": voxel_sign_difference(output, batch)}), output

    return train_step


@tears_down_launch
def train(config: Optional[TrainConfig] = None) -> dict:
    """Train until ``epochs``; returns the model, its optimizer, the number
    of steps and their times."""
    config = config or parse_cli()
    device = init_from_env(resolve_device(config))
    base = config.model_dir
    model, opt = create_state(not config.classic, config.seed, device)
    name = model.checkpoint_name

    dataset = resolve_voxel_dataset(config, resolution=32)
    batch_size = effective_batch_size(config.batch_size or BATCH_SIZE, len(dataset))
    mesh = get_mesh(batch_size=batch_size)
    if not mesh.member:
        return idle_result(mesh)
    batches = make_voxel_batches(dataset, batch_size, config.seed, config.extras, device, mesh)
    first_epoch = 0
    if config.resume and checkpoints.exists(name, base=base):
        first_epoch = load_network(model, opt, name, base) + 1
    train_step = make_step(model, opt, mesh)

    prefix = "variational_" if model.is_variational else ""
    logger = CSVLogger(f"{config.plot_dir}/{prefix}autoencoder_training.csv", resume=config.resume)
    viewer = make_viewer(config.nogui)
    recon_history, kld_history = RollingHistory(batch_size), RollingHistory(batch_size)
    profiler = StepProfiler(device)
    noise = torch.Generator(device=device)
    steps = 0
    try:
        with mesh:
            for epoch in epoch_range(config, first_epoch):
                # Epoch-deterministic noise, so a resumed run replays its epochs.
                noise.manual_seed((config.seed + 1) * 1_000_003 + epoch)
                batches.set_epoch(epoch)
                with EpochTimer() as timer:
                    for batch_index, batch in enumerate(batches):
                        eps = torch.randn((batch_size, model.latent_code_size), generator=noise,
                                          device=device)
                        with profiler:
                            metrics, output = train_step(batch, eps)
                        steps += 1
                        recon_history.append(metrics["reconstruction_loss"])
                        kld_history.append(metrics["kld_loss"])
                        if viewer is not None and (
                                batch_index == 0
                                or ((batch_index + 1) % VIEWER_UPDATE_STEP == 0 and config.verbose)):
                            viewer.set_voxels(output[0])
                        if config.verbose and (batch_index + 1) % VIEWER_UPDATE_STEP == 0:
                            print(f"epoch {epoch}, batch {batch_index}, reconstruction loss: "
                                  f"{float(metrics['reconstruction_loss']):.4f} (average: "
                                  f"{recon_history.mean:.4f}), KLD loss: {kld_history.mean:.4f}")

                payload = network_payload(model, opt, epoch)
                checkpoints.save(payload, name, base=base)
                if epoch % SNAPSHOT_EVERY == 0:
                    checkpoints.save(payload, name, epoch=epoch, base=base)
                maybe_print_slice(output[0], config.show_slice)
                print(f"Epoch {epoch} ({timer.duration:.1f}s, {profiler.mean_step_time * 1000:.1f} "
                      f"ms/step): reconstruction loss: {recon_history.mean:.4f}, KLD loss: "
                      f"{kld_history.mean:.4f}", flush=True)
                logger.write(epoch, timer.duration, recon_history.mean, kld_history.mean,
                             float(metrics["voxel_diff"]))
    except KeyboardInterrupt:
        pass
    finally:
        logger.close()
        if viewer is not None:
            viewer.stop()
    return {"model": model, "opt": opt, "steps": steps, "step_s": list(profiler.times),
            "viewer": viewer}


if __name__ == "__main__":
    train()
