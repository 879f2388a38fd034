"""DeepSDF autodecoder trainer: co-optimize the implicit MLP and a per-shape
latent table (counterpart of :mod:`shapegan_tpu.train.sdf_autodecoder`).

    python -m shapegan_tpu_torch.train.sdf_autodecoder [cpu] [synthetic=N] \\
        [pointcloud_size=P] [epochs=E] [batch_size=B] [scale_lr] [continue]

Semantics of the JAX trainer: the whole point dataset lives on the device
(points [S*P, 3], sdf clipped to +-0.1); the latent table starts N(0, 1e-4);
two Adams (optax's rule, ``optim.py``) at lr 1e-5, one for the network and
one for the table; each epoch draws sign-balanced batches of 20,000 indices
from ``default_rng((seed, epoch))`` (the last batch padded with random
repeats); a point's shape is ``index // pointcloud_size``; the loss is L1
on the clipped SDF plus 0.01 * mean(z^2) over the batch's latent rows; the
network, the table and both Adams' moments are saved every epoch, with
per-epoch snapshots of the network and the table; the CSV
``plots/sdf_net_training.csv`` has ``epoch time loss latent_std`` and its
line count is the epoch to resume from. ``scale_lr`` scales the learning
rate with a non-default batch.

On the GPU the MLP runs through the hand-written rowwise kernels: the
rowwise kernel forward and the rowwise backward kernel for its gradients
(``ops.sdf_mlp_kernels.apply_rowwise``); autograd carries the gradient
through the bf16 latent terms to the table (a scatter-add of the gathered
rows). With ``cpu`` their plain versions run on the CPU; without it the
trainer needs CUDA. The network starts from ``sdf_mlp.init`` with a
``torch.Generator`` seeded from ``seed`` and the table from one seeded from
``seed + 1``, so neither is the JAX trainer's draw.

Not ported: the multi-chip epoch (``make_sharded_epoch``, the dataset and
table sharded by shape), the GL viewer (``gui``), and ``lax.scan`` over the
epoch: here each step is a Python call, the epoch's index batches go to the
device once, and the losses stay there until the epoch's end.
"""

from __future__ import annotations

import os
import time
from itertools import count
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from shapegan_tpu_torch import LATENT_CODE_SIZE, checkpoints
from shapegan_tpu_torch.core.config import TrainConfig, parse_cli, resolve_device
from shapegan_tpu_torch.models import LATENT_CODES_FILENAME
from shapegan_tpu_torch.models.sdf_net import SDFNet
from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.ops.sdf_mlp_kernels import apply_rowwise
from shapegan_tpu_torch.optim import Adam
from shapegan_tpu_torch.train.common import CSVLogger, EpochTimer, effective_batch_size

POINTCLOUD_SIZE = 200000
SYNTHETIC_POINTCLOUD_SIZE = 20000  # the JAX trainer's default for synthetic=N
BATCH_SIZE = 20000
SDF_CUTOFF = 0.1
SIGMA = 0.01
LEARNING_RATE = 1e-5

NET_NAME = "sdf_net"
OPT_NAME = "sdf_net_optimizer"


def load_pointcloud(config: TrainConfig):
    """(points [S*P, 3], sdf [S*P], P): synthetic shapes, or the monolithic
    ``sdf_points.npy`` / ``sdf_values.npy`` in ``data_dir``."""
    if config.synthetic:
        from shapegan_tpu_torch.data.synthetic import make_sdf_pointcloud

        pointcloud_size = int(config.extras.get("pointcloud_size", SYNTHETIC_POINTCLOUD_SIZE))
        points, sdf = make_sdf_pointcloud(config.synthetic, pointcloud_size, seed=config.seed)
        return points, sdf, pointcloud_size
    points = np.load(os.path.join(config.data_dir, "sdf_points.npy"))
    sdf = np.load(os.path.join(config.data_dir, "sdf_values.npy"))
    pointcloud_size = int(config.extras.get("pointcloud_size", POINTCLOUD_SIZE))
    return points.astype(np.float32), sdf.astype(np.float32), pointcloud_size


def create_batches(signs: np.ndarray, batch_size: int,
                   rng: np.random.Generator) -> Iterator[np.ndarray]:
    """Sign-balanced shuffled index batches: the majority sign subsampled to
    the minority's count, shuffled, cut into batches; the last partial batch
    padded with random repeats (the JAX trainer's draws, in its order)."""
    positive = np.nonzero(signs)[0]
    negative = np.nonzero(~signs)[0]
    if positive.shape[0] == 0 or negative.shape[0] == 0:
        raise ValueError(
            "SDF dataset has samples of only one sign "
            f"({positive.shape[0]} positive / {negative.shape[0]} negative); "
            "sign-balanced batching needs both — check the data preparation.")
    if negative.shape[0] > positive.shape[0]:
        rng.shuffle(negative)
        negative = negative[: positive.shape[0]]
    else:
        rng.shuffle(positive)
        positive = positive[: negative.shape[0]]
    indices = np.concatenate((negative, positive))
    rng.shuffle(indices)
    for i in range(0, max(len(indices), 1), batch_size):
        chunk = indices[i: i + batch_size]
        if len(chunk) == 0:
            return
        if len(chunk) < batch_size:
            pad = rng.choice(indices, batch_size - len(chunk))
            chunk = np.concatenate([chunk, pad])
        yield chunk


def loss_and_grads(params: Dict[str, torch.Tensor], latent_codes: torch.Tensor,
                   points: torch.Tensor, sdf: torch.Tensor, indices: torch.Tensor,
                   pointcloud_size: int, apply: Callable = apply_rowwise):
    """The step's loss and its gradients for the network's parameters and
    the latent table: gather the batch's points, SDF values and latent rows,
    run the MLP (``apply(params, points, rows)``: the trainer's is
    :func:`apply_rowwise`), L1 + SIGMA * mean(rows^2) in float32."""
    batch_points = points.index_select(0, indices)
    batch_sdf = sdf.index_select(0, indices)
    rows = latent_codes.index_select(0, torch.div(indices, pointcloud_size, rounding_mode="floor"))
    output = apply(params, batch_points, rows)
    loss = (output - batch_sdf).abs().mean() + SIGMA * (rows * rows).mean()
    grads = torch.autograd.grad(loss, [*params.values(), latent_codes])
    return loss.detach(), dict(zip(params, grads[:-1])), grads[-1]


def _optimizer_tree(net_opt: Adam, code_opt: Adam) -> dict:
    """Both Adams' state under optax's paths (``net/0/mu/<param>``,
    ``codes/0/mu`` …)."""
    codes = code_opt.state()
    return {"net": (net_opt.state(),),
            "codes": ({"count": codes["count"], "mu": codes["mu"]["codes"],
                       "nu": codes["nu"]["codes"]},)}


def _load_optimizers(net_opt: Adam, code_opt: Adam, base: str) -> None:
    restored = checkpoints.load_tree(_optimizer_tree(net_opt, code_opt), OPT_NAME, base=base,
                                     strict=True)
    net_opt.load_state(restored["net"][0])
    codes = restored["codes"][0]
    code_opt.load_state({"count": codes["count"], "mu": {"codes": codes["mu"]},
                         "nu": {"codes": codes["nu"]}})


def train(config: Optional[TrainConfig] = None) -> dict:
    """Train; returns the network, the latent table, and each epoch's step
    count and mean step time."""
    config = config or parse_cli()
    if not config.nogui:
        raise SystemExit("the GL viewer is not ported: run without 'gui' (nogui is the default)")
    device = resolve_device(config)
    base = config.model_dir

    points_np, sdf_np, pointcloud_size = load_pointcloud(config)
    model_count = points_np.shape[0] // pointcloud_size
    sdf_np = np.clip(sdf_np, -SDF_CUTOFF, SDF_CUTOFF)
    signs = sdf_np > 0
    batch_size = effective_batch_size(config.batch_size or BATCH_SIZE, points_np.shape[0])
    points = torch.tensor(points_np, device=device)
    sdf = torch.tensor(sdf_np, device=device)

    net = SDFNet(sdf_mlp.init(torch.Generator().manual_seed(config.seed), device=device))
    codes_gen = torch.Generator().manual_seed(config.seed + 1)
    latent_codes = (torch.randn((model_count, LATENT_CODE_SIZE), generator=codes_gen)
                    * 1e-4).to(device)

    lr = LEARNING_RATE
    if config.extras.get("scale_lr") and batch_size != BATCH_SIZE:
        lr = LEARNING_RATE * (batch_size / BATCH_SIZE)
        print(f"scale_lr: batch {batch_size} -> lr {lr:.3e} "
              f"(linear scaling vs reference batch {BATCH_SIZE})")

    if config.resume and checkpoints.exists(NET_NAME, base=base):
        restored = checkpoints.load_tree(net.param_dict(), NET_NAME, base=base, strict=True)
        with torch.no_grad():
            for key, param in net.param_dict().items():
                param.copy_(restored[key])
        # The table is gated on its own file: a network without its table is
        # an inconsistent checkpoint, not a fresh start.
        if not checkpoints.exists(LATENT_CODES_FILENAME, base=base):
            raise FileNotFoundError(
                f"resume: {checkpoints.get_filename(NET_NAME, base=base)} exists "
                f"but {checkpoints.get_filename(LATENT_CODES_FILENAME, base=base)} "
                "is missing — the checkpoint pair is inconsistent; restore the latent table "
                "or remove the network file to start fresh")
        loaded = checkpoints.load_array(LATENT_CODES_FILENAME, base=base)
        if loaded.shape[0] != model_count:
            raise ValueError(
                f"resume: latent table has {loaded.shape[0]} rows but the dataset "
                f"has {model_count} shapes — checkpoint belongs to a different dataset")
        latent_codes = torch.tensor(loaded, dtype=torch.float32, device=device)
    latent_codes.requires_grad_(True)

    params = net.param_dict()
    net_opt = Adam(params, lr)
    code_opt = Adam({"codes": latent_codes}, lr)
    if config.resume and checkpoints.exists(OPT_NAME, base=base):
        _load_optimizers(net_opt, code_opt, base)

    logger = CSVLogger(f"{config.plot_dir}/sdf_net_training.csv", resume=config.resume)
    epochs = range(logger.first_epoch, config.epochs) if config.epochs else count(logger.first_epoch)
    step_ms, steps = [], []
    try:
        for epoch in epochs:
            np_rng = np.random.default_rng((config.seed, epoch))
            with EpochTimer() as timer:
                batches = torch.tensor(np.stack(list(create_batches(signs, batch_size, np_rng))),
                                       dtype=torch.int64, device=device)
                losses = torch.empty(batches.shape[0], dtype=torch.float32, device=device)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                for i in range(batches.shape[0]):
                    loss, net_grads, code_grad = loss_and_grads(
                        params, latent_codes, points, sdf, batches[i], pointcloud_size)
                    net_opt.step(net_grads)
                    code_opt.step({"codes": code_grad})
                    losses[i] = loss
                loss_values = losses.cpu().numpy()  # the epoch's one wait for the device
                step_ms.append((time.perf_counter() - t0) * 1e3 / batches.shape[0])
                steps.append(batches.shape[0])

            latent_std = float(np.std(latent_codes.detach().cpu().numpy().reshape(-1)))
            mean_loss = float(np.mean(loss_values))
            print(f"Epoch {epoch}, {timer.duration:.1f}s ({step_ms[-1]:.1f} ms/step). "
                  f"Loss: {mean_loss:.8f}", flush=True)

            codes = latent_codes.detach()
            checkpoints.save(params, NET_NAME, base=base)
            checkpoints.save_array(codes, LATENT_CODES_FILENAME, base=base)
            checkpoints.save(_optimizer_tree(net_opt, code_opt), OPT_NAME, base=base)
            checkpoints.save(params, NET_NAME, epoch=epoch, base=base)
            checkpoints.save_array(codes, LATENT_CODES_FILENAME, epoch=epoch, base=base)
            logger.write(epoch, timer.duration, mean_loss, latent_std)
    except KeyboardInterrupt:
        pass
    finally:
        logger.close()
    return {"net": net, "latent_codes": latent_codes.detach(), "steps": steps, "step_ms": step_ms}


if __name__ == "__main__":
    train()
