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

With several ranks (``python -m torch.distributed.run``, or
:func:`shapegan_tpu_torch.parallel.mesh.spawn`) the epoch is sharded by
shape, as the JAX trainer's ``make_sharded_epoch``: ``gcd(ranks, shapes,
batch)`` ranks each hold their contiguous shapes' points, SDF values, latent
rows and the code Adam's moments of those rows, draw sign-balanced batches
of ``batch / shards`` from their own shapes (:func:`create_sharded_batches`,
the same draws on every rank) and run the rowwise kernels on them; the loss
and the network gradients are averaged over the ranks, the code gradients
divided by the shard count with no collective. Where a shard holds samples
of one sign only, the JAX trainer's rule prints "sharded epoch disabled"
and every rank runs the single-device epoch alike. The saved table and its
moments are gathered to rank 0 in global shape order; ``continue`` scatters
them back.

With ``gui`` the run takes the JAX trainer's viewer branch: never the
sharded epoch; the batches are drawn lazily, and every 400th batch (from
the first) a shape index is drawn from the same generator, between the
batches' own draws (so the padded last batch is the JAX gui run's, not the
headless run's), and rank 0's live viewer (``train.common.make_viewer``)
shows that shape's mesh at 64^3 (the points kernel, then marching
tetrahedra on the device). Every rank draws the index, so the ranks' runs
stay alike.

Not ported: ``lax.scan`` over the epoch: here each step is a Python call,
the epoch's index batches go to the device once, and the losses stay there
until the epoch's end.
"""

from __future__ import annotations

import math
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
from shapegan_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    get_mesh,
    init_from_env,
    tears_down_launch,
    world,
)
from shapegan_tpu_torch.train.common import (
    CSVLogger,
    EpochTimer,
    effective_batch_size,
    idle_result,
    make_viewer,
)

POINTCLOUD_SIZE = 200000
SYNTHETIC_POINTCLOUD_SIZE = 20000  # the JAX trainer's default for synthetic=N
BATCH_SIZE = 20000
SDF_CUTOFF = 0.1
SIGMA = 0.01
LEARNING_RATE = 1e-5
VIEWER_UPDATE_BATCHES = 400

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


def create_sharded_batches(signs: np.ndarray, batch_size: int, shards: int,
                           rng: np.random.Generator) -> np.ndarray:
    """Per-shard sign-balanced batches of LOCAL indices (the JAX trainer's
    draws, in its order): shard ``s`` owns the contiguous slice ``[s * L,
    (s + 1) * L)`` of ``signs`` and draws batches of ``batch_size //
    shards`` from it with :func:`create_batches`; returns [num_batches,
    shards, batch_size // shards], num_batches the smallest shard's count."""
    local_n = signs.shape[0] // shards
    local_batch = batch_size // shards
    per_shard = [list(create_batches(signs[s * local_n: (s + 1) * local_n], local_batch, rng))
                 for s in range(shards)]
    num_batches = min(len(b) for b in per_shard)
    if num_batches == 0:
        return np.zeros((0, shards, local_batch), np.int64)
    return np.stack([np.stack([per_shard[s][i] for s in range(shards)])
                     for i in range(num_batches)])


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


def run_epoch(params: Dict[str, torch.Tensor], latent_codes: torch.Tensor, net_opt, code_opt,
              points: torch.Tensor, sdf: torch.Tensor, batches: torch.Tensor,
              pointcloud_size: int, mesh: Optional[Mesh] = None,
              apply: Callable = apply_rowwise) -> torch.Tensor:
    """One epoch over index batches [num_batches, batch]: per batch
    :func:`loss_and_grads`, then the network's and the table's optimizer
    steps; returns the losses [num_batches] on the device.

    With a ``mesh`` of shape shards (``make_sharded_epoch``): ``points``,
    ``sdf``, ``latent_codes`` and ``code_opt`` hold this rank's shapes and
    ``batches`` its local indices; the loss and the network gradients are
    averaged over the data group (one all-reduce a step), and the code
    gradients, which touch this rank's rows only, are divided by the shard
    count without a collective."""
    shards = 1 if mesh is None else mesh.shape[DATA_AXIS]
    losses = []
    for i in range(batches.shape[0]):
        loss, net_grads, code_grad = loss_and_grads(params, latent_codes, points, sdf, batches[i],
                                                    pointcloud_size, apply)
        if shards > 1:
            net_grads = mesh.mean_over_data({**net_grads, "": loss})
            loss = net_grads.pop("")
            code_grad = code_grad / shards
        net_opt.step(net_grads)
        code_opt.step({"codes": code_grad})
        losses.append(loss)
    return torch.stack(losses)


def _viewer_epoch(net: SDFNet, latent_codes: torch.Tensor, net_opt, code_opt,
                  points: torch.Tensor, sdf: torch.Tensor, signs: np.ndarray, batch_size: int,
                  pointcloud_size: int, np_rng: np.random.Generator, viewer, step_ms: list,
                  steps: list) -> np.ndarray:
    """The JAX trainer's viewer epoch: one step a batch, the batches drawn
    lazily from ``np_rng``, and after every :data:`VIEWER_UPDATE_BATCHES`-th
    batch (from the first) a shape index drawn from ``np_rng`` too, whose
    mesh at 64^3 goes to ``viewer`` (when there is one: the index is drawn
    on every rank). Appends the epoch's mean step time (the meshing
    included) and step count; returns the losses."""
    model_count = latent_codes.shape[0]
    losses = []
    t0 = time.perf_counter()
    for batch_index, drawn in enumerate(create_batches(signs, batch_size, np_rng)):
        batch = torch.tensor(drawn[None], dtype=torch.int64, device=points.device)
        losses.append(run_epoch(net.param_dict(), latent_codes, net_opt, code_opt, points, sdf,
                                batch, pointcloud_size))
        if batch_index % VIEWER_UPDATE_BATCHES == 0:
            shape = int(np_rng.integers(model_count))
            if viewer is not None:
                mesh = net.get_mesh(latent_codes.detach()[shape], voxel_resolution=64)
                if mesh is not None:
                    viewer.set_mesh(mesh)
    loss_values = torch.cat(losses).cpu().numpy()
    step_ms.append((time.perf_counter() - t0) * 1e3 / len(losses))
    steps.append(len(losses))
    return loss_values


def _code_rows(code_opt: Adam, latent_codes: torch.Tensor, rows: slice) -> Adam:
    """An Adam over ``latent_codes`` (a rank's rows) holding ``rows`` of the
    global table's moments and its step count."""
    local = Adam({"codes": latent_codes}, code_opt.learning_rate)
    local.load_state({"count": code_opt.count, "mu": {"codes": code_opt.mu["codes"][rows]},
                      "nu": {"codes": code_opt.nu["codes"][rows]}})
    return local


def _gathered(mesh: Optional[Mesh], latent_codes: torch.Tensor, code_opt: Adam):
    """The global table and an Adam over it with the global moments,
    gathered in shape order on every rank (as they are without a mesh)."""
    if mesh is None:
        return latent_codes.detach(), code_opt

    def gather(t):
        return torch.cat(mesh.all_gather(t.detach(), mesh.data_group))

    table = gather(latent_codes)
    full = Adam({"codes": table}, code_opt.learning_rate)
    full.load_state({"count": code_opt.count, "mu": {"codes": gather(code_opt.mu["codes"])},
                     "nu": {"codes": gather(code_opt.nu["codes"])}})
    return table, full


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


@tears_down_launch
def train(config: Optional[TrainConfig] = None) -> dict:
    """Train; returns the network, the latent table, each epoch's step
    count and mean step time, and the shard count of the epoch."""
    config = config or parse_cli()
    device = init_from_env(resolve_device(config))
    base = config.model_dir

    points_np, sdf_np, pointcloud_size = load_pointcloud(config)
    model_count = points_np.shape[0] // pointcloud_size
    sdf_np = np.clip(sdf_np, -SDF_CUTOFF, SDF_CUTOFF)
    signs = sdf_np > 0
    batch_size = effective_batch_size(config.batch_size or BATCH_SIZE, points_np.shape[0])

    # The shape-sharded epoch over the largest rank count that divides both
    # the shape count and the batch (the JAX trainer's rule); each shard
    # must hold both SDF signs, else every rank runs the single epoch. A
    # gui run never takes it.
    shards = math.gcd(math.gcd(world(), model_count), batch_size) if config.nogui else 1
    mesh = None
    if shards > 1:
        try:
            create_sharded_batches(signs, batch_size, shards, np.random.default_rng(0))
        except ValueError as exc:
            print(f"sharded epoch disabled ({exc}); using single-device epoch")
            shards = 1
        else:
            mesh = get_mesh(data=shards, points=1)
            if not mesh.member:
                return idle_result(mesh)
    rows = slice(None) if mesh is None else mesh.data_slice(points_np.shape[0])
    points = torch.tensor(points_np[rows], device=device)
    sdf = torch.tensor(sdf_np[rows], device=device)

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
    if mesh is not None:
        code_rows = mesh.data_slice(model_count)
        latent_codes = latent_codes.detach()[code_rows].clone().requires_grad_(True)
        code_opt = _code_rows(code_opt, latent_codes, code_rows)

    logger = CSVLogger(f"{config.plot_dir}/sdf_net_training.csv", resume=config.resume)
    viewer = make_viewer(config.nogui)
    epochs = range(logger.first_epoch, config.epochs) if config.epochs else count(logger.first_epoch)
    step_ms, steps = [], []
    try:
        for epoch in epochs:
            np_rng = np.random.default_rng((config.seed, epoch))
            with EpochTimer() as timer:
                if not config.nogui:
                    loss_values = _viewer_epoch(net, latent_codes, net_opt, code_opt, points,
                                                sdf, signs, batch_size, pointcloud_size, np_rng,
                                                viewer, step_ms, steps)
                else:
                    if mesh is None:
                        drawn = np.stack(list(create_batches(signs, batch_size, np_rng)))
                    else:
                        drawn = create_sharded_batches(signs, batch_size, shards,
                                                       np_rng)[:, mesh.data_index]
                    batches = torch.tensor(drawn, dtype=torch.int64, device=device)
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    t0 = time.perf_counter()
                    losses = run_epoch(params, latent_codes, net_opt, code_opt, points, sdf,
                                       batches, pointcloud_size, mesh)
                    loss_values = losses.cpu().numpy()  # the epoch's one wait for the device
                    step_ms.append((time.perf_counter() - t0) * 1e3 / batches.shape[0])
                    steps.append(batches.shape[0])

            codes, full_code_opt = _gathered(mesh, latent_codes, code_opt)
            latent_std = float(np.std(codes.cpu().numpy().reshape(-1)))
            mean_loss = float(np.mean(loss_values))
            print(f"Epoch {epoch}, {timer.duration:.1f}s ({step_ms[-1]:.1f} ms/step). "
                  f"Loss: {mean_loss:.8f}", flush=True)

            checkpoints.save(params, NET_NAME, base=base)
            checkpoints.save_array(codes, LATENT_CODES_FILENAME, base=base)
            checkpoints.save(_optimizer_tree(net_opt, full_code_opt), OPT_NAME, base=base)
            checkpoints.save(params, NET_NAME, epoch=epoch, base=base)
            checkpoints.save_array(codes, LATENT_CODES_FILENAME, epoch=epoch, base=base)
            logger.write(epoch, timer.duration, mean_loss, latent_std)
    except KeyboardInterrupt:
        pass
    finally:
        logger.close()
        if viewer is not None:
            viewer.stop()
    return {"net": net, "latent_codes": _gathered(mesh, latent_codes, code_opt)[0],
            "steps": steps, "step_ms": step_ms, "shards": shards, "viewer": viewer}


if __name__ == "__main__":
    train()
