"""Work that spawned ranks run for the port's sharding tests and for
``chip_smoke.py`` (through :func:`shapegan_tpu_torch.parallel.mesh.spawn`).

The functions live in the package so that a spawned rank imports torch and
this package only, never a test module or the JAX package. Each takes
``(rank, world, ...)`` and returns numpy arrays and plain values.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from shapegan_tpu_torch.parallel import mesh as mesh_lib


def to_numpy_tree(tree):
    """A nested dict / list of tensors as numpy arrays (float32 stays
    float32), for results handed from a rank to its parent."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree


def _wrappers() -> dict:
    """Every hand kernel's wrapper, by the name chip_smoke.py reports it."""
    from shapegan_tpu_torch.ops import point_gen_kernels as PG
    from shapegan_tpu_torch.ops import sdf_mlp_kernels as K

    return {"grid": K.grid_forward_cuda, "grid_bwd": K.grid_backward_cuda,
            "points": K.points_forward_cuda, "trace": K.trace_steps_cuda,
            "rowwise": K.rowwise_forward_cuda, "rowwise_bwd": K.rowwise_backward_cuda,
            "point_gen": PG.generate_cuda, "grid_stash": K.grid_forward_stash_cuda,
            "grid_stash_bwd": K.grid_backward_stash_cuda}


def reset_kernel_counts() -> None:
    for wrapper in _wrappers().values():
        wrapper.launch_count = 0


def kernel_counts() -> dict:
    """Every hand kernel's launch count."""
    return {name: wrapper.launch_count for name, wrapper in _wrappers().items()}


@contextlib.contextmanager
def first_gradients():
    """Inside the block, the gradients each optimizer of
    :mod:`shapegan_tpu_torch.optim` is handed at its first step, in the
    order of those first steps (the list it yields). A data-parallel run is
    held to one process by these, after the data mean: where the two runs'
    parameters agree, they agree up to reduction order, while a rank that
    trains on the wrong rows or a gradient scaled by the rank count moves
    them by the order of their scale. The parameters after a few RMSprop or
    Adam steps cannot show that: each step moves a parameter by at most a
    few learning rates whatever its gradient, and a consistently scaled
    gradient not at all."""
    from shapegan_tpu_torch import optim

    stepped, firsts = [], []
    originals = {cls: cls.step for cls in (optim.RMSprop, optim.SGD, optim.Adam)}

    def recording(step):
        def wrapper(self, grads):
            if not any(opt is self for opt in stepped):
                stepped.append(self)
                firsts.append({k: v.detach().clone() for k, v in grads.items()})
            return step(self, grads)
        return wrapper

    for cls, step in originals.items():
        cls.step = recording(step)
    try:
        yield firsts
    finally:
        for cls, step in originals.items():
            cls.step = step


@contextlib.contextmanager
def ranks_grid_math():
    """Inside the block, the one-process volume generators of
    :mod:`~shapegan_tpu_torch.train.hybrid_gan` (and so of the progressive
    trainer) evaluate the grid as a rank of
    :func:`~shapegan_tpu_torch.ops.sdf_mlp_kernels.apply_grid_sharded` does:
    the same kernels on CUDA, the float32 reference math (the JAX package's
    choice off a TPU) in place of the kernels' bf16 plain versions on the
    CPU. A one-process reference run inside it differs from the sharded run
    by reduction order only, so it can be held to it tightly."""
    from shapegan_tpu_torch.ops import sdf_mlp_kernels as K
    from shapegan_tpu_torch.train import hybrid_gan

    saved = hybrid_gan.apply_grid_trainable, hybrid_gan.apply_grid_best
    hybrid_gan.apply_grid_trainable = K._trainable_dispatch
    hybrid_gan.apply_grid_best = K._forward_dispatch
    try:
        yield
    finally:
        hybrid_gan.apply_grid_trainable, hybrid_gan.apply_grid_best = saved


def _device() -> torch.device:
    if torch.cuda.is_available() and torch.distributed.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def mesh_layout(rank: int, world: int, batch: np.ndarray, voxels: np.ndarray,
                batch_size: int) -> dict:
    """The meshes of ``get_mesh()``, ``get_mesh(points=2)`` and
    ``get_mesh(batch_size=6)``, each with this rank's coordinates and rows
    of ``batch``; and this rank's rows of two epochs of voxel batches, both
    device-resident and streamed, over ``get_mesh(batch_size=batch_size)``."""
    from shapegan_tpu_torch.data.datasets import ArrayDataset
    from shapegan_tpu_torch.train.common import make_voxel_batches

    out = {}
    for name, kw in (("default", {}), ("points2", {"points": 2}), ("batch6", {"batch_size": 6})):
        mesh = mesh_lib.get_mesh(**kw)
        rows = mesh_lib.shard_batch(mesh, batch) if mesh.member else None
        out[name] = {"shape": dict(mesh.shape), "member": mesh.member,
                     "coords": (mesh.data_index, mesh.points_index), "rows": rows}
    mesh = mesh_lib.get_mesh(batch_size=batch_size)
    for resident in ("1", "0") if mesh.member else ():
        batches = make_voxel_batches(ArrayDataset(voxels), batch_size, 3, {"resident": resident},
                                     "cpu", mesh)
        epochs = []
        for epoch in range(2):
            batches.set_epoch(epoch)
            epochs.append([b.numpy() for b in batches])
        out[f"resident{resident}"] = epochs
    return out


def grid_checks(rank: int, world: int, params: dict, grid: np.ndarray,
                latents: np.ndarray) -> dict:
    """On a ``data x points`` = ``world / 2 x 2`` mesh: this rank's rows of
    ``apply_grid_sharded`` forward, the trainable call's parameter gradients
    of ``sum(out^2)`` over the global batch (summed over the data group),
    the sharded-route counts of the two volume generators inside and
    outside the mesh, and the progressive step pair of the dryrun."""
    from shapegan_tpu_torch import dryrun_multichip
    from shapegan_tpu_torch.models.sdf_net import SDFNet
    from shapegan_tpu_torch.ops import sdf_mlp
    from shapegan_tpu_torch.ops import sdf_mlp_kernels as K
    from shapegan_tpu_torch.train import hybrid_gan

    mesh = mesh_lib.get_mesh(data=world // 2, points=2)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    g = torch.tensor(grid)
    z = torch.tensor(latents)
    out = {"forward": K.apply_grid_sharded(p, g, z, mesh).detach()}
    local = K.apply_grid_sharded(p, g, z, mesh, trainable=True)
    grads = torch.autograd.grad((local * local).sum(), list(p.values()))
    summed = mesh.mean_over_data(dict(zip(p, grads)))
    out["grads"] = {k: v * mesh.shape["data"] for k, v in summed.items()}
    out["rows"] = (mesh.data_slice(len(latents)).start, mesh.data_slice(len(latents)).stop)

    net = SDFNet(sdf_mlp.init(torch.Generator().manual_seed(0)))  # the kernels' full width
    z = torch.randn((len(latents), 128), generator=torch.Generator().manual_seed(1))
    calls = K.sharded_call_count
    hybrid_gan.generate_volumes_inference(net, g, z, 8)
    out["calls_outside"] = K.sharded_call_count - calls
    with mesh:
        volumes = hybrid_gan.generate_volumes(net, g, z, 8)
        hybrid_gan.generate_volumes_inference(net, g, z, 8)
    out["calls_inside"] = K.sharded_call_count - calls
    out["volumes_shape"] = tuple(volumes.shape)
    out["progressive"] = dryrun_multichip.phase_progressive_step(world, torch.device("cpu"), True)
    return to_numpy_tree(out)


def autodecoder_epochs(rank: int, world: int, params: dict, codes: np.ndarray,
                       points: np.ndarray, sdf: np.ndarray, local: np.ndarray,
                       pointcloud_size: int) -> dict:
    """The shape-sharded SGD epoch (lr 1e-2, float32 reference math) over
    this rank's shapes and its column of the local index batches
    ``local`` [num_batches, shards, local_batch]; and the dryrun's float64
    Adam epoch."""
    from shapegan_tpu_torch import dryrun_multichip
    from shapegan_tpu_torch.ops import sdf_mlp
    from shapegan_tpu_torch.optim import SGD
    from shapegan_tpu_torch.train import sdf_autodecoder as ad

    mesh = mesh_lib.get_mesh(data=world, points=1)
    rows, code_rows = mesh.data_slice(len(points)), mesh.data_slice(len(codes))
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    c = torch.tensor(codes[code_rows], requires_grad=True)
    losses = ad.run_epoch(p, c, SGD(p, 1e-2), SGD({"codes": c}, 1e-2), torch.tensor(points[rows]),
                          torch.tensor(sdf[rows]), torch.tensor(local[:, mesh.data_index]),
                          pointcloud_size, mesh, apply=sdf_mlp.apply)
    adam = dryrun_multichip.phase_autodecoder_adam_f64(world, torch.device("cpu"), True)
    return to_numpy_tree({"params": p, "codes": c, "losses": losses, "adam": adam})


def _summary(value):
    """A trainer's return value as numpy: modules as their parameters (an
    SDF network's under its :meth:`param_dict` keys)."""
    if hasattr(value, "set_voxels"):  # a viewer stays with its rank
        return None
    if hasattr(value, "param_dict"):
        return {k: v.detach() for k, v in value.param_dict().items()}
    if isinstance(value, torch.nn.Module):
        return {k: v.detach() for k, v in (*value.named_parameters(), *value.named_buffers())}
    if isinstance(value, dict):
        return {k: _summary(v) for k, v in value.items()}
    return value


@contextlib.contextmanager
def float32_math():
    """Inside the block, cuDNN's convolutions and cuBLAS's matmuls in full
    float32 (TF32 off), so a run on part of a batch and a run on all of it
    differ by reduction order only."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@contextlib.contextmanager
def written_files():
    """Inside the block, the files under the working directory that this
    process opens for writing or renames into place (the CSV logs, the
    checkpoints' final names), as relative paths in the order written."""
    import builtins

    paths = []
    real_open, real_replace = builtins.open, os.replace

    def note(path) -> None:
        relative = os.path.relpath(os.path.abspath(os.fspath(path)))
        if not relative.startswith(".."):
            paths.append(relative)

    def recording_open(file, mode="r", *args, **kwargs):
        if isinstance(file, (str, os.PathLike)) and any(c in mode for c in "wax+"):
            note(file)
        return real_open(file, mode, *args, **kwargs)

    def recording_replace(src, dst, *args, **kwargs):
        note(dst)
        return real_replace(src, dst, *args, **kwargs)

    builtins.open, os.replace = recording_open, recording_replace
    try:
        yield paths
    finally:
        builtins.open, os.replace = real_open, real_replace


def run_trainer(rank: int, world: int, runs: Sequence[tuple], workdir: str,
                curriculum: Optional[list] = None) -> dict:
    """``python -m shapegan_tpu_torch.train.<module> <argv>`` on this rank
    for each ``(module, argv)`` of ``runs`` in turn, in ``workdir``: each
    run's result (parameters as numpy), the gradients of each optimizer's
    first step (:func:`first_gradients`), the kernels it launched and its
    seconds (host clock, the card synchronized), the files it wrote
    (:func:`written_files`) and its calls of ``apply_grid_sharded``. A run
    given as ``(module, argv, options)`` takes ``options["curriculum"]`` as
    its curriculum (the ``curriculum`` argument gives every run one) and,
    with ``options["float32"]``, runs with TF32 off in cuDNN and cuBLAS."""
    from shapegan_tpu_torch.core.config import parse_cli
    from shapegan_tpu_torch.ops import sdf_mlp_kernels as K

    os.chdir(workdir)
    out = []
    for module, argv, *own in runs:
        options = own[0] if own else {}
        calls = K.sharded_call_count
        trainer = importlib.import_module(f"shapegan_tpu_torch.train.{module}")
        reset_kernel_counts()
        stages = options.get("curriculum", curriculum)
        kw = {} if stages is None else {"curriculum": stages}
        t0 = time.perf_counter()
        with first_gradients() as grads, written_files() as written, \
                (float32_math() if options.get("float32") else contextlib.nullcontext()):
            result = trainer.train(parse_cli(list(argv)), **kw)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        out.append({"result": to_numpy_tree(_summary(result)), "first_grads": to_numpy_tree(grads),
                    "counts": kernel_counts(), "seconds": time.perf_counter() - t0,
                    "written": sorted(set(written)),
                    "sharded_calls": K.sharded_call_count - calls})
    return {"runs": out}


def nccl_volumes(rank: int, world: int, params: dict, latents: np.ndarray) -> dict:
    """One NCCL rank: an all-reduce of a CUDA tensor, then
    ``generate_volumes_inference`` at 64^3 under a 1 x 1 mesh, which must
    take no sharded route."""
    from shapegan_tpu_torch.models.sdf_net import SDFNet
    from shapegan_tpu_torch.ops import sdf_mlp_kernels as K
    from shapegan_tpu_torch.ops.coords import voxel_coordinates
    from shapegan_tpu_torch.train.hybrid_gan import generate_volumes_inference

    device = _device()
    x = torch.full((4,), float(rank + 1), device=device)
    torch.distributed.all_reduce(x)
    mesh = mesh_lib.get_mesh()
    net = SDFNet({k: torch.tensor(v, device=device) for k, v in params.items()})
    reset_kernel_counts()
    calls = K.sharded_call_count
    with mesh:
        volumes = generate_volumes_inference(net, voxel_coordinates(64, device=device),
                                             torch.tensor(latents, device=device), 64)
    torch.cuda.synchronize(device)
    return {"all_reduce": x.cpu().numpy(), "backend": str(torch.distributed.get_backend()),
            "mesh": dict(mesh.shape), "sharded_calls": K.sharded_call_count - calls,
            "volumes": volumes.cpu().numpy(), "counts": kernel_counts()}


def hybrid_gan_steps(rank: int, world: int) -> dict:
    """:func:`hybrid_gan_pair` on the ranks' data mesh."""
    return to_numpy_tree(hybrid_gan_pair(world, True))


def hybrid_gan_pair(n: int, sharded: bool) -> dict:
    """Two hybrid GAN step pairs (``make_steps``: a G step, then the D
    step's two updates) at 32^3 on a narrow network (latent 16, breadth 32)
    over a global batch of ``2 n``: on the data mesh of ``n`` ranks, or in
    one process with the ranks' grid math (:func:`ranks_grid_math`). The
    G and D optimizers' first gradients, the D step's metrics, the final
    parameters and the sharded calls."""
    from shapegan_tpu_torch.models.sdf_net import SDFNet
    from shapegan_tpu_torch.ops import sdf_mlp
    from shapegan_tpu_torch.ops import sdf_mlp_kernels as K
    from shapegan_tpu_torch.optim import Adam
    from shapegan_tpu_torch.train import hybrid_gan

    batch_size, latent = 2 * n, 16
    generator = torch.Generator().manual_seed(7)
    net = SDFNet(sdf_mlp.init(generator, latent_size=latent, breadth=32))
    discriminator = hybrid_gan.Discriminator(True, generator=generator)
    g_opt = Adam(net.param_dict(), hybrid_gan.GENERATOR_LR)
    d_opt = Adam(dict(discriminator.named_parameters()), hybrid_gan.DISCRIMINATOR_LR)
    rng = np.random.default_rng(8)
    batch = torch.tensor(rng.uniform(-0.1, 0.1, (batch_size, 32, 32, 32)), dtype=torch.float32)
    mesh = mesh_lib.get_mesh(data=n) if sharded else None
    g_step, d_step = hybrid_gan.make_steps(net, discriminator, g_opt, d_opt, mesh=mesh)
    calls = K.sharded_call_count
    with (mesh if sharded else ranks_grid_math()), first_gradients() as grads:
        for _ in range(2):
            z_g, z_d = (torch.tensor(rng.standard_normal((batch_size, latent)),
                                     dtype=torch.float32) for _ in range(2))
            g_step(z_g)
            metrics = d_step(mesh_lib.shard_batch(mesh, batch), z_d)
    return {"first_grads": grads, "metrics": metrics,
            "g": {k: v.detach() for k, v in net.param_dict().items()},
            "d": {k: v.detach() for k, v in discriminator.named_parameters()},
            "sharded_calls": K.sharded_call_count - calls}


def broken(rank: int, world: int, fault: str, fn, *args):
    """``fn(rank, world, *args)`` (a rank function such as
    ``dryrun_multichip.rank_phases``) on a mesh broken on purpose, to show
    that a check catches the fault: ``no_data_mean``, no gradient is
    averaged over the data group; ``first_rows``, every rank takes data row
    0's slice of a global batch, so the others' rows are never trained on
    while the replicas stay equal."""
    if fault == "no_data_mean":
        mesh_lib.Mesh.mean_over_data = lambda self, tensors: tensors
    elif fault == "first_rows":
        mesh_lib.Mesh.data_slice = lambda self, n: slice(0, n // self.shape[mesh_lib.DATA_AXIS])
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return fn(rank, world, *args)
