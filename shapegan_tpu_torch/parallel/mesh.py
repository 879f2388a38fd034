"""The process-group mesh (counterpart of :mod:`shapegan_tpu.parallel.mesh`).

The JAX package runs one process over a device mesh with the axes
``data`` (the batch) and ``points`` (the implicit MLP's point axis). The
port runs one process a card, the PyTorch idiom: a :class:`Mesh` is a
``data x points`` grid of ``torch.distributed`` ranks. Rank ``r`` sits at
``(r // points, r % points)``; ranks beyond ``data * points`` lie outside
the mesh. Each rank holds the whole (replicated) parameters. The
collectives a step needs run on the mesh's subgroups:

* the **data group** of a rank: the ranks of its points column (the same
  points index). Gradients are averaged over it (:meth:`Mesh.mean_over_data`),
  the one collective of a data-parallel step;
* the **points group**: the ranks of its data row. The grid evaluation
  gathers its point slices over it (:meth:`Mesh.gather_points`), and the
  backward sums the parameter gradients over it
  (:meth:`Mesh.sum_grads_over_points`), what shard_map's transpose psums.

NCCL runs the collectives across cards, gloo on the CPU. gloo also runs
where two ranks share one card (NCCL refuses two ranks on one GPU): then
every collective of this module copies a CUDA tensor to the host, runs on
the copy and copies the result back. That copy is explicit here, never a
retry after a failure; no collective's failure is caught.

:func:`init_from_env` starts the process group of a ``python -m
torch.distributed.run`` launch, and a trainer's ``train`` decorated with
:func:`tears_down_launch` destroys that group when it returns or raises;
:func:`spawn` starts ranks itself through
a ``FileStore`` (no TCP rendezvous, so runs in parallel never contend for a
port). Without a process group :func:`get_mesh` gives a 1 x 1 mesh on
which every operation is the identity, so a single process runs exactly as
it would without a mesh.
"""

from __future__ import annotations

import contextvars
import functools
import math
import os
import tempfile
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
POINTS_AXIS = "points"

_AMBIENT: contextvars.ContextVar = contextvars.ContextVar("shapegan_torch_mesh", default=None)
_MESHES: Dict[tuple, "Mesh"] = {}


def world() -> int:
    """The process group's size, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_writer() -> bool:
    """True on the one rank that writes files (rank 0, or the only process)."""
    return rank() == 0


def _backend() -> Optional[str]:
    return str(dist.get_backend()) if dist.is_initialized() else None


def _new_groups(members: Sequence[Sequence[int]]) -> list:
    """One group per rank list, created on every rank in the same order;
    this rank's group (or None where it is in none or the group has one
    rank)."""
    mine = None
    for ranks in members:
        group = dist.new_group(list(ranks))
        if rank() in ranks and len(ranks) > 1:
            mine = group
    return mine


class Mesh:
    """A ``data x points`` grid of ranks. ``with mesh:`` makes it the
    ambient mesh of :func:`ambient_mesh`."""

    def __init__(self, data: int, points: int):
        self.shape = {DATA_AXIS: data, POINTS_AXIS: points}
        self.size = data * points
        self.rank = rank()
        self.member = self.rank < self.size
        self.data_index = self.rank // points if self.member else None
        self.points_index = self.rank % points if self.member else None
        self.backend = _backend()
        self.group = self.data_group = self.points_group = None
        if self.size > 1:
            # Every rank creates every group, in this order.
            rows = [[d * points + p for p in range(points)] for d in range(data)]
            cols = [[d * points + p for d in range(data)] for p in range(points)]
            self.points_group = _new_groups(rows) if points > 1 else None
            self.data_group = _new_groups(cols) if data > 1 else None
            self.group = (dist.group.WORLD if self.size == world()
                          else _new_groups([range(self.size)]))
        self._tokens: List[contextvars.Token] = []

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape[DATA_AXIS]}, points={self.shape[POINTS_AXIS]})"

    def __enter__(self) -> "Mesh":
        self._tokens.append(_AMBIENT.set(self))
        return self

    def __exit__(self, *exc) -> bool:
        _AMBIENT.reset(self._tokens.pop())
        return False

    # ------------------------------------------------------------ layout

    def data_slice(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` (``n`` divisible by
        the data axis)."""
        data = self.shape[DATA_AXIS]
        if n % data:
            raise ValueError(f"a batch of {n} does not divide over data={data}")
        step = n // data
        return slice(self.data_index * step, (self.data_index + 1) * step)

    def points_slice(self, n: int) -> slice:
        """This rank's slice of ``n`` points (divisible by the points axis)."""
        points = self.shape[POINTS_AXIS]
        if n % points:
            raise ValueError(f"{n} points do not divide over points={points}")
        step = n // points
        return slice(self.points_index * step, (self.points_index + 1) * step)

    # ------------------------------------------------------- collectives

    def _host(self, tensor: torch.Tensor) -> bool:
        """gloo runs on host copies of CUDA tensors (see the module's
        docstring)."""
        return self.backend == "gloo" and tensor.device.type != "cpu"

    def all_reduce_(self, tensor: torch.Tensor, group) -> torch.Tensor:
        """Sum ``tensor`` over ``group`` in place (nothing without one)."""
        if group is None:
            return tensor
        if self._host(tensor):
            host = tensor.cpu()
            dist.all_reduce(host, group=group)
            tensor.copy_(host)
        else:
            dist.all_reduce(tensor, group=group)
        return tensor

    def all_gather(self, tensor: torch.Tensor, group) -> List[torch.Tensor]:
        """Every rank's ``tensor`` of ``group`` (same shape), in rank order."""
        if group is None:
            return [tensor]
        size = dist.get_world_size(group)
        source = tensor.detach().contiguous()
        if self._host(source):
            parts = [torch.empty_like(source, device="cpu") for _ in range(size)]
            dist.all_gather(parts, source.cpu(), group=group)
            return [p.to(tensor.device) for p in parts]
        parts = [torch.empty_like(source) for _ in range(size)]
        dist.all_gather(parts, source, group=group)
        return parts

    def broadcast_(self, tensor: torch.Tensor) -> torch.Tensor:
        """``tensor`` from the mesh's first rank to every member, in place."""
        if self.group is None:
            return tensor
        if self._host(tensor):
            host = tensor.cpu()
            dist.broadcast(host, src=0, group=self.group)
            tensor.copy_(host)
        else:
            dist.broadcast(tensor, src=0, group=self.group)
        return tensor

    def _reduce_flat(self, tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
        """Sum each tensor over ``group``: one all-reduce per dtype."""
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        for indices in by_dtype.values():
            flat = torch.cat([tensors[i].detach().reshape(-1) for i in indices])
            self.all_reduce_(flat, group)
            for i, part in zip(indices, flat.split([tensors[i].numel() for i in indices])):
                out[i] = part.view_as(tensors[i])
        return out

    def mean_over_data(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Average gradients (or metrics) over the data group: the sum over
        the shards' batch means, divided by the shard count."""
        if self.data_group is None:
            return tensors
        summed = self._reduce_flat(list(tensors.values()), self.data_group)
        data = self.shape[DATA_AXIS]
        return {k: v / data for k, v in zip(tensors, summed)}

    def gather_points(self, local: torch.Tensor) -> torch.Tensor:
        """A rank's ``[rows, P / points]`` slice gathered over its points
        group into ``[rows, P]``; the gradient of the result keeps this
        rank's own slice."""
        if self.points_group is None:
            return local
        return _GatherPoints.apply(self, local)

    def sum_grads_over_points(self, *tensors: torch.Tensor):
        """The tensors unchanged; their gradients summed over the points
        group (the psum of shard_map's transpose over ``points``)."""
        if self.points_group is None:
            return tensors
        return _SumGradsOverPoints.apply(self, *tensors)

    def replicate(self, tensors) -> None:
        """Broadcast tensors from the mesh's first rank to every member, in
        place."""
        with torch.no_grad():
            for t in tensors:
                self.broadcast_(t)


class _GatherPoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
        ctx.mesh, ctx.width = mesh, local.shape[1]
        return torch.cat(mesh.all_gather(local, mesh.points_group), dim=1)

    @staticmethod
    def backward(ctx, g):
        start = ctx.mesh.points_index * ctx.width
        return None, g[:, start:start + ctx.width]


class _SumGradsOverPoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh: Mesh, *tensors):
        ctx.mesh = mesh
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(s, dtype=d, device=v) if g is None else g
                 for g, (s, d, v) in zip(grads, ctx.shapes)]
        return (None, *ctx.mesh._reduce_flat(grads, ctx.mesh.points_group))


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
        ctx.mesh = mesh
        return mesh.all_reduce_(x.detach().clone(), mesh.data_group)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.mesh.all_reduce_(g.clone(), ctx.mesh.data_group)


def sum_over_data(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data group, differentiably: the gradient of
    each rank's copy of the sum is summed back over the group (BatchNorm's
    global batch statistics)."""
    if mesh.data_group is None:
        return x
    return _AllReduceSum.apply(mesh, x)


def get_mesh(data: Optional[int] = None, points: int = 1,
             batch_size: Optional[int] = None) -> Mesh:
    """The ``data x points`` mesh over the process group (the JAX
    package's rule): ``data`` defaults to ``world // points``, shrunk to
    ``gcd(data, batch_size)`` when a batch size is given, so sharding never
    changes the batch. Raises when the mesh needs more ranks than there
    are. Every rank must call it with the same arguments (it creates
    groups); meshes are kept per shape."""
    n = world()
    if data is None:
        data = n // points
        if batch_size is not None:
            data = math.gcd(data, batch_size)
    if data * points > n:
        raise ValueError(f"mesh {data}x{points} needs more than {n} ranks")
    key = (data, points, id(dist.group.WORLD) if dist.is_initialized() else None)
    if key not in _MESHES:
        _MESHES[key] = Mesh(data, points)
    return _MESHES[key]


def ambient_mesh() -> Optional[Mesh]:
    """The mesh of the innermost ``with mesh:`` block, or None."""
    return _AMBIENT.get()


def shard_batch(mesh: Optional[Mesh], batch):
    """This rank's rows (over ``data``) of a global host or device batch
    (an array or tensor, or a tuple or list of them): the JAX package's
    layout, shard ``d`` holding rows ``[d * B / data, (d + 1) * B / data)``."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, b) for b in batch)
    if batch is None or mesh is None or mesh.shape[DATA_AXIS] == 1:
        return batch
    return batch[mesh.data_slice(len(batch))]


def init_from_env(device) -> torch.device:
    """Start the process group of a ``python -m torch.distributed.run``
    launch (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` in the environment)
    and return this rank's device: ``cuda:LOCAL_RANK`` with NCCL, or the
    CPU with gloo when ``device`` is the CPU. Without ``WORLD_SIZE > 1``,
    or with a process group already started (:func:`spawn`), ``device`` is
    returned as it is. With ``WORLD_SIZE > 1`` and no CUDA it raises unless
    the CPU is asked for."""
    device = torch.device(device)
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("WORLD_SIZE > 1 without CUDA: pass the 'cpu' token for gloo ranks")
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return device


def tears_down_launch(train: Callable) -> Callable:
    """Decorate a trainer's ``train``: a process group that the call starts
    (:func:`init_from_env` under ``torch.distributed.run``) is destroyed
    when it returns or raises, with the meshes made over it. A group that
    was there before the call stays: :func:`spawn`'s ranks, or a caller's
    that runs several trainers on one set of ranks."""

    @functools.wraps(train)
    def wrapper(*args, **kwargs):
        started = dist.is_initialized()
        try:
            return train(*args, **kwargs)
        finally:
            if not started and dist.is_initialized():
                world_id = id(dist.group.WORLD)
                for key in [k for k in _MESHES if k[2] == world_id]:
                    del _MESHES[key]
                dist.destroy_process_group()

    return wrapper


def _rank_main(index: int, fn: Callable, world_size: int, device: str, backend: str,
               store_path: str, out_dir: str, args: tuple) -> None:
    """A spawned rank: join the process group through the FileStore, run
    ``fn(rank, world, *args)``, keep its result for the parent."""
    device = torch.device(device)
    if device.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(device if device.index is not None
                              else index % torch.cuda.device_count())
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=index, world_size=world_size)
    try:
        result = fn(index, world_size, *args)
        torch.save(result, os.path.join(out_dir, f"rank{index}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, device: str = "cpu", backend: Optional[str] = None,
          args: tuple = (), while_running: Optional[Callable[[], None]] = None) -> list:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` spawned ranks
    joined through a ``FileStore`` and return their results in rank order
    (an exception in a rank is raised here). ``fn`` must be importable by
    name (a module-level function of this package), so a child imports
    what it needs and nothing of the caller. ``device``: ``cpu`` (each rank
    one intra-op thread), ``cuda:i`` (every rank on card i) or ``cuda``
    (rank r on card r mod count). ``backend``: gloo on the CPU, NCCL on
    CUDA by default. ``while_running()``, when given, runs here while the
    ranks run."""
    import torch.multiprocessing as mp

    backend = backend or ("gloo" if torch.device(device).type == "cpu" else "nccl")
    with tempfile.TemporaryDirectory() as out_dir:
        store_path = os.path.join(out_dir, "store")
        context = mp.start_processes(
            _rank_main, args=(fn, world_size, device, backend, store_path, out_dir, args),
            nprocs=world_size, join=False, start_method="spawn")
        try:
            if while_running is not None:
                while_running()
        finally:
            while not context.join():
                pass
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]


__all__ = ["DATA_AXIS", "POINTS_AXIS", "Mesh", "ambient_mesh", "get_mesh", "init_from_env",
           "is_writer", "rank", "shard_batch", "spawn", "sum_over_data", "tears_down_launch",
           "world"]
