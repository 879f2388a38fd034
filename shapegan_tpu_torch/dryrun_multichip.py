"""The multichip dryrun of the port (counterpart of ``dryrun_multichip`` in
the JAX package's ``__graft_entry__.py``).

    python -m shapegan_tpu_torch.dryrun_multichip [n] [cpu]

Runs six phases on ``n`` ranks (default: the local CUDA devices, one rank
a card with NCCL; ``cpu``: gloo ranks on the CPU), each against the same
work in one process, and prints one line a phase with its error beside its
bound; a phase that fails raises:

1. the progressive WGAN-GP step pair (iteration 0, 8^3) on a ``data x
   points`` mesh, ``points = 2`` when ``n`` is even: the G step's and the
   D step's gradients after the data mean, which must come through
   :func:`~shapegan_tpu_torch.ops.sdf_mlp_kernels.apply_grid_sharded`;
2. one shape-sharded autodecoder epoch with SGD (Adam's normalization would
   hide a wrong gradient scale), through the rowwise kernels on CUDA;
3. the classic autoencoder's loss and gradients on a data-sharded batch,
   BatchNorm over the global batch;
4. a four-batch autodecoder epoch with the trainer's two Adams in float64,
   through the float32 reference math's float64 twin (as the JAX package's
   runs on a CPU mesh), where reduction-order noise sits far below a
   structural fault;
5. three progressive G/D RMSprop pairs, compared on the third pair's G and
   D gradients;
6. two point-GAN D/G step pairs on the trainer's per-stage data mesh,
   compared on the first D step's gradients (the bf16 critic's rounding
   depends on the batch it is given, and after one RMSprop step on such
   gradients the two runs' critics, and so their G gradients, differ by
   ~15 %).

The ranks run the package's own trainers' steps (``make_steps``,
``make_step``, ``run_epoch``); the one-process references run the same
functions without a mesh in the calling process. Inputs are made from
fixed seeds with numpy. Every phase compares what the optimizers were
handed, never only the parameters after RMSprop or Adam steps, which move
by a few learning rates whatever the gradient. On the CPU a rank evaluates
the grid with the float32 reference math (the JAX package's choice off a
TPU), and the one-process reference of phases 1 and 5 does the same
(``rank_checks.ranks_grid_math``), so the two differ by reduction order
only and the bounds sit far below the order-one error of a rank trained
on the wrong rows, a missing data mean or a doubled reduction.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from shapegan_tpu_torch.parallel import mesh as mesh_lib
from shapegan_tpu_torch.parallel import rank_checks

PHASES = (1, 2, 3, 4, 5, 6)
# Per phase: relative to the gradients' scale (1, 3, 5, 6) or absolute on
# the parameters and codes after SGD or float64 Adam (2, 4), as the JAX
# package's dryrun (__graft_entry__.py) bounds them. Phases 2, 4 and 6 keep
# its bounds (6: the bf16 critic's first gradients read 8.4e-3 on the CPU
# and on an H100); 1, 3 and 5 sit below its 0.05-0.1 by as far as
# reduction order allows (1: 3e-7 on 4 CPU ranks, 1.2e-8 on an H100; 3:
# 1.3e-5 and 5.7e-4, cuDNN's algorithms for batches of 1 and 2; 5: 1.8e-7
# and 6.8e-8). Every rank on the first rows of a batch moves 1, 5 and 6 by
# 0.39, 0.52 and 0.89, and 3's loss by a third.
BOUNDS = {1: 1e-4, 2: 2e-4, 3: 1e-2, 4: 1e-6, 5: 1e-3, 6: 0.05}


class _Recorder:
    """An optimizer that keeps the gradients of its last step."""

    def __init__(self, opt):
        self.opt = opt
        self.grads: Optional[Dict[str, torch.Tensor]] = None

    def step(self, grads):
        self.grads = {k: v.detach().clone() for k, v in grads.items()}
        self.opt.step(grads)


def _points_axis(n: int) -> int:
    return 2 if n % 2 == 0 and n >= 2 else 1


def _mesh(sharded: bool, **kw) -> Optional[mesh_lib.Mesh]:
    return mesh_lib.get_mesh(**kw) if sharded else None


def _enter(mesh):
    return mesh if mesh is not None else contextlib.nullcontext()


def _tensors(module_or_dict) -> Dict[str, torch.Tensor]:
    if isinstance(module_or_dict, dict):
        return {k: v.detach() for k, v in module_or_dict.items()}
    return {k: v.detach() for k, v in module_or_dict.named_parameters()}


# ------------------------------------------------------------------ phases


def _progressive_pairs(n: int, device, sharded: bool, pairs: int, seed: int) -> dict:
    """``pairs`` progressive G/D pairs at iteration 0 (8^3), batch 2 * data;
    the last pair's gradients and the final parameters."""
    from shapegan_tpu_torch.ops import sdf_mlp_kernels as K
    from shapegan_tpu_torch.optim import RMSprop
    from shapegan_tpu_torch.train import hybrid_progressive_gan as prog

    points = _points_axis(n)
    data = n // points
    batch_size = 2 * data
    net, critic = prog.create_models(seed, device)
    g_opt = _Recorder(RMSprop(net.param_dict(), prog.LEARN_RATE))
    d_opt = _Recorder(RMSprop(dict(critic.named_parameters()), prog.LEARN_RATE))
    rng = np.random.default_rng(seed + 1)
    batch = torch.tensor(rng.uniform(-0.1, 0.1, (batch_size, 8, 8, 8)), dtype=torch.float32,
                         device=device)
    mesh = _mesh(sharded, data=data, points=points)
    g_step, d_step = prog.make_steps(net, critic, g_opt, d_opt, 0, mesh)
    calls = K.sharded_call_count
    with _enter(mesh) if sharded else rank_checks.ranks_grid_math():
        for _ in range(pairs):
            z_g, z_d = (torch.tensor(rng.standard_normal((batch_size, 128)), dtype=torch.float32,
                                     device=device) for _ in range(2))
            alpha = torch.tensor(rng.uniform(0, 1, (batch_size, 1, 1, 1)), dtype=torch.float32,
                                 device=device)
            g_step(z_g, 0.5)
            metrics = d_step(mesh_lib.shard_batch(mesh, batch), z_d, alpha, 0.5)
    return {"g_grads": g_opt.grads, "d_grads": d_opt.grads, "metrics": metrics,
            "g": _tensors(net.param_dict()), "d": _tensors(critic),
            "sharded_calls": K.sharded_call_count - calls}


def phase_progressive_step(n: int, device, sharded: bool) -> dict:
    return _progressive_pairs(n, device, sharded, pairs=1, seed=0)


def phase_progressive_chain(n: int, device, sharded: bool) -> dict:
    return _progressive_pairs(n, device, sharded, pairs=3, seed=3)


def _autodecoder_epoch(n: int, device, sharded: bool, adam_f64: bool) -> dict:
    """One autodecoder epoch over n shapes of 128 points, ``n`` shards of
    32-point local batches: SGD (lr 1e-2) through the rowwise kernels'
    dispatch, or the trainer's two Adams in float64 through the reference
    math. The single process runs the global batches equal to the shards'."""
    from shapegan_tpu_torch.ops import sdf_mlp
    from shapegan_tpu_torch.optim import SGD, Adam
    from shapegan_tpu_torch.train import sdf_autodecoder as ad

    shards, pc_size, local_batch = n, 128, 32
    num_batches = 4 if adam_f64 else 1
    model_count = shards
    local_n = model_count * pc_size // shards
    dtype = torch.float64 if adam_f64 else torch.float32
    rng = np.random.default_rng(2 if adam_f64 else 0)
    points = rng.uniform(-1, 1, (model_count * pc_size, 3))
    sdf = np.clip(rng.normal(0, 0.05, model_count * pc_size), -0.1, 0.1)
    local = rng.integers(0, local_n, (num_batches, shards, local_batch))
    params = {k: v.to(dtype).requires_grad_(True) for k, v in
              sdf_mlp.init(torch.Generator().manual_seed(0), device=device).items()}
    codes = (torch.randn((model_count, 128), generator=torch.Generator().manual_seed(1),
                         dtype=dtype) * 1e-4).to(device)
    mesh = _mesh(sharded, data=shards, points=1)
    if mesh is not None:
        rows, code_rows = mesh.data_slice(len(points)), mesh.data_slice(model_count)
        points, sdf, codes = points[rows], sdf[rows], codes[code_rows]
        batches = local[:, mesh.data_index]
    else:
        batches = (local + (np.arange(shards) * local_n)[None, :, None]).reshape(num_batches, -1)
    codes = codes.clone().requires_grad_(True)
    make = (lambda p: Adam(p, ad.LEARNING_RATE)) if adam_f64 else (lambda p: SGD(p, 1e-2))
    net_opt, code_opt = make(params), make({"codes": codes})
    losses = ad.run_epoch(params, codes, net_opt, code_opt,
                          torch.tensor(points, dtype=dtype, device=device),
                          torch.tensor(sdf, dtype=dtype, device=device),
                          torch.tensor(batches, dtype=torch.int64, device=device), pc_size, mesh,
                          apply=sdf_mlp.apply if adam_f64 else ad.apply_rowwise)
    return {"params": _tensors(params), "codes": codes.detach(), "losses": losses}


def phase_autodecoder_sgd(n: int, device, sharded: bool) -> dict:
    return _autodecoder_epoch(n, device, sharded, adam_f64=False)


def phase_autodecoder_adam_f64(n: int, device, sharded: bool) -> dict:
    return _autodecoder_epoch(n, device, sharded, adam_f64=True)


def phase_autoencoder(n: int, device, sharded: bool) -> dict:
    """The classic autoencoder's step on n synthetic 32^3 volumes (batch n,
    one a rank): its loss, gradients and BatchNorm running statistics. On
    CUDA the convolutions run in float32 without TF32 for this comparison
    (TF32's rounding of a batch of 1 and of n alone moves the loss by
    ~4e-5 of itself, above the 1e-5 the check holds it to)."""
    from shapegan_tpu_torch.data.synthetic import make_voxel_dataset
    from shapegan_tpu_torch.train import autoencoder as ae

    model, opt = ae.create_state(False, 0, device)
    recorder = _Recorder(opt)
    batch = torch.tensor(make_voxel_dataset(n, resolution=32, seed=0), device=device)
    mesh = _mesh(sharded, batch_size=n)
    step = ae.make_step(model, recorder, mesh)
    no_tf32 = (torch.backends.cudnn.flags(enabled=True, allow_tf32=False)
               if torch.device(device).type == "cuda" else contextlib.nullcontext())
    with _enter(mesh), no_tf32:
        metrics, _ = step(mesh_lib.shard_batch(mesh, batch), None)
    return {"loss": metrics["reconstruction_loss"], "grads": recorder.grads,
            "batch_stats": dict(model.named_buffers())}


def phase_point_gan(n: int, device, sharded: bool) -> dict:
    """Two point-GAN D/G pairs (batch 2n, 64 points) on the trainer's data
    mesh for the batch: the first D step's gradients, and the final
    parameters."""
    from shapegan_tpu_torch.optim import RMSprop
    from shapegan_tpu_torch.train import point_gan as pg

    batch_size, num_points = 2 * n, 64
    generator, critic = pg.create_models(5, device)
    g_opt = _Recorder(RMSprop(dict(generator.named_parameters()), pg.LEARN_RATE))
    d_opt = _Recorder(RMSprop(dict(critic.named_parameters()), pg.LEARN_RATE))
    rng = np.random.default_rng(6)
    u_pos = rng.uniform(-1, 1, (batch_size, num_points, 3))
    u_dist = np.clip(rng.normal(0, 0.05, (batch_size, num_points, 1)), -0.1, 0.1)
    mesh = _mesh(sharded, batch_size=batch_size)
    if mesh is not None and mesh.shape["data"] != n:
        raise AssertionError("the point-GAN phase must run a data axis over every rank")
    d_step, g_step = pg.make_steps(generator, critic, g_opt, d_opt, mesh)

    def put(a):
        return torch.tensor(mesh_lib.shard_batch(mesh, a), dtype=torch.float32, device=device)

    pos, dist = put(u_pos), put(u_dist)
    first = None
    for _ in range(2):
        z_d, z_g = (torch.tensor(rng.standard_normal((batch_size, pg.LATENT_SIZE)),
                                 dtype=torch.float32, device=device) for _ in range(2))
        alpha = torch.tensor(rng.uniform(0, 1, (batch_size, 1, 1)), dtype=torch.float32,
                             device=device)
        metrics = d_step(pos, dist, z_d, alpha)
        first = first or d_opt.grads
        g_step(pos, z_g)
    return {"d_grads": first, "g": _tensors(generator), "d": _tensors(critic),
            "metrics": metrics}


PHASE_FUNCTIONS = {1: phase_progressive_step, 2: phase_autodecoder_sgd, 3: phase_autoencoder,
                   4: phase_autodecoder_adam_f64, 5: phase_progressive_chain,
                   6: phase_point_gan}


def rank_phases(rank: int, world: int, device: str, phases: Sequence[int]) -> dict:
    """A spawned rank's part: each phase on the mesh, its results and the
    kernels it launched (counted from 0 for each phase)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for phase in phases:
        rank_checks.reset_kernel_counts()
        result = PHASE_FUNCTIONS[phase](world, dev, True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out[phase] = {"result": rank_checks.to_numpy_tree(result), "counts": rank_checks.kernel_counts()}
    return out


# -------------------------------------------------------------- comparison


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [np.asarray(tree, dtype=np.float64)]


def _relative(sharded, single) -> float:
    a, b = _flat(sharded), _flat(single)
    scale = max(float(np.abs(x).max()) for x in b)
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b)) / scale


def _absolute(sharded, single) -> float:
    return max(float(np.abs(x - y).max()) for x, y in zip(_flat(sharded), _flat(single)))


def check(phase: int, ranks: list, single: dict, n: int) -> float:
    """The phase's error (rank 0's results, with the table rows of every
    rank for the autodecoder) against the one-process run; raises above
    the bound."""
    got = ranks[0]
    if phase in (1, 5):
        if got["sharded_calls"] < 1 and n > 1:
            raise AssertionError(f"phase {phase}: the sharded step did not route through "
                                 "apply_grid_sharded")
        for r in ranks:
            if not all(np.isfinite(v).all() for v in _flat(r["metrics"])):
                raise AssertionError(f"phase {phase}: non-finite metrics")
        err = max(_relative(got[k], single[k]) for k in ("g_grads", "d_grads"))
    elif phase in (2, 4):
        codes = np.concatenate([r["codes"] for r in ranks])
        if not np.isfinite(got["losses"]).all():
            raise AssertionError(f"phase {phase}: non-finite losses")
        err = max(_absolute(got["params"], single["params"]),
                  _absolute(codes, single["codes"]))
    elif phase == 3:
        loss, want = float(got["loss"]), float(single["loss"])
        if abs(loss - want) > 1e-5 * max(1.0, abs(want)):
            raise AssertionError(f"phase 3: sharded loss {loss} against {want}")
        err = _relative(got["grads"], single["grads"])
    else:
        err = _relative(got["d_grads"], single["d_grads"])
    # Every rank holds the same replicated state.
    for r in ranks[1:]:
        for key in ("g", "d", "params"):
            if key in got and _absolute(r[key], got[key]) != 0.0:
                raise AssertionError(f"phase {phase}: the ranks' {key} drifted apart")
    if not err < BOUNDS[phase]:
        raise AssertionError(f"phase {phase}: sharded against one process: {err:.3e} "
                             f"(bound {BOUNDS[phase]})")
    return err


NAMES = {1: "progressive WGAN-GP step pair (max|dgrad|/scale)",
         2: "shape-sharded autodecoder SGD epoch (max|dparam|)",
         3: "autoencoder loss and gradients, global BatchNorm (max|dgrad|/scale)",
         4: "float64 Adam autodecoder epoch, 4 batches (max|d|)",
         5: "3 progressive G/D RMSprop pairs, the third's gradients (max|dgrad|/scale)",
         6: "point-GAN D/G step pairs, the first D gradients (max|dgrad|/scale)"}


def dryrun_multichip(n: int, device: str = "cpu", backend: Optional[str] = None,
                     phases: Sequence[int] = PHASES, log=print) -> dict:
    """Run ``phases`` on ``n`` spawned ranks on ``device`` (``cpu``; ``cuda``
    for a card a rank; ``cuda:0`` for every rank on card 0, with gloo) and
    hold each against the one-process run here. Returns ``{"errors":
    {phase: err}, "counts": [{phase: launches} per rank], "seconds"}``;
    raises at the first phase that fails."""
    t0 = time.perf_counter()
    local = torch.device(device)
    if local.type == "cuda" and local.index is None:
        local = torch.device("cuda", 0)
    singles = {}

    def references():
        for phase in phases:
            singles[phase] = rank_checks.to_numpy_tree(PHASE_FUNCTIONS[phase](n, local, False))

    ranks = mesh_lib.spawn(rank_phases, n, device, backend, args=(device, tuple(phases)),
                           while_running=references)
    errors = {}
    for phase in phases:
        err = check(phase, [r[phase]["result"] for r in ranks], singles[phase], n)
        errors[phase] = err
        mesh = f"data={n // _points_axis(n)} x points={_points_axis(n)}" if phase in (1, 5) \
            else f"data={n}"
        log(f"dryrun phase {phase}/6 OK on {n} ranks ({mesh}): {NAMES[phase]} "
            f"{err:.3e} < {BOUNDS[phase]}")
    return {"errors": errors, "counts": [{p: r[p]["counts"] for p in phases} for r in ranks],
            "seconds": time.perf_counter() - t0}


def main(argv: Sequence[str]) -> int:
    words = [a for a in argv if a != "cpu"]
    device = "cpu" if "cpu" in argv else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass 'cpu' for gloo ranks on the CPU")
    n = int(words[0]) if words else (8 if device == "cpu" else torch.cuda.device_count())
    out = dryrun_multichip(n, device)
    print(f"dryrun_multichip OK on {n} ranks in {out['seconds']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
