"""Closed-loop training of the voxel GAN (marian42/shapegan ``train_gan.py``),
one batch at a time, dispatched as ``train.gan.train`` does: per batch the
real volumes from ``train.common.make_voxel_batches`` (the data set is
resident on the card: ``ResidentBatches``, whose epochs turn over inside
the window), fresh latents for the G step and for the D step's fakes,
then ``g_step(z_g)`` and ``d_step(real, z_d)``. The noise is drawn on the
card from the seed. No sync between steps; no saves, CSV, history or
viewer.

Set-up drives the one training object through its first batches (the
record that the check compares; ``warm_batches`` counts them too), then
the window goes on with it."""

from __future__ import annotations

import math
import statistics
import time
import types
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from benchmark import seeds, voxel_counts
from benchmark.drivers import common
from benchmark.drivers.train import _keeping_scores, _next_real, _sorted
from benchmark.inputs import shapes, weights
from benchmark.reference import voxel_gan
from benchmark.reference.precision import Precision, no_tf32


@dataclass
class State:
    cell: object
    device: torch.device
    g_init: dict
    d_init: dict
    feed: List[dict] = field(default_factory=list)
    record: dict = field(default_factory=dict)
    program: Optional[types.SimpleNamespace] = None
    index: int = 0
    counts: Dict[str, int] = field(default_factory=dict)


def setup(cell, seed: int, device) -> State:
    from shapegan_tpu_torch.data.datasets import ArrayDataset
    from shapegan_tpu_torch.models.gan import Discriminator, Generator
    from shapegan_tpu_torch.optim import Adam
    from shapegan_tpu_torch.train import gan as trainer
    from shapegan_tpu_torch.train.common import make_voxel_batches

    cfg = cell.config
    gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "weights"))
    g_init, d_init = voxel_gan.fresh_weights(cfg, gen, device)
    data = torch.Generator(device=device).manual_seed(seeds.derive(seed, "data"))
    clip = cfg["sdf_clipping"]
    volumes = shapes.make_volumes(cfg["dataset_shapes"], cfg["resolution"], clip, data, device)
    batches = make_voxel_batches(ArrayDataset((volumes / clip).cpu().numpy()), cfg["batch_size"],
                                 seeds.derive(seed, "shuffle"), None, device)
    del volumes
    common.free(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    g_net = Generator(device=device)
    g_net.load_state_dict(weights.clone(g_init))
    d_net = Discriminator(True, device=device)
    d_net.load_state_dict(weights.clone(d_init))
    g_opt = Adam(dict(g_net.named_parameters()), cfg["g_learning_rate"])
    d_opt = Adam(dict(d_net.named_parameters()), cfg["d_learning_rate"])
    g_step, d_step = trainer.make_steps(g_net, d_net, g_opt, d_opt)
    noise = torch.Generator(device=device).manual_seed(seeds.derive(seed, "noise"))
    state = State(cell, device, g_init, d_init)
    state.program = types.SimpleNamespace(g_net=g_net, d_net=d_net, g_opt=g_opt, d_opt=d_opt,
                                          g_step=g_step, d_step=d_step, batches=batches,
                                          epoch=0, iterator=None, noise=noise)
    batches.set_epoch(0)
    state.program.iterator = iter(batches)

    g_scores, d_scores = [], []
    state.program.g_step = _keeping_scores(g_step, d_net, g_scores)
    state.program.d_step = _keeping_scores(d_step, d_net, d_scores)
    state.record["d_grads"] = []
    _keeping_grads(d_opt, state.record["d_grads"])
    for i in range(cell.traffic["checked_batches"]):
        item = run_batch(state)
        state.feed.append({k: item[k] for k in ("z_g", "z_d", "real")})
        if i == 0:
            state.program.g_step, state.program.d_step = g_step, d_step
            del d_opt.step
            state.record["fake"] = item["fake"]
            state.record["g_scores"] = _sorted(g_scores)
            state.record["d_scores"] = _sorted(d_scores)
            for net, opt in (("g", g_opt), ("d", d_opt)):
                state.record[f"{net}_mu"] = weights.clone(opt.mu)
                state.record[f"{net}_nu"] = weights.clone(opt.nu)
    state.record["g_params"] = weights.clone(dict(g_net.named_parameters()))
    state.record["d_params"] = weights.clone(dict(d_net.named_parameters()))
    state.record["g_stats"] = weights.clone(dict(g_net.named_buffers()))
    while state.index < cell.traffic["warm_batches"]:
        run_batch(state)
    common.sync(device)
    state.counts = {"batches": 0, "g_steps": 0, "d_steps": 0}
    return state


def _keeping_grads(opt, grads: list) -> None:
    """``opt.step`` as it is, with a copy of every gradient handed to it
    appended to ``grads`` (until ``del opt.step``): the D step's two
    updates, fakes then real volumes, each its own entry."""
    step = opt.step

    def kept(g):
        grads.append({k: v.detach().clone() for k, v in g.items()})
        return step(g)

    opt.step = kept


def run_batch(state: State, spans=None) -> dict:
    """One batch as the trainer runs it: the real batch, the G step's
    latents and the D step's, then the G step and the D step."""
    p, cfg, device = state.program, state.cell.config, state.device
    shape = (cfg["batch_size"], cfg["latent_size"])
    item = {"real": _next_real(p)}
    item["z_g"] = torch.randn(shape, generator=p.noise, device=device)
    item["z_d"] = torch.randn(shape, generator=p.noise, device=device)
    if spans:
        spans.begin("g_step")
    item["fake"] = p.g_step(item["z_g"])
    if spans:
        spans.end("g_step")
        spans.begin("d_step")
    p.d_step(item["real"], item["z_d"])
    if spans:
        spans.end("d_step")
    for name in ("g_steps", "d_steps", "batches"):
        state.counts[name] = state.counts.get(name, 0) + 1
    state.index += 1
    return item


def window(state: State, seconds: float, spans=None) -> dict:
    t0 = common.now(state.device)
    while not state.counts["batches"] or time.perf_counter() - t0 < seconds:
        run_batch(state, spans)
    window_s = common.now(state.device) - t0
    batch = state.cell.config["batch_size"]
    return {"window_s": window_s, "units": state.counts["batches"],
            "metrics": {"train_samples_per_s": state.counts["batches"] * batch / window_s}}


def work(state: State, check: dict) -> tuple:
    """(operations and bytes of each convolution pass in the window, under
    ``conv.<step>.<net>.<layer>.<pass>``; the model's operations: every
    convolution pass, voxel_counts.py)."""
    cfg, n = state.cell.config, state.counts["batches"]
    per_batch = voxel_counts.batch_work(cfg, cfg["batch_size"])
    return ({f"conv.{k}": (n * f, n * b) for k, (f, b) in per_batch.items()},
            n * voxel_counts.total_flops(per_batch))


def release(state: State) -> None:
    state.program = None
    common.free(state.device)


def _distance_gaps(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep):
    """(widest, median) over the kept leaves of |got - ref| (the norm of
    the difference) over the larger of |ref| and the median leaf's |ref|."""
    if set(got) != set(ref) or any(got[k].shape != ref[k].shape for k in ref):
        return math.inf, math.inf
    norms = common.norms(ref)
    median = statistics.median(norms[k] for k in keep)
    gaps = [float(torch.linalg.vector_norm(got[k].double() - ref[k].double()))
            / max(norms[k], median, 1e-30) for k in keep]
    return max(gaps), statistics.median(gaps)


def _stats_gaps(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                init: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """``bn_var_gap`` and ``bn_mean_gap``: the widest |got - ref| of the
    generator's running variances, and of its running means, over the
    widest distance the reference's moved from where they started (1 for
    statistics that never moved)."""
    out = {}
    for name, suffix in (("bn_var_gap", ".var"), ("bn_mean_gap", ".mean")):
        keys = sorted(k for k in ref if k.endswith(suffix))
        if set(got) != set(ref) or any(got[k].shape != ref[k].shape for k in keys):
            out[name] = math.inf
            continue
        g, r, s = (torch.cat([t[k].double().reshape(-1) for k in keys]) for t in (got, ref, init))
        out[name] = float((g - r).abs().max()) / max(float((r - s).abs().max()), 1e-30)
    return out


def compare(got: dict, ref: dict, g_init: dict, d_init: dict,
            exclude_below: float) -> Dict[str, float]:
    """The numbers that decide ``correct`` (PERF.md, section 2). Leaves
    whose reference gradient is nought to rounding are left out of the
    moments and of the change: the biases of the generator's first three
    layers, which BatchNorm's mean takes away; Adam moves such a leaf by
    round-off alone. The worst leaf is read from ``mu`` alone: it is the
    gradient (the generator's ``mu`` is ``0.1 g``, its ``nu`` ``0.001 g^2``),
    and squaring it doubles the relative rounding of a one-element leaf
    whose gradient is a sum with much cancellation (``convt3.bias``)."""
    out = {"fake_gap": common.widest_gap(got["fake"], ref["fake"]),
           "g_scores_gap": common.widest_gap(got["g_scores"], ref["g_scores"]),
           "d_scores_gap": common.widest_gap(got["d_scores"], ref["d_scores"])}
    g_params, g_stats = voxel_gan.split_stats(g_init)
    for net, start in (("g", g_params), ("d", d_init)):
        mu_norms = common.norms(ref[f"{net}_mu"])
        median = statistics.median(mu_norms.values())
        keep = sorted(k for k, v in mu_norms.items() if v >= exclude_below * median)
        # Adam's first update is about +-lr an element whatever the
        # gradient: the gradients are read from the moments.
        gaps = [_distance_gaps(got[f"{net}_{m}"], ref[f"{net}_{m}"], keep) for m in ("mu", "nu")]
        out[f"{net}_mu_worst_gap"] = gaps[0][0]
        out[f"{net}_moment_median_gap"] = max(g[1] for g in gaps)
        change_ref = common.norms({k: ref[f"{net}_params"][k] - start[k] for k in start})
        change_got = common.norms({k: got[f"{net}_params"][k] - start[k] for k in start})
        out[f"{net}_change_worst_gap"], out[f"{net}_change_median_gap"] = \
            common.worst_and_median_gap(change_got, change_ref, set(keep))
    # The D step's second update alone (the real batch's): free of the
    # generator's rounding, which the fakes' gradient carries.
    out["d_grad_real_median_gap"] = math.inf
    if len(got["d_grads"]) == len(ref["d_grads"]) == 2:
        out["d_grad_real_median_gap"] = _distance_gaps(got["d_grads"][1], ref["d_grads"][1],
                                                       sorted(ref["d_grads"][1]))[1]
    out.update(_stats_gaps(got["g_stats"], ref["g_stats"], g_stats))
    return out


def check(state: State, control: Optional[Precision] = None) -> Dict[str, float]:
    """The program's record (or, for a control, the reference's in that
    lower precision) against the float32 reference's."""
    cfg = state.cell.config
    with no_tf32():
        ref = voxel_gan.follow(state.g_init, state.d_init, state.feed, cfg, Precision.F32)
        got = (voxel_gan.follow(state.g_init, state.d_init, state.feed, cfg, control)
               if control is not None else state.record)
    return compare(got, ref, state.g_init, state.d_init,
                   state.cell.traffic["exclude_gradient_below"])


# Faults planted under the timed path; each must turn ``correct`` false.
def _fault_state_unchanged():
    from shapegan_tpu_torch import optim

    return common.patched(optim.Adam, "step", lambda self, grads: None)


def _patched_steps(change):
    """``train.gan.make_steps`` with ``change(steps, args)`` applied to the
    pair of steps it returns."""
    from shapegan_tpu_torch.train import gan as trainer

    make = trainer.make_steps

    def make_steps(g_net, d_net, g_opt, d_opt, mesh=None):
        return change(make, (g_net, d_net, g_opt, d_opt, mesh))

    return common.patched(trainer, "make_steps", make_steps)


def _fault_d_half_batch():
    """The D step takes the first half of its real rows and latents (its
    fakes from those latents alone); the G step is sound."""

    def change(make, args):
        g_step, d_step = make(*args)
        return g_step, lambda batch, z: d_step(batch[: z.shape[0] // 2], z[: z.shape[0] // 2])

    return _patched_steps(change)


def _fault_g_half_batch():
    """The G step's loss is the mean over the first half of its fakes; all
    the fakes are made, kept and returned."""

    def change(make, args):
        g_net, d_net, g_opt = args[:3]
        _, d_step = make(*args)
        params = dict(g_net.named_parameters())

        def g_half(z):
            fake = g_net(z, train=True)
            loss = -torch.log(d_net(fake[: z.shape[0] // 2]).clamp(1e-7, 1.0)).mean()
            g_opt.step(dict(zip(params, torch.autograd.grad(loss, list(params.values())))))
            return fake.detach()

        return g_half, d_step

    return _patched_steps(change)


def _fault_d_half_loss():
    """The D step scores every row of its fakes and of its real batch but
    takes each BCE over the first half of the scored rows alone."""
    from shapegan_tpu_torch.train import gan as trainer
    from shapegan_tpu_torch.train.hybrid_gan import bce_loss

    def half_loss(discriminator, volumes, target):
        params = dict(discriminator.named_parameters())
        out = discriminator(volumes)
        half = out[: out.shape[0] // 2]
        grads = torch.autograd.grad(bce_loss(half, torch.full_like(half, target)),
                                    list(params.values()))
        return dict(zip(params, grads)), out.detach()

    return common.patched(trainer, "bce_grads", half_loss)


class _FakesUpdateOnly:
    """The discriminator's optimizer passing on the first of each D step's
    two updates (the fakes') and dropping the second (the real batch's)."""

    def __init__(self, opt):
        self.opt, self.calls = opt, 0

    def step(self, grads) -> None:
        self.calls += 1
        if self.calls % 2:
            self.opt.step(grads)


def _fault_d_real_update_skipped():
    def change(make, args):
        g_net, d_net, g_opt, d_opt, mesh = args
        return make(g_net, d_net, g_opt, _FakesUpdateOnly(d_opt), mesh)

    return _patched_steps(change)


def _fault_bn_stats_frozen():
    """The generator's BatchNorm never keeps its update: the running
    statistics stay where they started."""
    from shapegan_tpu_torch.models.flax_layers import BatchNorm

    forward = BatchNorm.forward

    def frozen(self, x, train=True, update_stats=True):
        return forward(self, x, train, False)

    return common.patched(BatchNorm, "forward", frozen)


def _fault_bn_mean_frozen():
    """The generator's BatchNorm keeps its variance's update and drops its
    mean's: the running means stay where they started."""
    from shapegan_tpu_torch.models.flax_layers import BatchNorm

    forward = BatchNorm.forward

    def mean_frozen(self, x, train=True, update_stats=True):
        mean = self.mean.clone()
        out = forward(self, x, train, update_stats)
        self.mean.copy_(mean)
        return out

    return common.patched(BatchNorm, "forward", mean_frozen)


FAULTS = {"state_unchanged": _fault_state_unchanged, "d_half_batch": _fault_d_half_batch,
          "g_half_batch": _fault_g_half_batch,
          "d_half_loss": _fault_d_half_loss,
          "d_real_update_skipped": _fault_d_real_update_skipped,
          "bn_stats_frozen": _fault_bn_stats_frozen, "bn_mean_frozen": _fault_bn_mean_frozen}
# The control: the reference in the program's place with both networks'
# convolutions in bfloat16, below the TF32 that the configuration states.
CONTROLS = {"control": Precision.LOW}
